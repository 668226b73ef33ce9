"""Fused tail of a deformable-encoder layer (inference), token-major:

    h1  = LN1(src + attn_out)
    out = LN2(h1 + linear2(relu(linear1(h1))))

Counterpart of ``vnext_tpu.ops.encoder_epilogue.encoder_epilogue_cm`` (which runs
channel-major on the TPU). LayerNorm statistics are f32 with eps 1e-6 and the
fast variance E[x^2] - E[x]^2, as flax computes them; h1 stays f32 for the
residual; the two products take operands in the input dtype. The weights come
in torch layout: ``w1`` [F, C] (linear1.weight), ``w2`` [C, F] (linear2.weight).

A CPU tensor runs :func:`encoder_epilogue_plain`; a CUDA tensor runs the
hand-written kernel ``csrc/encoder_epilogue.cu`` or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import Kernel, check, load_library, stream_handle

KERNEL = Kernel(
    name="encoder_epilogue",
    source="vnext_tpu_torch/csrc/encoder_epilogue.cu",
    replaces="vnext_tpu/ops/encoder_epilogue.py:42",
)

EPS = 1e-6


def layer_norm_f32(x: torch.Tensor, weight, bias, eps: float = EPS) -> torch.Tensor:
    """flax LayerNorm over the last axis: f32 statistics, fast variance; f32 out."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()


def encoder_epilogue(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b):
    """attn_out, src [B, S, C]; returns [B, S, C] in src.dtype."""
    if attn_out.shape != src.shape:
        raise ValueError(f"attn_out {tuple(attn_out.shape)} and src {tuple(src.shape)} differ")
    if src.device.type == "cpu":
        return encoder_epilogue_plain(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b)
    if src.device.type != "cuda":
        raise ValueError(f"encoder_epilogue: no implementation for device {src.device}")
    return _launch(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b)


def encoder_epilogue_plain(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b):
    """Plain PyTorch version: LN1, two linears in the input dtype, LN2."""
    dt = src.dtype
    h1 = layer_norm_f32(src.float() + attn_out.float(), ln1_w, ln1_b)
    ff = torch.relu(F.linear(h1.to(dt), w1.to(dt), b1.to(dt)))
    y = F.linear(ff, w2.to(dt), b2.to(dt))
    return layer_norm_f32(h1 + y.float(), ln2_w, ln2_b).to(dt)


def _launch(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b):
    c = src.shape[-1]
    f = w1.shape[0]
    if c != 256:
        raise ValueError(f"the epilogue kernel is built for d_model 256, got {c}")
    if w1.shape != (f, c) or w2.shape != (c, f) or f % 64:
        raise ValueError(f"w1 must be [F, 256] and w2 [256, F] with F % 64 == 0, "
                         f"got {tuple(w1.shape)}, {tuple(w2.shape)}")
    for name, t in (("attn_out", attn_out), ("src", src)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise TypeError(f"the epilogue kernel takes {name} as contiguous bfloat16")
    vecs = [t.float().contiguous() for t in (ln1_w, ln1_b, b1, b2, ln2_w, ln2_b)]
    if any(v.shape != (n,) for v, n in zip(vecs, (c, c, f, c, c, c))):
        raise ValueError("LayerNorm and bias vectors have the wrong length")
    for t in (w1, w2, *vecs):
        if t.device != src.device:
            raise ValueError(f"a parameter is on {t.device}, src on {src.device}")
    w1b = w1.to(torch.bfloat16).contiguous()
    w2b = w2.to(torch.bfloat16).contiguous()
    g1, be1, b1f, b2f, g2, be2 = vecs
    n = src.numel() // c
    out = torch.empty_like(src)
    lib = load_library().lib
    with torch.cuda.device(src.device):
        code = lib.vnext_encoder_epilogue(
            attn_out.data_ptr(), src.data_ptr(), g1.data_ptr(), be1.data_ptr(),
            w1b.data_ptr(), b1f.data_ptr(), w2b.data_ptr(), b2f.data_ptr(),
            g2.data_ptr(), be2.data_ptr(), out.data_ptr(), n, f, stream_handle(src.device),
        )
    check(code, "encoder_epilogue")
    KERNEL.launches += 1
    return out
