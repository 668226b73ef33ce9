"""Fused tail of a deformable-encoder layer (inference), token-major:

    h1  = LN1(src + attn_out)
    out = LN2(h1 + linear2(relu(linear1(h1))))

Counterpart of ``vnext_tpu.ops.encoder_epilogue.encoder_epilogue_cm`` (which runs
channel-major on the TPU). LayerNorm statistics are f32 with eps 1e-6 and the
fast variance E[x^2] - E[x]^2, as flax computes them; h1 stays f32 for the
residual; the two products take operands in the input dtype. The weights come
in torch layout: ``w1`` [F, C] (linear1.weight), ``w2`` [C, F] (linear2.weight).

Without autograd the call is the operator ``torch.ops.vnext.encoder_epilogue``
(so that ``torch.export`` keeps it in a graph): on a CPU tensor it runs
:func:`encoder_epilogue_plain`; on a CUDA tensor the hand-written kernel
``csrc/encoder_epilogue.cu``, which packs the weights itself, or it raises.
The kernel is inference-only, as the TPU one is (the JAX encoder layer fuses
only when not training): on the card it raises when autograd would need a
backward, and an encoder layer in train mode runs the unfused tail instead.
On the CPU, under autograd, the plain version runs with its autograd.

The kernel reads the weights as :func:`pack_epilogue_weights` lays them out:
F/64 chunks, each two pieces (W1's 64 rows of the chunk, W2's 64 columns) in
the K-major, 128-byte-swizzled image that ``wgmma`` reads from shared memory,
so that each piece is one bulk copy. :func:`encoder_epilogue_chunked` reads that
layout back and computes chunk by chunk in the kernel's order of roundings.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from torch.utils.flop_counter import register_flop_formula

from .._build import Kernel, check, load_library, refuse_grad, stream_handle

KERNEL = Kernel(
    name="encoder_epilogue",
    source="vnext_tpu_torch/csrc/encoder_epilogue.cu",
    replaces="vnext_tpu/ops/encoder_epilogue.py:42",
)

EPS = 1e-6
CHUNK = 64        # FFN columns per packed chunk: one wgmma K-atom of 128 bytes in bf16


def layer_norm_f32(x: torch.Tensor, weight, bias, eps: float = EPS) -> torch.Tensor:
    """flax LayerNorm over the last axis: f32 statistics, fast variance; f32 out."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()


def encoder_epilogue(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b):
    """attn_out, src [B, S, C]; returns [B, S, C] in src.dtype."""
    args = (attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b)
    if attn_out.shape != src.shape:
        raise ValueError(f"attn_out {tuple(attn_out.shape)} and src {tuple(src.shape)} differ")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"encoder_epilogue: no implementation for device {src.device}")
    if src.device.type == "cuda":
        refuse_grad("encoder_epilogue", *args)
    elif torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return encoder_epilogue_plain(*args)
    return encoder_epilogue_op(*args)


def _check_args(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b):
    """The fake function's shape checks (the kernel's launch checks its own)."""
    if attn_out.shape != src.shape:
        raise ValueError(f"attn_out {tuple(attn_out.shape)} and src {tuple(src.shape)} differ")
    c, f = src.shape[-1], w1.shape[0]
    if w1.shape != (f, c) or w2.shape != (c, f):
        raise ValueError(f"w1 must be [F, C] and w2 [C, F] for C = {c}, got {tuple(w1.shape)}, {tuple(w2.shape)}")


@torch.library.custom_op("vnext::encoder_epilogue", mutates_args=(), device_types="cpu")
def encoder_epilogue_op(attn_out: torch.Tensor, src: torch.Tensor, ln1_w: torch.Tensor, ln1_b: torch.Tensor,
                        w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        ln2_w: torch.Tensor, ln2_b: torch.Tensor) -> torch.Tensor:
    """The epilogue as an operator: the plain version on the CPU, K3 on the
    card (registered below); [B, S, C] in src.dtype."""
    return encoder_epilogue_plain(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b)


@encoder_epilogue_op.register_kernel("cuda")
def _encoder_epilogue_cuda(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b):
    return _launch(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b)


@encoder_epilogue_op.register_fake
def _encoder_epilogue_fake(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b):
    _check_args(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b)
    return torch.empty_like(src)


@register_flop_formula(torch.ops.vnext.encoder_epilogue)
def encoder_epilogue_flops(attn_shape, src_shape, ln1_w_shape, ln1_b_shape, w1_shape, *args, **kwargs) -> int:
    """The two products, 2 operations per multiply-add: [N, C] x [C, F] and
    [N, F] x [F, C]; the LayerNorms, the bias adds and the ReLU are not counted."""
    f, c = w1_shape
    n = 1
    for d in src_shape[:-1]:
        n *= d
    return 2 * 2 * n * c * f


def encoder_epilogue_plain(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b):
    """Plain PyTorch version: LN1, two linears in the input dtype, LN2."""
    dt = src.dtype
    h1 = layer_norm_f32(src.float() + attn_out.float(), ln1_w, ln1_b)
    ff = torch.relu(F.linear(h1.to(dt), w1.to(dt), b1.to(dt)))
    y = F.linear(ff, w2.to(dt), b2.to(dt))
    return layer_norm_f32(h1 + y.float(), ln2_w, ln2_b).to(dt)


def _swizzle_groups(x: torch.Tensor) -> torch.Tensor:
    """x [..., R, 8, 8]: rows of 64 values in 8 groups of 8. Returns group g of
    row r at position g ^ (r % 8), the 128-byte swizzle (an involution, so it
    also undoes itself)."""
    r = x.shape[-3]
    rows = torch.arange(r, device=x.device)
    groups = torch.arange(8, device=x.device)[None, :] ^ (rows % 8)[:, None]       # [R, 8]
    return x[..., rows[:, None], groups, :]


def _pack_views(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    f, c = w1.shape
    nc = f // CHUNK
    # W1 chunk j: rows 64j.., all C columns, as C/64 atoms [64 rows, 64 columns]
    p1 = w1.reshape(nc, CHUNK, c // 64, 8, 8).permute(0, 2, 1, 3, 4)              # [nc, C/64, 64, 8, 8]
    # W2 chunk j: all C rows, columns 64j.., one atom [C rows, 64 columns]
    p2 = w2.reshape(c, nc, 8, 8).permute(1, 0, 2, 3)                                 # [nc, C, 8, 8]
    return torch.stack([_swizzle_groups(p1).reshape(nc, -1), _swizzle_groups(p2).reshape(nc, -1)], 1)


@functools.lru_cache(maxsize=16)
def _pack_index(f: int, c: int, device: torch.device) -> torch.Tensor:
    """Where each element of the packed layout comes from in cat(w1.ravel(), w2.ravel())."""
    n = f * c
    ar = torch.arange(2 * n, device=device)
    return _pack_views(ar[:n].view(f, c), ar[n:].view(c, f)).reshape(-1)


def pack_epilogue_weights(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """w1 [F, C] (linear1.weight), w2 [C, F] (linear2.weight), F % 64 == 0 and
    C % 64 == 0 -> [F/64, 2, 64 * C] in their dtype (the kernel takes bf16).

    Chunk j holds W1's rows 64j..64j+63 (piece 0) and W2's columns 64j..64j+63
    (piece 1), each K-major in atoms of 64 values a row, the K axis being C for
    W1 and the chunk's 64 columns for W2: element (row, k) of an atom of R rows
    sits at row * 64 + 8 * ((k // 8) ^ (row % 8)) + k % 8, and W1's C/64 atoms
    follow each other. This is the shared-memory image that ``wgmma`` reads
    with the 128-byte swizzle, so each piece is one 1-D bulk copy."""
    f, c = w1.shape
    if w2.shape != (c, f) or f % CHUNK or c % 64:
        raise ValueError(f"w1 must be [F, C] and w2 [C, F] with F % 64 == 0 and C % 64 == 0, "
                         f"got {tuple(w1.shape)}, {tuple(w2.shape)}")
    flat = torch.cat([w1.reshape(-1), w2.reshape(-1)])
    return flat[_pack_index(f, c, w1.device)].view(f // CHUNK, 2, CHUNK * c)


def encoder_epilogue_chunked(attn_out, src, ln1_w, ln1_b, packed, b1, b2, ln2_w, ln2_b):
    """The kernel's arithmetic on :func:`pack_epilogue_weights`' layout, read
    back chunk by chunk: h1 = LN1 in f32; the sum starts at h1 + b2; per chunk,
    relu(h1 W1c^T + b1c) from operands rounded to the packed dtype, summed in
    f32 and rounded once to that dtype, times W2c^T added in f32; then LN2, in
    src.dtype."""
    dt = packed.dtype
    nc, _, n = packed.shape
    c = n // CHUNK
    h1 = layer_norm_f32(src.float() + attn_out.float(), ln1_w, ln1_b)
    h1r = h1.to(dt).float()
    acc = h1 + b2.float()
    for j in range(nc):
        w1c = _swizzle_groups(packed[j, 0].view(c // 64, CHUNK, 8, 8)).permute(1, 0, 2, 3).reshape(CHUNK, c)
        w2c = _swizzle_groups(packed[j, 1].view(c, 8, 8)).reshape(c, CHUNK)
        z = h1r @ w1c.float().T + b1[j * CHUNK:(j + 1) * CHUNK].float()
        acc = acc + torch.relu(z).to(dt).float() @ w2c.float().T
    return layer_norm_f32(acc, ln2_w, ln2_b).to(src.dtype)


def _launch(attn_out, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b):
    c = src.shape[-1]
    f = w1.shape[0]
    if c != 256:
        raise ValueError(f"the epilogue kernel is built for d_model 256, got {c}")
    if w1.shape != (f, c) or w2.shape != (c, f) or f % CHUNK or f == 0:
        raise ValueError(f"w1 must be [F, 256] and w2 [256, F] with F % 64 == 0, "
                         f"got {tuple(w1.shape)}, {tuple(w2.shape)}")
    for name, t in (("attn_out", attn_out), ("src", src)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise TypeError(f"the epilogue kernel takes {name} as contiguous bfloat16")
        if t.data_ptr() % 16:
            raise ValueError(f"the epilogue kernel needs {name} 16-byte aligned, got a view at "
                             f"offset {t.data_ptr() % 16}")
    vecs = [t.float().contiguous() for t in (ln1_w, ln1_b, b1, b2, ln2_w, ln2_b)]
    if any(v.shape != (n,) for v, n in zip(vecs, (c, c, f, c, c, c))):
        raise ValueError("LayerNorm and bias vectors have the wrong length")
    for t in (w1, w2, *vecs):
        if t.device != src.device:
            raise ValueError(f"a parameter is on {t.device}, src on {src.device}")
    # gather first, then one cast (no op when the weights are bf16 already)
    packed = pack_epilogue_weights(w1, w2).to(torch.bfloat16)
    g1, be1, b1f, b2f, g2, be2 = vecs
    n = src.numel() // c
    out = torch.empty_like(src)
    lib = load_library().lib
    with torch.cuda.device(src.device):
        code = lib.vnext_encoder_epilogue(
            attn_out.data_ptr(), src.data_ptr(), g1.data_ptr(), be1.data_ptr(), packed.data_ptr(),
            b1f.data_ptr(), b2f.data_ptr(), g2.data_ptr(), be2.data_ptr(), out.data_ptr(), n, f,
            stream_handle(src.device),
        )
    check(code, "encoder_epilogue")
    KERNEL.launches += 1
    return out
