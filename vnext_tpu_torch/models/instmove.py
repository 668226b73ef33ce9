"""InstMove: instance-motion prediction (ConvLSTM + learned motion memory).

Counterpart of ``vnext_tpu.models.instmove``: a convolutional mask encoder, a
stack of ConvLSTM cells over the past masks, a learned motion memory addressed
by the cosine similarity of a 3-D-convolutional motion code, an attention gate,
and a decoder conditioned on the current frame through a ResNet-50's res2 and
res3. Public layouts are the JAX package's (NHWC): past masks [B, T, H, W, 1]
and the current frame [B, H', W', 3] in, mask logits [B, out_len, H, W, 1] out.
Inside, tensors are NCHW (NCDHW for the 3-D convolutions). Module and parameter
names follow the flax tree; the kernels keep the weight bridge's layouts
(``checkpoint/from_jax.py``) and are arranged at use.

In bf16 the image ResNet's stem runs the hand-written stem kernel (K2). Nothing
else here was a Pallas kernel in the JAX package: the 3-D and transposed
convolutions, the ConvLSTM and the memory are library calls.

The memory feature halves the mask sides four times with floor (the 3-D
encoder's VALID max-pools) and doubles them twice; the ConvLSTM state halves
them twice with ceil (SAME stride-2 convolutions). The two meet only when both
mask sides are multiples of 16. Elsewhere the JAX package fails at their concat
with a ``TypeError``; the port raises a ``ValueError`` naming both shapes, and
neither pads nor resizes. Only the inference path (phase 2, the matching
encoder) is ported: training (``instmove_loss``, ``tools/train_instmove.py``)
waits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interpolate import resize_bilinear
from .backbones.resnet import ResNet
from .layers import Conv, Dense, _empty, _kernel_init, init_weights


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax / XLA "SAME" padding of one axis: (before, after), output ceil(size / s)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class ConvSame(Conv):
    """``Conv`` with flax's "SAME" padding, which is asymmetric for an even
    size at stride 2 (0 before, 1 after for a 3-tap kernel)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride, 0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.weight.shape[-1], self.stride
        (t, b), (l, r) = same_pads(x.shape[-2], k, s), same_pads(x.shape[-1], k, s)
        return super().forward(F.pad(x, (l, r, t, b)))


class ConvTranspose(Conv):
    """flax ``nn.ConvTranspose(padding="SAME")`` with its default
    ``transpose_kernel=False``: the input dilated by the stride and padded as
    ``lax.conv_transpose`` pads "SAME" (k - 1 before for stride 2, k // 2 for
    stride 1), then correlated with the kernel as it is, with no spatial flip
    and no in/out swap. The output side is input * stride. ``weight`` is the
    bridge's layout of the flax kernel (kh, kw, in, out): [out, in, kh, kw].

    It runs as ``conv_transpose2d`` with padding 0, which pads k - 1 on both
    sides, on the kernel flipped and swapped to torch's convention, and keeps
    the window that ``lax.conv_transpose``'s own padding selects."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride, 0, dtype=dtype)

    @staticmethod
    def lax_pads(k: int, s: int) -> Tuple[int, int]:
        """``lax.conv_transpose``'s "SAME" padding of the dilated input."""
        pad_len = k + s - 2
        before = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
        return before, pad_len - before

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, k, s = self.dtype, self.weight.shape[-1], self.stride
        before, after = self.lax_pads(k, s)
        if before > k - 1 or after > k - 1:
            raise ValueError(f"ConvTranspose: kernel {k} at stride {s} pads beyond k - 1")
        w = self.weight.to(dt).flip(-2, -1).transpose(0, 1)           # [in, out, kh, kw]
        y = F.conv_transpose2d(x.to(dt), w, None if self.bias is None else self.bias.to(dt), s)
        lo = k - 1 - before                       # conv_transpose2d pads k - 1 before
        h, wd = ((n - 1) * s + before + after - k + 2 for n in x.shape[-2:])
        return y[..., lo:lo + h, lo:lo + wd]


class Conv3d(nn.Module):
    """3-D convolution on NCDHW with "SAME" padding at stride 1 (flax ``nn.Conv``
    with a 3-tap cube kernel): ``weight`` [out, in, kd, kh, kw], the bridge's
    layout of the flax kernel (kd, kh, kw, in, out)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = _empty(out_ch, in_ch, kernel_size, kernel_size, kernel_size)
        self.bias = _empty(out_ch)

    def reset_parameters(self, gen: torch.Generator) -> None:
        o, i, kd, kh, kw = self.weight.shape
        _kernel_init(self.weight, "lecun", i * kd * kh * kw, o * kd * kh * kw, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv3d(x.to(dt), self.weight.to(dt), self.bias.to(dt), 1, self.weight.shape[-1] // 2)


class ConvLSTMCell(nn.Module):
    """Gates from two 3x3 convolutions, over the input and the hidden state."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.conv_x = Conv(in_ch, 4 * out_ch, 3, padding=1, dtype=dtype)
        self.conv_h = Conv(out_ch, 4 * out_ch, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        xi, xc, xf, xo = self.conv_x(x).chunk(4, dim=1)
        hi, hc, hf, ho = self.conv_h(h).chunk(4, dim=1)
        it = torch.sigmoid(xi + hi)
        ft = torch.sigmoid(xf + hf)
        new_c = ft * c + it * torch.tanh(xc + hc)
        ot = torch.sigmoid(xo + ho)
        return ot * torch.tanh(new_c), new_c


class ResBlock(nn.Module):
    """Two pre-activated 3x3 convolutions and the identity (every InstMove
    block keeps its width, so the JAX module's projection branch never exists)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, padding=1, dtype=dtype)
        self.conv2 = Conv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(torch.relu(self.conv1(torch.relu(x))))


class MotionEncoder3D(nn.Module):
    """3-D convolutions over the difference frames -> [B, 512, H/16, W/16] (each
    halving floors), averaged over time."""

    CHANNELS = (64, 128, 256, 256, 512, 512)
    POOL_AFTER = (1, 2, 4, 6)                       # conv1, conv2, conv4, conv6

    def __init__(self, dtype=torch.float32):
        super().__init__()
        in_ch = 1
        for i, ch in enumerate(self.CHANNELS):
            self.add_module(f"conv{i + 1}", Conv3d(in_ch, ch, 3, dtype))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 1, T, H, W] difference frames."""
        for i in range(len(self.CHANNELS)):
            x = torch.relu(getattr(self, f"conv{i + 1}")(x))
            if i + 1 in self.POOL_AFTER:
                x = F.max_pool3d(x, (1, 2, 2), (1, 2, 2))    # VALID: floors an odd side
        return x.mean(2)


class MotionMemory(nn.Module):
    """Learned motion memory with cosine addressing; two stride-2 transposed
    convolutions bring the read-out to a quarter of the mask sides."""

    def __init__(self, memory_size: int = 100, embed_channels: int = 128, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.motion_matching_encoder = MotionEncoder3D(dtype)
        self.memory_w = _empty(memory_size, 512)
        self.embed1 = ConvTranspose(512, embed_channels * 2, 3, 2, dtype)
        self.embed2 = ConvTranspose(embed_channels * 2, embed_channels, 3, 2, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.memory_w, 0.0, 1.0, generator=gen)

    def forward(self, masks: torch.Tensor) -> torch.Tensor:
        """masks [B, T, H, W] -> [B, embed_channels, 4 * (H // 16), 4 * (W // 16)]."""
        diff = (masks[:, 1:] - masks[:, :-1])[:, None]
        query = self.motion_matching_encoder(diff)                           # [B, 512, h, w]
        b, c, h, w = query.shape
        q = query.permute(0, 2, 3, 1).reshape(-1, c)
        qn = q / q.float().norm(dim=1, keepdim=True).clamp_min(1e-12).to(q.dtype)
        mem = self.memory_w
        mn = mem / mem.norm(dim=1, keepdim=True).clamp_min(1e-12)
        # the product of a compute-dtype query and the f32 memory is f32, as JAX promotes it
        addressing = torch.softmax(qn.float() @ mn.T, dim=1).to(self.dtype)
        feature = (addressing @ mem.to(self.dtype)).reshape(b, h, w, c).permute(0, 3, 1, 2)
        feature = torch.relu(self.embed1(feature))
        return torch.relu(self.embed2(feature))


class Decoder(nn.Module):
    """Mask decoder conditioned on the image's res3 (stride 8) and res2 (stride
    4). Its input has ``channels`` channels (the LSTM state and the gated memory,
    each half), so the JAX module's input projection never exists."""

    def __init__(self, channels: int = 256, dtype=torch.float32):
        super().__init__()
        ch = channels
        self.skip1 = Conv(512, ch, 3, padding=1, dtype=dtype)
        self.res1 = ResBlock(ch, dtype)
        self.up_m = ConvTranspose(ch, ch // 2, 3, 2, dtype)
        self.skip2 = Conv(256, ch // 2, 3, padding=1, dtype=dtype)
        self.res2 = ResBlock(ch // 2, dtype)
        self.up_f1 = ConvTranspose(ch // 2, ch // 4, 3, 1, dtype)
        self.up_f2 = ConvTranspose(ch // 4, ch // 4, 3, 2, dtype)
        self.out = ConvTranspose(ch // 4, 1, 3, 1, dtype)

    def forward(self, x: torch.Tensor, img_feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """x [B, C, H/4, W/4] -> mask logits [B, 1, H, W]."""
        skip = resize_bilinear(self.skip1(img_feats["res3"]), x.shape[2], x.shape[3])
        x = F.elu(self.up_m(self.res1(x + skip)))
        skip2 = resize_bilinear(self.skip2(img_feats["res2"]), x.shape[2], x.shape[3])
        x = self.res2(x + skip2)
        x = F.elu(self.up_f1(x))
        x = F.elu(self.up_f2(x))
        return self.out(x)


def motion_memory_hw(h: int, w: int) -> Tuple[int, int]:
    """The memory feature's sides for h x w masks: four floor halvings, two doublings."""
    return 4 * (h // 16), 4 * (w // 16)


def lstm_state_hw(h: int, w: int) -> Tuple[int, int]:
    """The ConvLSTM state's sides for h x w masks: two ceil halvings."""
    return math.ceil(math.ceil(h / 2) / 2), math.ceil(math.ceil(w / 2) / 2)


def check_mask_size(h: int, w: int) -> Tuple[int, int]:
    """The ConvLSTM state's sides for h x w masks; a ``ValueError`` unless they
    are the memory feature's too, which holds only when both sides are
    multiples of 16 (the JAX package fails at their concat)."""
    mem_hw, lstm_hw = motion_memory_hw(h, w), lstm_state_hw(h, w)
    if mem_hw != lstm_hw:
        raise ValueError(
            f"InstMove at {h}x{w} masks: the motion memory feature is {mem_hw[0]}x{mem_hw[1]} "
            f"(4 * floor(side / 16)) and the ConvLSTM state {lstm_hw[0]}x{lstm_hw[1]} (ceil(side / 4)); "
            "they meet only when both mask sides are multiples of 16 (the JAX package fails at "
            "their concat too)")
    return lstm_hw


class InstMovePredictor(nn.Module):
    """Predict the next instance masks from past masks and the current image.
    The defaults are ``MODEL.INSTMOVE.*``'s."""

    def __init__(self, memory_size: int = 100, num_lstm_layers: int = 4, lstm_channels: int = 128,
                 dtype=torch.float32):
        super().__init__()
        ch = lstm_channels
        self.dtype = dtype
        self.num_lstm_layers = num_lstm_layers
        self.enc1 = ConvSame(1, ch // 2, 3, 2, dtype)
        self.enc2 = ConvSame(ch // 2, ch // 2, 3, 1, dtype)
        self.enc3 = ConvSame(ch // 2, ch, 3, 2, dtype)
        self.enc4 = ConvSame(ch, ch, 3, 1, dtype)
        for i in range(num_lstm_layers):
            self.add_module(f"convlstm_{i}", ConvLSTMCell(ch, ch, dtype))
        self.memory = MotionMemory(memory_size, ch, dtype)
        self.encoder_img = ResNet(50, dtype, out_features=("res2", "res3"))
        self.attn_fc1 = Dense(2 * ch, 16, dtype)
        self.attn_fc2 = Dense(16, ch, dtype)
        self.decoder = Decoder(2 * ch, dtype)

    def _encode_mask(self, m: torch.Tensor) -> torch.Tensor:
        """[B, 1, H, W] -> [B, C, ceil(H / 4), ceil(W / 4)]."""
        for conv in (self.enc1, self.enc2, self.enc3, self.enc4):
            m = F.elu(conv(m))
        return m

    def forward(self, short_x: torch.Tensor, image: torch.Tensor, out_len: int = 1) -> torch.Tensor:
        """short_x [B, T, H, W, 1] past masks (probabilities); image [B, H', W', 3]
        normalized. Returns mask logits [B, out_len, H, W, 1]."""
        b, t, h, w, _ = short_x.shape
        lstm_hw = check_mask_size(h, w)
        masks = short_x[..., 0]
        memory_feature = self.memory(masks)
        img_feats = self.encoder_img(image)

        state = torch.zeros(b, self.enc4.weight.shape[0], *lstm_hw, dtype=self.dtype, device=short_x.device)
        hs: List[torch.Tensor] = [state] * self.num_lstm_layers
        cs: List[torch.Tensor] = [state] * self.num_lstm_layers
        preds: List[torch.Tensor] = []
        for step in range(t + out_len - 1):
            m = masks[:, step, None] if step < t else torch.sigmoid(preds[-1])
            x = self._encode_mask(m)
            for i in range(self.num_lstm_layers):
                hs[i], cs[i] = getattr(self, f"convlstm_{i}")(x if i == 0 else hs[i - 1], hs[i], cs[i])
            if step >= t - 1:
                pooled = torch.cat([cs[-1], memory_feature], 1).mean((2, 3))
                attn = torch.sigmoid(self.attn_fc2(torch.relu(self.attn_fc1(pooled))))
                gated = memory_feature * attn[:, :, None, None]
                preds.append(self.decoder(torch.cat([hs[-1], gated], 1), img_feats))
        return torch.stack(preds[-out_len:], 1).permute(0, 1, 3, 4, 2)


def motion_match_cost(pred_masks: torch.Tensor, cand_masks: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """[N, M] IoU distance between motion-predicted and candidate mask logits
    (the motion term that MinVIS + InstMove adds to its matching cost)."""
    p = (torch.sigmoid(pred_masks) > 0.5).reshape(pred_masks.shape[0], -1).float()
    c = (torch.sigmoid(cand_masks) > 0.5).reshape(cand_masks.shape[0], -1).float()
    inter = p @ c.T
    union = p.sum(1)[:, None] + c.sum(1)[None] - inter
    return 1.0 - (inter + eps) / (union + eps)


def instmove_kwargs_from_cfg(cfg) -> dict:
    """InstMovePredictor constructor arguments from ``MODEL.INSTMOVE.*``, read by
    attribute. The predictor computes in f32, as the JAX package builds it."""
    c = cfg.MODEL.INSTMOVE
    return dict(memory_size=c.MEMORY_SIZE, num_lstm_layers=c.LSTM_LAYERS, lstm_channels=c.LSTM_CHANNELS)


def build_instmove_model(cfg=None, device="cuda", dtype=None, seed: int = 0) -> InstMovePredictor:
    """InstMovePredictor in eval mode on ``device`` with seeded random weights.

    The card is the default; with no CUDA device this raises rather than fall
    back to the CPU (``device="cpu"`` asks for it). Without ``cfg`` the
    constructor defaults apply, which are ``MODEL.INSTMOVE.*``'s; ``dtype``
    overrides the compute dtype (f32)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_instmove_model: no CUDA device is visible; pass device='cpu' "
                           "to run on the CPU")
    kwargs = instmove_kwargs_from_cfg(cfg) if cfg is not None else {}
    if dtype is not None:
        kwargs["dtype"] = dtype
    model = InstMovePredictor(**kwargs)
    init_weights(model, seed)
    return model.to(device).eval()
