"""Plain float32 reference of BaF split inference, in PyTorch alone.

The YOLO-v3 Darknet-53 stem through layer 12 (the edge), eq. 4 quantization
with fp16 side info, eq. 5 dequantization, the BaF backward net (inverse BN,
a x2 transposed conv, three 3x3 convs, PReLU), the frozen split conv as
the forward predictor, eq. 6 consolidation and the cloud tail (residual
pairs, global average pooling, a dense head); arXiv:1804.02767 and
arXiv:2002.07036, Fig. 1-2.

Tensors are NHWC at the interface and NCHW (contiguous) inside. The layer
table comes from the configuration file; the weights are a flat dict of
float32 tensors keyed ``cnn.<...>`` and ``baf.<...>``. Convolutions pad as
XLA's ``"SAME"``; the transposed conv correlates its (not flipped) kernel
with the input dilated by the stride and padded (2, 1), as
``lax.conv_transpose(..., "SAME")`` does.

``tf32=True`` is the control: every product's operands are rounded to
TF32 (10 mantissa bits, to nearest even) and summed in float32, which is
what the card does with TF32 on. Call with TF32 off in PyTorch
(``torch.backends.cudnn.allow_tf32 = False``, the same for matmul).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LEAKY = 0.1
BN_EPS = 1e-5
F16_MAX = 65504.0


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties to even."""
    bits = t.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _ops(tf32: bool, *ts):
    return [to_tf32(t) if tf32 and t is not None else t for t in ts]


def _same(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, b, stride: int,
         tf32: bool = False) -> torch.Tensor:
    """SAME conv on NCHW; w (Cout, Cin, k, k)."""
    k = w.shape[-1]
    top, bottom = _same(x.shape[2], k, stride)
    left, right = _same(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    x, w = _ops(tf32, x, w)
    return F.conv2d(x, w, b, stride=stride)


def conv_transpose_x2(x: torch.Tensor, w: torch.Tensor, b,
                      tf32: bool = False) -> torch.Tensor:
    """Stride-2 SAME transposed conv of a 3x3 kernel on NCHW.

    w (Cout, Cin, 3, 3): the input is zero-dilated by 2, padded 2 before
    and 1 after, and correlated with w unflipped -> (B, Cout, 2H, 2W).
    """
    bsz, c, h, wd = x.shape
    xd = x.new_zeros((bsz, c, 2 * h - 1, 2 * wd - 1))
    xd[:, :, ::2, ::2] = x
    xd = F.pad(xd, (2, 1, 2, 1))
    xd, w = _ops(tf32, xd, w)
    return F.conv2d(xd, w, b)


def bn(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Inference BN over dim 1 of NCHW."""
    def v(key):
        return w[f"{name}.{key}"].view(1, -1, 1, 1)
    return (x - v("mean")) / torch.sqrt(v("var") + BN_EPS) * v("scale") \
        + v("bias")


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, LEAKY * x)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha.view(1, -1, 1, 1) * x)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def edge(w: dict, cfg: dict, img: torch.Tensor, *,
         tf32: bool = False) -> torch.Tensor:
    """img (B, S, S, 3) -> z (B, S/8, S/8, P): the stem with its leaky
    ReLUs and residual adds, then the split conv + BN (no activation)."""
    x = _nchw(img.float())
    starts = {a: e for a, e in cfg["residual"]}
    shortcut, end = None, None
    for i, (_, _, _, s) in enumerate(cfg["stem"]):
        if i in starts:
            shortcut, end = x, starts[i]
        x = leaky(bn(w, f"cnn.stem.{i}.bn",
                     conv(x, w[f"cnn.stem.{i}.conv.weight"], None, s, tf32)))
        if i == end:
            x = x + shortcut
    s = cfg["split"][3]
    z = bn(w, "cnn.split.bn", conv(x, w["cnn.split.conv.weight"], None, s,
                                   tf32))
    return _nhwc(z)


def side_info(z_sel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(example, channel) fp16 min and max of z_sel (B, H, W, C): the
    min rounded to nearest and saturated, the max rounded to nearest,
    widened one fp16 step towards +inf and saturated (paper §3.2)."""
    mn = torch.amin(z_sel, dim=(1, 2)).cpu().numpy()
    mx = torch.amax(z_sel, dim=(1, 2)).cpu().numpy()
    mins = np.maximum(mn.astype(np.float16), np.float16(-F16_MAX))
    maxs = mx.astype(np.float16)
    maxs = np.minimum(np.nextafter(maxs, np.float16(np.inf)),
                      np.float16(F16_MAX))
    return mins, maxs


def quantize(z_sel: torch.Tensor, mins: np.ndarray, maxs: np.ndarray,
             bits: int) -> torch.Tensor:
    """Eq. 4: round((z - m) / max(M - m, 1e-12) * (2^n - 1)), clipped to
    [0, 2^n - 1], with (B, C) fp16 side info -> int64 codes."""
    levels = float((1 << bits) - 1)
    dev = z_sel.device
    m = torch.from_numpy(mins.astype(np.float32)).to(dev)[:, None, None, :]
    mx = torch.from_numpy(maxs.astype(np.float32)).to(dev)[:, None, None, :]
    rng = torch.clamp(mx - m, min=1e-12)
    scaled = (z_sel.float() - m) / rng * levels
    return torch.clamp(torch.round(scaled), 0, levels).to(torch.int64)


def dequantize(codes: torch.Tensor, mins: np.ndarray, maxs: np.ndarray,
               bits: int) -> torch.Tensor:
    """Eq. 5: m + code * (M - m) / (2^n - 1) on (B, H, W, C) codes."""
    levels = float((1 << bits) - 1)
    dev = codes.device
    m = torch.from_numpy(mins.astype(np.float32)).to(dev)[:, None, None, :]
    mx = torch.from_numpy(maxs.astype(np.float32)).to(dev)[:, None, None, :]
    return m + codes.float() * ((mx - m) / levels)


@torch.no_grad()
def restore(w: dict, cfg: dict, sel: torch.Tensor, codes: torch.Tensor,
            mins: np.ndarray, maxs: np.ndarray, *,
            tf32: bool = False) -> torch.Tensor:
    """Codes (B, H, W, C) of the channels ``sel`` with their side info ->
    z~ (B, H, W, P): eq. 5, the BaF backward net from the inverse of the
    split BN, the split conv + BN as the forward predictor, eq. 6."""
    bits = cfg["bits"]
    z_hat = _nchw(dequantize(codes, mins, maxs, bits))
    idx = sel.long()

    def bn_sel(key):
        return w[f"cnn.split.bn.{key}"][idx].view(1, -1, 1, 1)
    scale = bn_sel("scale")
    scale = torch.where(scale.abs() < 1e-6, torch.full_like(scale, 1e-6),
                        scale)
    x = (z_hat - bn_sel("bias")) / scale * torch.sqrt(bn_sel("var") + BN_EPS) \
        + bn_sel("mean")
    x = prelu(conv_transpose_x2(x, w["baf.up.weight"], w["baf.up.bias"],
                                tf32), w["baf.up_act.alpha"])
    x = prelu(conv(x, w["baf.c2.weight"], w["baf.c2.bias"], 1, tf32),
              w["baf.c2_act.alpha"])
    x = prelu(conv(x, w["baf.c3.weight"], w["baf.c3.bias"], 1, tf32),
              w["baf.c3_act.alpha"])
    x = conv(x, w["baf.c4.weight"], w["baf.c4.bias"], 1, tf32)
    z = bn(w, "cnn.split.bn", conv(x, w["cnn.split.conv.weight"], None,
                                   cfg["split"][3], tf32))
    z = _nhwc(z)
    # eq. 6: clip the transmitted channels to the bins of their codes
    levels = float((1 << bits) - 1)
    dev = z.device
    m = torch.from_numpy(mins.astype(np.float32)).to(dev)[:, None, None, :]
    mx = torch.from_numpy(maxs.astype(np.float32)).to(dev)[:, None, None, :]
    step = (mx - m) / levels
    c = codes.float()
    lo, hi = m + (c - 0.5) * step, m + (c + 0.5) * step
    z[..., idx] = torch.minimum(torch.maximum(z[..., idx], lo), hi)
    return z


@torch.no_grad()
def cloud(w: dict, cfg: dict, z: torch.Tensor, *,
          tf32: bool = False) -> torch.Tensor:
    """z (B, H, W, P) -> logits (B, classes): leaky ReLU, residual pairs
    (1x1 then 3x3, each conv + BN + leaky ReLU), mean over H and W, the
    dense head."""
    x = leaky(_nchw(z.float()))
    for j in range(0, 2 * cfg["tail_res_blocks"], 2):
        sc = x
        for i in (j, j + 1):
            x = leaky(bn(w, f"cnn.tail.{i}.bn",
                         conv(x, w[f"cnn.tail.{i}.conv.weight"], None, 1,
                              tf32)))
        x = x + sc
    feat = x.mean(dim=(2, 3))
    feat, hw = _ops(tf32, feat, w["cnn.head.weight"])
    return feat @ hw + w["cnn.head.bias"]
