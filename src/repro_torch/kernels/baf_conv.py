"""The served BaF restore's convolutions: the wrapper and its plain version.

``baf_conv`` runs one 3x3 convolution of the restore's chain on NHWC
float32 tensors, with its epilogue: a bias, PReLU (``alpha``) or BN after
it (``bn``). A CUDA tensor goes through the implicit-GEMM kernel in
``csrc/baf_conv.cu`` (mma.sync in 3xTF32: float32's accuracy on the tensor
cores), or the call raises; a CPU tensor goes through ``baf_conv_plain``,
the ``nn.conv_apply`` / ``conv_transpose_apply`` chain the layers run. It
replaces no Pallas kernel (the JAX package's convolutions are XLA's): it
stands in for cuDNN on the served restore only, where cuDNN with TF32 off
runs its float32 FFT and CUDA-core convolutions. The trainer, the unfused
restore and the CNN's halves keep ``nn.py``; the kernel has no backward,
so a call with grad mode on and an input that requires grad is refused.

The kernel reads the weights pre-split into TF32 high parts and remainders
in its fragment order (``prepare_weights``). They are prepared once per
weight tensor and kept while its storage and its version counter are the
same, so an in-place update (``copy_``, an optimizer step) is seen at the
next call.

Costs (``launch.hlo_cost.charged``): on the card and on ``meta`` tensors
the wrapper charges the products of the conv it ran (a transposed conv
over its input, as ``torch.utils.flop_counter`` counts it) and its bytes,
and a ``meta`` call returns an empty output. On the CPU the plain chain's
ATen ops are counted as they dispatch, as they always were.
"""
from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import nn as tnn
from repro_torch.kernels import _build
from repro_torch.launch.hlo_cost import charged

K = 3                 # the kernel's taps a side
BK = 32               # channels of a k-tile (csrc/baf_conv.cu)
BN = 64               # output channels of a block
BN_KEYS = ("mean", "var", "scale", "bias")

_PREPARED = WeakIdKeyDictionary()


def baf_conv_plain(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None = None, *, stride: int = 1,
                   transposed: bool = False, alpha: torch.Tensor | None = None,
                   bn: dict | None = None) -> torch.Tensor:
    """The layers' own ops: ``nn.conv_apply`` (SAME) or, ``transposed``,
    ``nn.conv_transpose_apply`` (XLA's SAME, stride 2), then ``prelu_apply``
    with ``alpha`` or ``batchnorm_apply`` with ``bn``."""
    if transposed:
        y = tnn.conv_transpose_apply(x, weight, bias, stride=stride)
    else:
        y = tnn.conv_apply(x, weight, bias, stride=stride)
    if alpha is not None:
        y = tnn.prelu_apply(alpha, y)
    if bn is not None:
        y = tnn.batchnorm_apply(bn, y)
    return y


def out_shape(x: torch.Tensor, weight: torch.Tensor, *, stride: int,
              transposed: bool) -> tuple[int, int, int, int]:
    b, h, w, _ = x.shape
    if transposed:
        return b, h * stride, w * stride, weight.shape[0]
    return b, -(-h // stride), -(-w // stride), weight.shape[0]


def baf_conv_cost(x, weight, bias=None, *, stride: int = 1,
                  transposed: bool = False, alpha=None, bn=None):
    """(flops, bytes) of a call: 2 Cin Cout k^2 products for each output
    pixel (each input pixel for the transposed conv); x, the weights and
    the epilogue's vectors read once, the output written once."""
    b, h, w, cin = x.shape
    ob, oh, ow, cout = out_shape(x, weight, stride=stride,
                                 transposed=transposed)
    rows = b * h * w if transposed else ob * oh * ow
    vectors = sum(t.numel() for t in (bias, alpha) if t is not None) \
        + (0 if bn is None else sum(bn[k].numel() for k in BN_KEYS))
    return (2.0 * rows * cin * cout * weight.shape[-1] * weight.shape[-2],
            4 * (x.numel() + weight.numel() + vectors + ob * oh * ow * cout))


def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``) for finite values."""
    i = t.view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


@torch.no_grad()
def prepare_weights(weight: torch.Tensor) -> torch.Tensor:
    """An OIHW (Cout, Cin, 3, 3) weight in the kernel's layout, split:
    [Cout / 64][tap ky 3 + kx][Cin / 32][k-step 4][column 64][t 4][4], the
    four values (hi, hi, lo, lo) of channels 32 chunk + 16 h + 4 t + 2 e and
    + 1 in k-step 2 h + e (the mma's k columns t and t + 4), each split as
    w = hi + lo with both parts rounded to TF32. Channels past Cin and
    columns past Cout are zeros."""
    cout, cin = weight.shape[:2]
    chunks, ntiles = -(-cin // BK), -(-cout // BN)
    g = torch.zeros((K * K, chunks * BK, ntiles * BN), dtype=torch.float32,
                    device=weight.device)
    g[:, :cin, :cout] = weight.float().permute(2, 3, 1, 0).reshape(
        K * K, cin, cout)
    # (tap, chunk, h, t, e, pair, ntile, column) -> (ntile, tap, chunk, h,
    # e, column, t, pair)
    g = g.reshape(K * K, chunks, 2, 4, 2, 2, ntiles, BN).permute(
        6, 0, 1, 2, 4, 7, 3, 5).contiguous()
    hi = _tf32_rna(g)
    lo = _tf32_rna(g - hi)
    return torch.stack([hi, lo], dim=-2).reshape(
        ntiles, K * K, chunks, 4, BN, 4, 4)


def prepared_weights(weight: torch.Tensor) -> torch.Tensor:
    """``prepare_weights(weight)``, kept for the tensor while its storage
    (``data_ptr``) and version counter (``_version``) are unchanged."""
    key = (weight.data_ptr(), weight._version)
    hit = _PREPARED.get(weight)
    if hit is None or hit[0] != key:
        hit = (key, prepare_weights(weight))
        _PREPARED[weight] = hit
    return hit[1]


def _check(x, weight, bias, alpha, bn, stride: int, transposed: bool) -> None:
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"baf_conv takes x (B, H, W, Cin) and an OIHW "
                         f"weight, got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    cout, cin, kh, kw = weight.shape
    if (kh, kw) != (K, K) or x.shape[-1] != cin:
        raise ValueError(f"baf_conv takes 3x3 weights (Cout, {x.shape[-1]}, "
                         f"3, 3), got {tuple(weight.shape)}")
    if stride < 1 or (transposed and stride != 2):
        raise ValueError(f"baf_conv takes stride >= 1, and 2 when "
                         f"transposed; got {stride}")
    if alpha is not None and bn is not None:
        raise ValueError("baf_conv applies PReLU or BN after the conv, "
                         "not both")
    vectors = [("bias", bias), ("alpha", alpha)]
    if bn is not None:
        vectors += [(f"bn {k}", bn[k]) for k in BN_KEYS]
    tensors = [("x", x), ("weight", weight)] + \
        [(n, t) for n, t in vectors if t is not None]
    for name, t in tensors:
        if t.dtype != torch.float32 or t.device != x.device or \
                not t.is_contiguous():
            raise ValueError(f"baf_conv takes contiguous float32 tensors on "
                             f"one device; {name} is {t.dtype} on {t.device}"
                             f"{'' if t.is_contiguous() else ', strided'}")
    for name, t in vectors:
        if t is not None and tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be ({cout},), got "
                             f"{tuple(t.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in tensors):
        raise ValueError("baf_conv has no backward: call it under "
                         "torch.no_grad() (the trainer runs nn.py's convs)")


def baf_conv(x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None = None, *, stride: int = 1,
             transposed: bool = False, alpha: torch.Tensor | None = None,
             bn: dict | None = None) -> torch.Tensor:
    """SAME 3x3 conv of x (B, H, W, Cin) with an OIHW weight (Cout, Cin, 3,
    3) -> (B, H', W', Cout), NHWC contiguous on the card: H' = ceil(H /
    stride), or 2H for ``transposed`` (XLA's SAME conv_transpose, stride 2).
    Then + ``bias``, then PReLU with ``alpha`` or BN with ``bn`` (the dict
    of ``nn.BatchNorm.params()``), each (Cout,). All float32 and
    contiguous, on one device."""
    _check(x, weight, bias, alpha, bn, stride, transposed)
    if x.device.type == "cpu":
        return baf_conv_plain(x, weight, bias, stride=stride,
                              transposed=transposed, alpha=alpha, bn=bn)
    return _baf_conv_device(x, weight, bias, stride=stride,
                            transposed=transposed, alpha=alpha, bn=bn)


@charged("baf_conv", baf_conv_cost)
def _baf_conv_device(x, weight, bias=None, *, stride: int = 1,
                     transposed: bool = False, alpha=None, bn=None):
    shape = out_shape(x, weight, stride=stride, transposed=transposed)
    if x.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    if x.device.type != "cuda":
        raise ValueError(f"no baf_conv kernel for device {x.device}")
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    b, h, w, cin = x.shape
    pad_t = 0 if transposed else tnn._same_pads(h, K, stride)[0]
    pad_l = 0 if transposed else tnn._same_pads(w, K, stride)[0]
    wp = prepared_weights(weight)
    norm = [None] * 4 if bn is None else [bn[k] for k in BN_KEYS]
    dev, stream = _build.stream_args(x)
    _build.BAF_CONV.launch(
        "baf_conv_f32", x.data_ptr(), wp.data_ptr(),
        *(None if t is None else t.data_ptr() for t in [bias, alpha, *norm]),
        out.data_ptr(), b, h, w, cin, shape[-1], stride, pad_t, pad_l,
        int(transposed), dev, stream)
    return out
