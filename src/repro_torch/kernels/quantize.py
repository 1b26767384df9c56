"""Fused channel gather + per-(example, channel) fp16 min/max + eq. (4) codes.

``quantize_fused`` is the wrapper: a CUDA tensor goes through the kernel
in ``csrc/quantize.cu`` (or the call raises); a CPU tensor goes through
``quantize_plain``, the same function in plain torch
(``core.quant.compute_quant_params(per_example=True)`` + ``quantize``).
Replaces the TPU kernel ``repro/kernels/quantize.py::quantize_pallas``.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import compute_quant_params, quantize
from repro_torch.kernels import _build

MAX_BITS = 16                  # uint8 codes to 8 bits, uint16 above
_ROW_BLOCK_MIN = 32            # rows per block of the reduction, at least
_TARGET_BLOCKS = 264           # about two blocks per SM of an H100


def quantize_plain(x: torch.Tensor, bits: int,
                   sel_idx: torch.Tensor | None = None):
    """x (B, R, P), sel_idx (C,) -> codes (B, R, C) u8/u16, mins/maxs (B, C)
    f16."""
    if sel_idx is not None:
        x = x[..., sel_idx]
    qp = compute_quant_params(x, bits, per_example=True)
    b, c = x.shape[0], x.shape[-1]
    return quantize(x, qp), qp.mins.reshape(b, c), qp.maxs.reshape(b, c)


def row_blocks(b: int, r: int, c: int) -> int:
    """How many blocks split R in the min/max pass, to fill the card."""
    groups = b * -(-c // 32)
    want = -(-_TARGET_BLOCKS // max(groups, 1))
    return max(1, min(want, -(-r // _ROW_BLOCK_MIN)))


def quantize_fused(x: torch.Tensor, bits: int,
                   sel_idx: torch.Tensor | None = None):
    """Quantize the channels ``sel_idx`` of ``x`` with per-example side info.

    x: (B, R, P) float32, channel-last and contiguous. sel_idx: (C,) int32
    on the same device with values in [0, P) (``None`` takes all P).
    Returns (codes (B, R, C), mins (B, C) fp16, maxs (B, C) fp16); codes
    are uint8 for 1..8 bits and uint16 for 9..16, as ``core.quant``. An
    (example, channel) holding a NaN gets NaN side info and zero codes.
    """
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"quantize kernel codes 1..{MAX_BITS} bits, got {bits}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, R, P), got shape {tuple(x.shape)}")
    if sel_idx is not None and sel_idx.dim() != 1:
        raise ValueError("sel_idx must be 1-D")
    if x.device.type == "cpu":
        return quantize_plain(x, bits, sel_idx)
    if x.device.type != "cuda":
        raise ValueError(f"no quantize kernel for device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 tensor")
    if sel_idx is not None and (sel_idx.dtype != torch.int32
                                or sel_idx.device != x.device
                                or not sel_idx.is_contiguous()):
        raise ValueError("sel_idx must be contiguous int32 on x's device")
    b, r, p = x.shape
    c = p if sel_idx is None else sel_idx.numel()
    wide = bits > 8
    codes = torch.empty((b, r, c), dtype=torch.uint16 if wide else torch.uint8,
                        device=x.device)
    mins = torch.empty((b, c), dtype=torch.float16, device=x.device)
    maxs = torch.empty((b, c), dtype=torch.float16, device=x.device)
    if codes.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)} has no min/max")
    nrb = row_blocks(b, r, c)
    partials = torch.empty(2 * b * nrb * c, dtype=torch.float32,
                           device=x.device)
    dev, stream = _build.stream_args(x)
    _build.QUANTIZE.launch(
        "baf_quantize_f32_u16" if wide else "baf_quantize_f32", x.data_ptr(),
        None if sel_idx is None else sel_idx.data_ptr(), codes.data_ptr(),
        mins.data_ptr(), maxs.data_ptr(), partials.data_ptr(), b, r, p, c,
        (1 << bits) - 1, nrb, dev, stream)
    return codes, mins, maxs
