"""Fused channel gather + per-(example, channel) fp16 min/max + eq. (4) codes.

``quantize_fused`` is the wrapper: a CUDA tensor goes through the kernel
in ``csrc/quantize.cu`` (or the call raises); a CPU tensor goes through
``quantize_plain``, the same function in plain torch
(``core.quant.compute_quant_params(per_example=True)`` + ``quantize``).
Replaces the TPU kernel ``repro/kernels/quantize.py::quantize_pallas``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quant import compute_quant_params, quantize
from repro_torch.kernels import _build
from repro_torch.launch.hlo_cost import charged

MAX_BITS = 16                  # uint8 codes to 8 bits, uint16 above
THREADS = 256                  # threads of a block
HOLD = 16                      # values of x a thread keeps in registers
MAX_GROUP = 8                  # channels a cluster reduces
MAX_CLUSTER = 16               # blocks of a cluster (8 is the portable size)


class QuantizePlan(NamedTuple):
    """Launch plan of the quantize kernel: a cluster of ``cluster`` blocks
    for each (example, group of ``group`` channels), each block reducing and
    coding ``rows_per_block`` rows; ``held`` when those rows fit in HOLD
    values a thread, so x is read once."""
    group: int
    cluster: int
    rows_per_block: int
    held: bool


def quantize_plan(b: int, r: int, c: int) -> QuantizePlan:
    """Channels a cluster: a power of two, at most 8, no wider than C needs.
    Blocks a cluster: the fewest (a power of two up to 16) that hold R rows
    in registers; measured best on the H100 among 2-8 channels by 2-16
    blocks at B = 1 and 8 (PERF.md). Rows a block."""
    group = min(MAX_GROUP, 1 << max(c - 1, 0).bit_length())
    cap = HOLD * THREADS // group                   # rows a block can hold
    cluster = min(MAX_CLUSTER, 1 << max(-(-r // cap) - 1, 0).bit_length())
    rows = -(-r // cluster)
    return QuantizePlan(group, cluster, rows, rows <= cap)


def quantize_plain(x: torch.Tensor, bits: int,
                   sel_idx: torch.Tensor | None = None):
    """x (B, R, P), sel_idx (C,) -> codes (B, R, C) u8/u16, mins/maxs (B, C)
    f16."""
    if sel_idx is not None:
        x = x[..., sel_idx]
    qp = compute_quant_params(x, bits, per_example=True)
    b, c = x.shape[0], x.shape[-1]
    return quantize(x, qp), qp.mins.reshape(b, c), qp.maxs.reshape(b, c)


def channel_order(sel_idx: torch.Tensor) -> torch.Tensor:
    """The quantize kernel's channel table for ``sel_idx`` (C,): a (C, 2)
    int32 tensor on sel_idx's device whose row k is (output column, column
    of x), the rows sorted by column of x (equal columns by position), so
    the channels a cluster reduces lie close together in a row of x.
    Computed once per selection: the compression plan does so when it is
    compiled."""
    sel = sel_idx.to(torch.int64)
    order = torch.argsort(sel, stable=True)
    return torch.stack([order, sel[order]], 1).to(torch.int32).contiguous()


def quantize_cost(x, bits, sel_idx=None, *, order=None):
    """(flops, bytes) of a call: the selected elements of x read once, the
    channel table's C int32 read once, codes and fp16 side info written
    once (PERF.md's kernel table)."""
    b, r, p = x.shape
    c = p if sel_idx is None else sel_idx.numel()
    code = 2 if bits > 8 else 1
    return 0.0, (b * r * c * x.element_size() + (0 if sel_idx is None
                                                  else c * 4)
                 + b * r * c * code + 2 * b * c * 2)


@charged("quantize", quantize_cost)
def quantize_fused(x: torch.Tensor, bits: int,
                   sel_idx: torch.Tensor | None = None, *,
                   order: torch.Tensor | None = None):
    """Quantize the channels ``sel_idx`` of ``x`` with per-example side info.

    x: (B, R, P) float32, channel-last and contiguous. sel_idx: (C,) int32
    on the same device with values in [0, P) (``None`` takes all P).
    Returns (codes (B, R, C), mins (B, C) fp16, maxs (B, C) fp16); codes
    are uint8 for 1..8 bits and uint16 for 9..16, as ``core.quant``. An
    (example, channel) holding a NaN gets NaN side info and zero codes.

    ``order``: ``channel_order(sel_idx)``, computed once by a caller that
    quantizes the same selection again and again; the kernel then reads
    only it. Without it the wrapper computes it on each call (a few more
    device operations). The CPU path does not need it. Only the table's
    shape, type and layout are checked here: the kernel skips an entry
    whose output column or column of x is out of range (it reads no x and
    writes no codes or side info for it).

    On the card this is one launch (``quantize_plan``): a cluster of up to
    16 blocks per (example, group of up to 8 channels), each block holding
    its rows in registers, so x is read once while R <= MAX_CLUSTER * HOLD
    * THREADS / group: 8192 rows at 8 channels a group, 65536 at one.
    Beyond that limit each block reads its rows a second time (from L2
    where they are still there) in the same launch.
    """
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"quantize kernel codes 1..{MAX_BITS} bits, got {bits}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, R, P), got shape {tuple(x.shape)}")
    if sel_idx is not None and sel_idx.dim() != 1:
        raise ValueError("sel_idx must be 1-D")
    if order is not None and sel_idx is None:
        raise ValueError("order is the channel table of a sel_idx")
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
    if b * r * c == 0:
        raise ValueError(f"empty input {tuple(x.shape)} has no min/max")
    if sel_idx is not None:
        if order is None:
            order = channel_order(sel_idx)
        elif (order.shape != (c, 2) or order.dtype != torch.int32
              or order.device != x.device or not order.is_contiguous()
              or order.data_ptr() % 8):
            raise ValueError("order must be channel_order(sel_idx): "
                             "contiguous (C, 2) int32 on x's device")
    return _launch(x, bits, order, quantize_plan(b, r, c))


def _launch(x: torch.Tensor, bits: int, order: torch.Tensor | None,
            plan: QuantizePlan):
    """The kernel on inputs ``quantize_fused`` has checked, with the
    channel table ``order`` (``None``: every channel of x in order), under
    ``plan``. The kernel refuses a plan that does not cover R or holds
    more than HOLD values a thread."""
    b, r, p = x.shape
    c = p if order is None else order.shape[0]
    wide = bits > 8
    codes = torch.empty((b, r, c), dtype=torch.uint16 if wide else torch.uint8,
                        device=x.device)
    mins = torch.empty((b, c), dtype=torch.float16, device=x.device)
    maxs = torch.empty((b, c), dtype=torch.float16, device=x.device)
    dev, stream = _build.stream_args(x)
    _build.QUANTIZE.launch(
        "baf_quantize_f32_u16" if wide else "baf_quantize_f32", x.data_ptr(),
        None if order is None else order.data_ptr(), codes.data_ptr(),
        mins.data_ptr(), maxs.data_ptr(), b, r, p, c, (1 << bits) - 1,
        plan.group, plan.cluster, plan.rows_per_block, int(plan.held), dev,
        stream)
    return codes, mins, maxs
