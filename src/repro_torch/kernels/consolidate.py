"""Eq. (6) consolidation fused with the channel gather and scatter.

``consolidate_fused`` is the wrapper: a CUDA tensor goes through the kernel
in ``csrc/consolidate.cu`` (or the call raises); a CPU tensor goes through
``consolidate_plain``. Both update the full estimate ``z`` IN PLACE: the
transmitted channels ``sel_idx`` are clipped to the bins of the received
codes and the other channels are left as they are. Replaces the TPU kernel
``repro/kernels/consolidate.py::consolidate_pallas`` with the gather and
``scatter_consolidated`` around it in ``repro/core/split.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.baf import consolidate, scatter_consolidated
from repro_torch.core.quant import QuantParams
from repro_torch.kernels import _build
from repro_torch.launch.hlo_cost import charged
from repro_torch.kernels.quantize import channel_order

THREADS = 256                  # threads of a block
ROWS_A_THREAD = 4              # rows a thread loads before it stores (kRows)
MIN_BLOCKS = 264               # two blocks for each of the H100's 132 SMs
INT32_MAX = 2**31 - 1


class ConsolidatePlan(NamedTuple):
    """Launch plan of the consolidate kernel: a block per (example, tile of
    ``rows_per_block`` rows), ``row_threads`` threads across the channels
    of a row (the others over rows). The kernel takes these values as they
    are and refuses a plan that does not fit the shapes."""
    rows_per_block: int
    row_threads: int


def consolidate_plan(b: int, r: int, c: int) -> ConsolidatePlan:
    """Threads across a row: every channel, up to a block of them. Rows a
    block: ROWS_A_THREAD for each thread, fewer where that leaves under
    MIN_BLOCKS blocks."""
    row_threads = min(c, THREADS)
    rows = min(r, THREADS // row_threads * ROWS_A_THREAD)
    tiles = -(-MIN_BLOCKS // max(b, 1))
    return ConsolidatePlan(max(1, min(rows, r // tiles)), row_threads)


def consolidate_plain(z: torch.Tensor, codes: torch.Tensor,
                      mins: torch.Tensor, maxs: torch.Tensor, bits: int,
                      sel_idx: torch.Tensor | None = None) -> torch.Tensor:
    """z (B, R, P) f32 in place; codes (B, R, C); mins/maxs (B, C) f16.

    ``core.baf.consolidate`` + ``scatter_consolidated``: the same eq. (6)
    as the ``fused=False`` restore. NaN in z or in the side info gives NaN,
    as ``jnp.clip`` does.
    """
    qp = QuantParams(mins=mins[:, None, :], maxs=maxs[:, None, :], bits=bits)
    if sel_idx is None:
        return z.copy_(consolidate(z, codes, qp))
    return scatter_consolidated(z, consolidate(z[..., sel_idx], codes, qp),
                                sel_idx)


def consolidate_cost(z, codes, mins, maxs, bits, sel_idx=None, *,
                     order=None):
    """(flops, bytes) of a call: the selected elements of z read and
    written once, codes, fp16 side info and the channel table's C int32
    read once (PERF.md's kernel table)."""
    b, r, p = z.shape
    c = p if sel_idx is None else sel_idx.numel()
    return 0.0, (2 * b * r * c * z.element_size()
                 + codes.numel() * codes.element_size() + 2 * b * c * 2
                 + (0 if sel_idx is None else c * 4))


@charged("consolidate", consolidate_cost)
def consolidate_fused(z: torch.Tensor, codes: torch.Tensor,
                      mins: torch.Tensor, maxs: torch.Tensor, bits: int,
                      sel_idx: torch.Tensor | None = None, *,
                      order: torch.Tensor | None = None) -> torch.Tensor:
    """Clip ``z[..., sel_idx]`` to the received bins, in place; returns ``z``.

    z: (B, R, P) float32 contiguous; codes: (B, R, C) uint8 (1..8 bits)
    or uint16 (9..16 bits); mins/maxs: (B, C) fp16; sel_idx: (C,) int32
    with distinct values in [0, P) (``None`` means C == P). A NaN in z or
    in an (example, channel)'s side info gives NaN there.

    ``order``: ``quantize.channel_order(sel_idx)``, the channel table in
    address order that the compression plan computes once; without it the
    wrapper computes it on each call. Only its shape, type and layout are
    checked: the kernel follows its contents, not ``sel_idx``, and skips an
    entry whose output column or column of z is out of range. The CPU
    path does not need it.

    On the card this is one launch (``consolidate_plan``): a block per
    (example, tile of rows), a thread per channel and few rows, its
    channel's step divided once.
    """
    if z.dim() != 3 or codes.dim() != 3 or mins.dim() != 2 or maxs.dim() != 2:
        raise ValueError("z/codes must be (B, R, *), mins/maxs (B, C)")
    if order is not None and sel_idx is None:
        raise ValueError("order is the channel table of a sel_idx")
    b, r, p = z.shape
    c = p if sel_idx is None else sel_idx.numel()
    if (tuple(codes.shape) != (b, r, c) or tuple(mins.shape) != (b, c)
            or tuple(maxs.shape) != (b, c)):
        raise ValueError(
            f"shapes disagree: z {tuple(z.shape)}, codes "
            f"{tuple(codes.shape)}, mins {tuple(mins.shape)}, maxs "
            f"{tuple(maxs.shape)}, C={c}")
    if z.device.type == "cpu":
        return consolidate_plain(z, codes, mins, maxs, bits, sel_idx)
    if z.device.type != "cuda":
        raise ValueError(f"no consolidate kernel for device {z.device}")
    if not 1 <= bits <= 16:
        raise ValueError(f"consolidate kernel takes 1..16 bits, got {bits}")
    code_type = torch.uint16 if bits > 8 else torch.uint8
    tensors = [(z, torch.float32), (codes, code_type),
               (mins, torch.float16), (maxs, torch.float16)]
    if sel_idx is not None:
        tensors.append((sel_idx, torch.int32))
    for t, dtype in tensors:
        if t.dtype != dtype or t.device != z.device or not t.is_contiguous():
            raise ValueError(f"expected contiguous {dtype} on {z.device}, got "
                             f"{t.dtype} on {t.device}")
    if b > 65535 or r * p > INT32_MAX:
        raise ValueError(f"consolidate kernel takes B <= 65535 and R * P < "
                         f"2^31, got {tuple(z.shape)}")
    if b * r * c == 0:
        return z
    if sel_idx is not None:
        if order is None:
            order = channel_order(sel_idx)
        elif (order.shape != (c, 2) or order.dtype != torch.int32
              or order.device != z.device or not order.is_contiguous()
              or order.data_ptr() % 8):
            raise ValueError("order must be a contiguous, 8-byte aligned "
                             "(C, 2) int32 table on z's device")
    return _launch(z, codes, mins, maxs, bits, order,
                   consolidate_plan(b, r, c))


def _launch(z, codes, mins, maxs, bits: int, order: torch.Tensor | None,
            plan: ConsolidatePlan) -> torch.Tensor:
    """The kernel on inputs ``consolidate_fused`` has checked, with the
    channel table ``order`` (``None``: channel k is column k), under
    ``plan``."""
    b, r, p = z.shape
    c = codes.shape[-1]
    dev, stream = _build.stream_args(z)
    _build.CONSOLIDATE.launch(
        "baf_consolidate_f32_u16" if bits > 8 else "baf_consolidate_f32",
        z.data_ptr(), codes.data_ptr(), mins.data_ptr(), maxs.data_ptr(),
        None if order is None else order.data_ptr(), b, r, p, c,
        (1 << bits) - 1, *plan, dev, stream)
    return z
