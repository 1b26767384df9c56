"""Per-channel symbol counts for the static rANS tables, and their CDF.

``histogram`` is the wrapper of the kernel in ``csrc/histogram.cu`` and
``cdf`` that of ``csrc/cdf.cu``: a CUDA tensor goes through the kernel (or
the call raises); a CPU tensor goes through ``histogram_plain`` /
``cdf_plain``. They replace the TPU kernels
``repro/kernels/histogram.py::histogram_pallas`` and ``cdf_pallas``. On the
card path the compression plan runs the histogram on the quantize kernel's
codes while they are still on the card; ``channel_histogram`` serves host
numpy codes, and ``channel_histogram_cdf`` runs both kernels on its
``device``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.launch.hlo_cost import charged

MAX_NSYM = 4096                # bits <= 12
MAX_GROUP = 4                  # channels a cluster counts (kMaxGroup)
MAX_CLUSTER = 16               # blocks of a cluster (8 is the portable size)
ROWS_PER_BLOCK = 512           # rows a block counts, about
SMEM_MAX = 231_424             # dynamic shared memory of one H100 block:
                               # 227 KB less 1 KB left for the static part
SEG_SYMBOLS = 256              # symbols a warp of the cdf kernel scans
MAX_CDF_WARPS = 32             # warps of a cdf block (kMaxWarps)


class HistogramPlan(NamedTuple):
    """Launch plan of the histogram kernel: a cluster of ``cluster`` blocks
    for each group of ``group`` channels, each block counting
    ``rows_per_block`` rows and summing ``share`` units of ``unit`` bins
    over the cluster, in ``smem_bytes`` of shared memory. The kernel takes
    these values as they are and refuses a plan that does not cover the
    rows and bins or that a block cannot hold."""
    group: int
    cluster: int
    rows_per_block: int
    unit: int
    share: int
    smem_bytes: int


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _plan(k: int, nsym: int, group: int, cluster: int) -> HistogramPlan:
    """The plan for ``group`` channels by ``cluster`` blocks: the bins are
    handed out in units of 16 bytes where nsym allows; a block's shared
    memory holds one histogram of the group and the bins it sums as the
    cluster's blocks store them."""
    unit = 4 if nsym % 4 == 0 else 1
    share = -(-(group * nsym // unit) // cluster)
    smem = 4 * (group * nsym + cluster * share * unit)
    return HistogramPlan(group, cluster, -(-k // cluster), unit, share, smem)


def histogram_plan(k: int, c: int, nsym: int) -> HistogramPlan:
    """Channels a cluster: a power of two, at most 4, no wider than C needs,
    narrower where the shared memory would not hold it. Blocks a cluster: a
    power of two up to 16, about ROWS_PER_BLOCK rows each; at most 8 where
    one block takes more than half an SM's shared memory. Both measured
    best on the H100 among 2-8 channels by 1-16 blocks at K = 4096 and
    32768 (PERF.md)."""
    group = min(MAX_GROUP, _pow2_ceil(c))
    wanted = min(MAX_CLUSTER, _pow2_ceil(-(-k // ROWS_PER_BLOCK)))
    while True:
        plan = _plan(k, nsym, group, wanted)
        if plan.smem_bytes > SMEM_MAX // 2 and plan.cluster > 8:
            plan = _plan(k, nsym, group, 8)
        if plan.smem_bytes <= SMEM_MAX or group == 1:
            return plan
        group //= 2


def histogram_plain(codes: torch.Tensor, nsym: int) -> torch.Tensor:
    """codes (K, C) integers -> counts (C, nsym) int32; out-of-range dropped."""
    k, c = codes.shape
    v = codes.to(torch.int64)
    keep = (v >= 0) & (v < nsym)
    flat = (torch.arange(c, device=codes.device) * nsym + v)[keep]
    counts = torch.zeros(c * nsym, dtype=torch.int64, device=codes.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return counts.reshape(c, nsym).to(torch.int32)


def histogram_cost(codes, nsym):
    """(flops, bytes) of a call: the codes read once, the int32 counts
    written once."""
    c = codes.shape[-1] if codes.dim() else 1
    return 0.0, codes.numel() * codes.element_size() + c * nsym * 4


@charged("histogram", histogram_cost)
def histogram(codes: torch.Tensor, nsym: int) -> torch.Tensor:
    """Per-channel counts of a (K, C) code matrix -> (C, nsym) int32.

    Values that are negative or >= nsym (the padding sentinel ``nsym``
    included) are counted nowhere. On the card, codes are uint8, uint16 or
    int32, and the kernel is one launch (see ``histogram_plan``) that
    writes every count.
    """
    if codes.dim() != 2:
        raise ValueError(f"codes must be (K, C), got {tuple(codes.shape)}")
    if not 1 <= nsym <= MAX_NSYM:
        raise ValueError(f"nsym must be in 1..{MAX_NSYM}, got {nsym}")
    if codes.device.type == "cpu":
        return histogram_plain(codes, nsym)
    if codes.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {codes.device}")
    if codes.dtype not in (torch.uint8, torch.uint16, torch.int32):
        raise ValueError(f"histogram kernel takes uint8, uint16 or int32 "
                         f"codes, got {codes.dtype}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    k, c = codes.shape
    if c == 0:
        return torch.empty((0, nsym), dtype=torch.int32, device=codes.device)
    return _launch(codes, nsym, histogram_plan(k, c, nsym))


def _launch(codes: torch.Tensor, nsym: int,
            plan: HistogramPlan) -> torch.Tensor:
    """The kernel on codes ``histogram`` has checked, under ``plan``."""
    k, c = codes.shape
    entry = {torch.uint8: "baf_histogram_u8",
             torch.uint16: "baf_histogram_u16",
             torch.int32: "baf_histogram_i32"}[codes.dtype]
    counts = torch.empty((c, nsym), dtype=torch.int32, device=codes.device)
    dev, stream = _build.stream_args(codes)
    _build.HISTOGRAM.launch(entry, codes.data_ptr(), counts.data_ptr(), k, c,
                            nsym, *plan, dev, stream)
    return counts


def _host_codes(codes, nsym: int) -> tuple[int, torch.Tensor | None]:
    """Channel-last host codes (..., C) -> (C, the (K, C) CPU tensor the
    kernel takes, or ``None`` when empty). uint8, uint16 and int32 go as
    they are (copied only where not contiguous); any other type is clipped
    to [-1, nsym] and sent as int32, so a value out of range, which the
    kernel counts nowhere, never wraps into it."""
    arr = np.asarray(codes)
    if arr.ndim == 0:
        arr = arr.reshape(1, 1)
    c = arr.shape[-1]
    if arr.size == 0 or c == 0:
        return c, None
    flat = arr.reshape(-1, c)
    if flat.dtype not in (np.uint8, np.uint16, np.int32):
        flat = np.clip(flat.astype(np.int64), -1, nsym).astype(np.int32)
    return c, torch.from_numpy(np.ascontiguousarray(flat))


def channel_histogram(codes, bits: int) -> np.ndarray:
    """Counts of a channel-last host code array (..., C) -> (C, 2^bits) int64."""
    nsym = 1 << bits
    c, flat = _host_codes(codes, nsym)
    if flat is None:
        return np.zeros((c, nsym), np.int64)
    return histogram(flat, nsym).numpy().astype(np.int64)


def cdf_plain(counts: torch.Tensor) -> torch.Tensor:
    """counts (S, C) -> exclusive prefix sum along S, int32 (cumsum - counts)."""
    c32 = counts.to(torch.int32)
    return (torch.cumsum(c32, dim=0, dtype=torch.int32) - c32)


def cdf_plan(s: int) -> int:
    """Warps the cdf kernel gives a channel: one for each 256 symbols
    (SEG_SYMBOLS, 8 a lane), so every lane holds its symbols in
    registers after one load."""
    return max(1, -(-s // SEG_SYMBOLS))


def _cdf_layout(t: torch.Tensor) -> bool:
    """(S, C) row-major, or the (S, C) view of a (C, S) buffer."""
    return t.is_contiguous() or t.t().is_contiguous()


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the memory spans of two dense tensors meet."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()


def cdf_cost(counts, *, out=None):
    """(flops, bytes) of a call: the counts read once, the int32 CDF
    written once."""
    return 0.0, counts.numel() * (counts.element_size() + 4)


@charged("cdf", cdf_cost)
def cdf(counts: torch.Tensor, *, out: torch.Tensor | None = None
        ) -> torch.Tensor:
    """Exclusive CDF along the symbol axis of (S, C) counts -> (S, C) int32.

    The TPU kernel's layout: symbols down the rows, one channel a column.
    Exact in int32. On the card, counts are int32, and ``counts`` and
    ``out`` are each (S, C) row-major or the (S, C) view ``buf.t()`` of a
    (C, S) buffer, as the histogram writes counts; the kernel reads and
    writes through their strides. ``out`` (optional, not overlapping
    ``counts``) receives the CDF; without it the result takes the layout
    of ``counts``. Returns ``out``.
    """
    if counts.dim() != 2:
        raise ValueError(f"counts must be (S, C), got {tuple(counts.shape)}")
    if out is not None and (out.shape != counts.shape
                            or out.dtype != torch.int32
                            or out.device != counts.device):
        raise ValueError(f"out must be int32 {tuple(counts.shape)} on "
                         f"{counts.device}")
    if counts.device.type == "cpu":
        want = cdf_plain(counts)
        return want if out is None else out.copy_(want)
    if counts.device.type != "cuda":
        raise ValueError(f"no cdf kernel for device {counts.device}")
    if out is None:
        out = torch.empty_like(counts, dtype=torch.int32)
    if counts.dtype != torch.int32 or not (_cdf_layout(counts)
                                           and _cdf_layout(out)):
        raise ValueError("cdf kernel takes int32 counts and output, each "
                         "(S, C) row-major or the (S, C) view of a (C, S) "
                         f"buffer; got {counts.dtype} strides "
                         f"{counts.stride()} -> {out.stride()}")
    if _overlap(counts, out):
        raise ValueError("cdf: out overlaps counts")
    s, c = counts.shape
    if s > MAX_CDF_WARPS * SEG_SYMBOLS:
        raise ValueError(f"cdf kernel takes S <= "
                         f"{MAX_CDF_WARPS * SEG_SYMBOLS}, got {s}")
    if s * c == 0:
        return out
    dev, stream = _build.stream_args(counts)
    _build.CDF.launch("baf_cdf_i32", counts.data_ptr(), out.data_ptr(), s, c,
                      *counts.stride(), *out.stride(), cdf_plan(s), dev,
                      stream)
    return out


def channel_histogram_cdf(codes, bits: int, *,
                          device=None) -> tuple[np.ndarray, np.ndarray]:
    """Counts and exclusive CDF of channel-last codes (..., C), both (C, S)
    int64 on the host, computed by the histogram and cdf kernels on
    ``device`` (``None`` = the card; ``"cpu"`` runs the plain versions).

    On the card: one upload of the codes (uint8 and uint16 as they are),
    the two kernels, the cdf reading the histogram's (C, S) counts and
    writing a (C, S) buffer through their transposed views, and one copy
    back of each."""
    nsym = 1 << bits
    c, flat = _host_codes(codes, nsym)
    if flat is None:
        z = np.zeros((c, nsym), np.int64)
        return z, z.copy()
    counts = histogram(flat.to(resolve_device(device)), nsym)   # (C, S)
    cum = torch.empty_like(counts)                              # (C, S)
    cdf(counts.t(), out=cum.t())
    return (counts.cpu().numpy().astype(np.int64),
            cum.cpu().numpy().astype(np.int64))
