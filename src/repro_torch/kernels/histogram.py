"""Per-channel symbol counts for the static rANS tables.

``histogram`` is the wrapper: a CUDA tensor goes through the kernel in
``csrc/histogram.cu`` (or the call raises); a CPU tensor goes through
``histogram_plain``. Replaces the TPU kernel
``repro/kernels/histogram.py::histogram_pallas``. On the card path the
compression plan runs it on the quantize kernel's codes while they are
still on the card; ``channel_histogram`` serves host numpy codes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_NSYM = 4096                # bits <= 12


def histogram_plain(codes: torch.Tensor, nsym: int) -> torch.Tensor:
    """codes (K, C) integers -> counts (C, nsym) int32; out-of-range dropped."""
    k, c = codes.shape
    v = codes.to(torch.int64)
    keep = (v >= 0) & (v < nsym)
    flat = (torch.arange(c, device=codes.device) * nsym + v)[keep]
    counts = torch.zeros(c * nsym, dtype=torch.int64, device=codes.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return counts.reshape(c, nsym).to(torch.int32)


def histogram(codes: torch.Tensor, nsym: int) -> torch.Tensor:
    """Per-channel counts of a (K, C) code matrix -> (C, nsym) int32.

    Values that are negative or >= nsym (the padding sentinel ``nsym``
    included) are counted nowhere. On the card, codes are uint8 or int32.
    """
    if codes.dim() != 2:
        raise ValueError(f"codes must be (K, C), got {tuple(codes.shape)}")
    if not 1 <= nsym <= MAX_NSYM:
        raise ValueError(f"nsym must be in 1..{MAX_NSYM}, got {nsym}")
    if codes.device.type == "cpu":
        return histogram_plain(codes, nsym)
    if codes.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {codes.device}")
    entry = {torch.uint8: "baf_histogram_u8",
             torch.int32: "baf_histogram_i32"}.get(codes.dtype)
    if entry is None:
        raise ValueError(f"histogram kernel takes uint8 or int32 codes, got "
                         f"{codes.dtype}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    k, c = codes.shape
    counts = torch.empty((c, nsym), dtype=torch.int32, device=codes.device)
    dev, stream = _build.stream_args(codes)
    _build.HISTOGRAM.launch(entry, codes.data_ptr(), counts.data_ptr(), k, c,
                            nsym, dev, stream)
    return counts


def channel_histogram(codes, bits: int) -> np.ndarray:
    """Counts of a channel-last host code array (..., C) -> (C, 2^bits) int64."""
    nsym = 1 << bits
    arr = np.asarray(codes)
    if arr.ndim == 0:
        arr = arr.reshape(1, 1)
    c = arr.shape[-1]
    if arr.size == 0 or c == 0:
        return np.zeros((c, nsym), np.int64)
    flat = torch.from_numpy(np.ascontiguousarray(arr.reshape(-1, c),
                                                 dtype=np.int32))
    return histogram(flat, nsym).numpy().astype(np.int64)
