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

import torch

from repro_torch.core.baf import consolidate, scatter_consolidated
from repro_torch.core.quant import QuantParams
from repro_torch.kernels import _build


def consolidate_plain(z: torch.Tensor, codes: torch.Tensor,
                      mins: torch.Tensor, maxs: torch.Tensor, bits: int,
                      sel_idx: torch.Tensor | None = None) -> torch.Tensor:
    """z (B, R, P) f32 in place; codes (B, R, C); mins/maxs (B, C) f16.

    ``core.baf.consolidate`` + ``scatter_consolidated``: the same eq. (6)
    as the ``fused=False`` restore.
    """
    qp = QuantParams(mins=mins[:, None, :], maxs=maxs[:, None, :], bits=bits)
    if sel_idx is None:
        return z.copy_(consolidate(z, codes, qp))
    return scatter_consolidated(z, consolidate(z[..., sel_idx], codes, qp),
                                sel_idx)


def consolidate_fused(z: torch.Tensor, codes: torch.Tensor,
                      mins: torch.Tensor, maxs: torch.Tensor, bits: int,
                      sel_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Clip ``z[..., sel_idx]`` to the received bins, in place; returns ``z``.

    z: (B, R, P) float32 contiguous; codes: (B, R, C) uint8 (1..8 bits)
    or uint16 (9..16 bits); mins/maxs: (B, C) fp16; sel_idx: (C,) int32
    with distinct values in [0, P) (``None`` means C == P).
    """
    if z.dim() != 3 or codes.dim() != 3 or mins.dim() != 2 or maxs.dim() != 2:
        raise ValueError("z/codes must be (B, R, *), mins/maxs (B, C)")
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
    dev, stream = _build.stream_args(z)
    _build.CONSOLIDATE.launch(
        "baf_consolidate_f32_u16" if bits > 8 else "baf_consolidate_f32",
        z.data_ptr(), codes.data_ptr(),
        mins.data_ptr(), maxs.data_ptr(),
        None if sel_idx is None else sel_idx.data_ptr(), b, r, p, c,
        (1 << bits) - 1, dev, stream)
    return z
