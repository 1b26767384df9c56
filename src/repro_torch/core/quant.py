"""Per-channel uniform scalar quantization, paper eqs. (4)-(5), in torch.

Counterpart of ``repro/core/quant.py``. Channel-last: a tensor is (..., C)
with one fp16 (min, max) pair per channel. These are the plain versions of
the quantize kernel (``repro_torch/kernels/quantize.py``), and they match
the JAX functions bit for bit: fp16 rounding is round-to-nearest-even in
both, the max widens by one fp16 ulp towards +inf (done on the bit pattern,
which works for float16 on every device), both saturate at +-65504, the
min ranks -0.0 below +0.0 and the max +0.0 above -0.0 (as ``jnp.min`` and
``jnp.max`` do), and the divide is an IEEE divide. Divisions by the level
count divide by a 0-dim tensor on the data's device, because PyTorch's
CUDA division by a Python scalar multiplies by its reciprocal, which
rounds differently.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F16_MAX = 65504.0


class QuantParams(NamedTuple):
    """Side information sent with the codes (fp16, per channel)."""
    mins: torch.Tensor     # (..., C) fp16
    maxs: torch.Tensor     # (..., C) fp16
    bits: int

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1

    def step(self) -> torch.Tensor:
        rng = self.maxs.float() - self.mins.float()
        return rng / _scalar(rng, self.levels)


def _scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-dim float32 tensor filled on ``like``'s device: no
    copy from the host, which would wait for the device's queue."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def f16_next_up(h: torch.Tensor) -> torch.Tensor:
    """``nextafter(h, +inf)`` for float16, on the bit pattern.

    +-0 -> smallest positive subnormal; +inf stays; -inf -> -65504.
    """
    bits = h.view(torch.int16)
    mag = bits & 0x7FFF
    up = torch.where(bits >= 0, bits + 1, bits - 1)
    up = torch.where(mag == 0, torch.ones_like(bits), up)
    up = torch.where(bits == 0x7C00, bits, up)          # +inf stays +inf
    return up.view(torch.float16)


def side_info(mn: torch.Tensor, mx: torch.Tensor):
    """f32 per-channel min/max -> saturated fp16 (mins, widened maxs)."""
    f16_max = torch.tensor(F16_MAX, dtype=torch.float16, device=mn.device)
    mins = torch.maximum(mn.to(torch.float16), -f16_max)
    maxs = mx.to(torch.float16)
    maxs = torch.minimum(torch.maximum(maxs, f16_next_up(maxs)), f16_max)
    return mins, maxs


def compute_quant_params(x: torch.Tensor, bits: int, *,
                         per_example: bool = False) -> QuantParams:
    """Per-channel fp16 min/max (paper §3.2).

    per_example=False: one pair per channel over all leading dims.
    per_example=True : one pair per (example, channel), with singleton
    middle dims kept so the side info broadcasts against ``x``.
    """
    x = x.float()
    dims = tuple(range(1 if per_example else 0, x.ndim - 1))
    mn, mx = signed_zero_min_max(x, dims, per_example) if dims else (x, x)
    mins, maxs = side_info(mn, mx)
    return QuantParams(mins=mins, maxs=maxs, bits=bits)


def signed_zero_min_max(x: torch.Tensor, dims: tuple, keepdim: bool):
    """``torch.amin``/``amax`` over ``dims`` with ``jnp.min``/``jnp.max``'s
    order of the zeros: -0.0 below +0.0. ``torch.amin`` returns whichever
    equal zero it meets first, and the fp16 min goes on the wire. NaN still
    propagates (NaN == 0 is false)."""
    mn = torch.amin(x, dim=dims, keepdim=keepdim)
    mx = torch.amax(x, dim=dims, keepdim=keepdim)
    zero, neg = x == 0, torch.signbit(x)
    neg0 = (zero & neg).any(dim=dims, keepdim=keepdim)
    pos0 = (zero & ~neg).any(dim=dims, keepdim=keepdim)
    mn = torch.where((mn == 0) & neg0, -0.0, mn)
    mx = torch.where((mx == 0) & pos0, 0.0, mx)
    return mn, mx


def quantize(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Eq. (4): round((x - m) / max(M - m, 1e-12) * (2^n - 1)), clipped."""
    m = qp.mins.float()
    rng = torch.clamp_min(qp.maxs.float() - m, 1e-12)
    scaled = (x.float() - m) / rng * qp.levels
    codes = torch.clamp(torch.round(scaled), 0, qp.levels)
    if qp.bits <= 8:
        return codes.to(torch.uint8)
    if qp.bits <= 16:
        return codes.to(torch.int32).to(torch.uint16)
    return codes.to(torch.int64).to(torch.uint32)


def dequantize(codes: torch.Tensor, qp: QuantParams,
               dtype=torch.float32) -> torch.Tensor:
    """Eq. (5): codes / (2^n - 1) * (M - m) + m."""
    m = qp.mins.float()
    c = codes.float()
    x = c / _scalar(c, qp.levels) * (qp.maxs.float() - m) + m
    return x.to(dtype)


def bin_bounds(codes: torch.Tensor, qp: QuantParams):
    """Data-domain bounds ``m + (c -+ 1/2) * step`` of each code's bin."""
    m = qp.mins.float()
    step = qp.step()
    c = codes.float()
    return m + (c - 0.5) * step, m + (c + 0.5) * step
