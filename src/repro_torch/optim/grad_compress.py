"""Compressed cross-pod gradient mean: the paper's quantizer (eq. 4) on
the slowest link of multi-pod training.

Counterpart of ``repro/optim/grad_compress.py``. Each pod (one process
here) quantizes its partial gradient with a per-tensor scale that all pods
share (the ``all_reduce(MAX)`` of max |g| over the levels), sums the
signed int8 (int16 above 8 bits) codes of every pod in int32
(``collectives.ring_sum``: only the narrow codes travel) and dequantizes
the mean. The residual g - codes * scale is this pod's quantization error,
fed back into the next step's gradients (error feedback).

Every division is by a 0-dim float32 tensor on the data's device: PyTorch's
CUDA division by a Python scalar multiplies by its reciprocal.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.quant import _scalar
from repro_torch.distributed.collectives import axis_group, ring_sum


def _quantized_psum_one(g: torch.Tensor, bits: int, group, npod: int):
    """-> (the pods' mean of g in g's dtype, this pod's float32 residual)."""
    if not 2 <= bits <= 16:
        raise ValueError(f"gradient codes take 2..16 bits, got {bits}")
    levels = (1 << (bits - 1)) - 1            # signed symmetric codes
    amax = g.abs().amax().to(torch.float32)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.maximum(amax, _scalar(g, 1e-30)) / _scalar(g, levels)
    codes = torch.clamp(torch.round(g.to(torch.float32) / scale),
                        -levels, levels)
    codes = codes.to(torch.int8 if bits <= 8 else torch.int16)
    acc = ring_sum(codes, group)
    mean = acc.to(torch.float32) * scale / _scalar(g, npod)
    local = codes.to(torch.float32) * scale   # what this pod contributed
    return mean.to(g.dtype), g.to(torch.float32) - local


def quantized_pod_mean(grads: dict, mesh, *, bits: int = 8,
                       pod_axis: str = "pod"):
    """Mean of a ``{name: gradient}`` dict across the pods of ``mesh`` with
    n-bit codes on the wire -> (means, residuals), both by name. ``grads``
    are this pod's partial means."""
    group, npod, _ = axis_group(mesh, pod_axis)
    means, residuals = {}, {}
    for k, g in grads.items():
        means[k], residuals[k] = _quantized_psum_one(g, bits, group, npod)
    return means, residuals
