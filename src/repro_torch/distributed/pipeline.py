"""Pod-boundary compression of the hidden stream (the paper's scheme on
the hop between pipeline stages).

Counterpart of ``repro/distributed/pipeline.py``, one process per pod:

  sender pod:   per-channel n-bit codes (eq. 4) of the (B, S, D) stream
                with fp16 side info per channel over all leading dims,
                through the quantize kernel (``quantize_fused`` on the
                (1, B·S, D) float32 view: eq. 4 at B = 1);
  wire:         ``ppermute`` over the ``pod`` process group of the codes,
                packed n bits each, and the fp16 mins and maxs: exactly
                ``wire_bytes()`` (the reference sends a byte a code);
  receiver pod: dequantize (eq. 5), then for a C-channel subset the BaF
                restore: the stream predictor, the receiver's frozen
                boundary block, and consolidation (eq. 6) of the
                transmitted channels through the consolidate kernel.

Stream codes are uint8, so 1..8 bits: the reference casts wider codes to
uint8 and wraps them; the port refuses them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.baf import BaFStream, baf_stream_predict
from repro_torch.core.quant import QuantParams, dequantize
from repro_torch.distributed.collectives import axis_group, ppermute
from repro_torch.kernels.quantize import channel_order, quantize_fused

MAX_STREAM_BITS = 8


def _quantize_stream(x: torch.Tensor, bits: int,
                     sel_idx: torch.Tensor | None = None, *,
                     order: torch.Tensor | None = None):
    """(..., D) -> (codes (..., C) uint8, mins (C,) f16, maxs (C,) f16):
    the channels ``sel_idx`` (all D when None) with one side-info row over
    all leading dims, through ``quantize_fused`` on the (1, R, D) float32
    view (a bf16 stream is upcast: its min and max are exact either way)."""
    if not 1 <= bits <= MAX_STREAM_BITS:
        raise ValueError(f"stream codes are uint8: 1..{MAX_STREAM_BITS} "
                         f"bits, got {bits}")
    d = x.shape[-1]
    x3 = x.reshape(1, -1, d).to(torch.float32).contiguous()
    codes, mn, mx = quantize_fused(x3, bits, sel_idx, order=order)
    return codes.reshape(*x.shape[:-1], codes.shape[-1]), mn[0], mx[0]


def _dequantize_stream(codes, mn, mx, bits: int, dtype):
    """Eq. 5 with the (C,) side info, in float32, then ``dtype``."""
    return dequantize(codes, QuantParams(mins=mn, maxs=mx, bits=bits), dtype)


def wire_bytes(x: torch.Tensor, bits: int) -> tuple[int, int]:
    """(compressed, uncompressed bf16) bytes of one transfer of x."""
    d = x.shape[-1]
    return x.numel() * bits // 8 + d * 4, x.numel() * 2


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 codes below 2^bits -> a flat uint8 wire of ceil(N·bits / 8)
    bytes: the codes in order, each low bit first."""
    flat = codes.reshape(-1)
    if bits == 8:
        return flat
    dev = flat.device
    stream = ((flat[:, None] >> torch.arange(bits, dtype=torch.uint8,
                                              device=dev)) & 1).reshape(-1)
    pad = -stream.numel() % 8
    if pad:
        stream = torch.cat([stream, stream.new_zeros(pad)])
    weights = torch.ones(8, dtype=torch.uint8, device=dev) \
        << torch.arange(8, dtype=torch.uint8, device=dev)
    return (stream.reshape(-1, 8) * weights).sum(1, dtype=torch.uint8)


def unpack_codes(wire: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """The first ``n`` codes of a ``pack_codes`` wire, flat uint8."""
    if bits == 8:
        return wire[:n]
    dev = wire.device
    stream = ((wire[:, None] >> torch.arange(8, dtype=torch.uint8,
                                              device=dev)) & 1).reshape(-1)
    stream = stream[:n * bits].reshape(n, bits)
    return (stream << torch.arange(bits, dtype=torch.uint8, device=dev)) \
        .sum(1, dtype=torch.uint8)


def _send(codes, mn, mx, bits: int, perm, group):
    """Codes (packed) and side info along ``perm`` -> what this pod got."""
    wire = ppermute(pack_codes(codes, bits), perm, group)
    mn = ppermute(mn, perm, group)
    mx = ppermute(mx, perm, group)
    return unpack_codes(wire, bits, codes.numel()).reshape(codes.shape), \
        mn, mx


def _ring(npod: int) -> list:
    return [(i, (i + 1) % npod) for i in range(npod)]


def compressed_pod_transfer(x: torch.Tensor, mesh, *, bits: int = 8,
                            pod_axis: str = "pod",
                            perm: Optional[list] = None,
                            dtype=torch.bfloat16) -> torch.Tensor:
    """Move this pod's stream x (B, S, D) one pod forward with n-bit codes
    on the wire; returns what this pod received, dequantized to
    ``dtype``. ``perm`` defaults to the ring (i -> i + 1)."""
    group, npod, _ = axis_group(mesh, pod_axis)
    codes, mn, mx = _quantize_stream(x, bits)
    codes, mn, mx = _send(codes, mn, mx, bits, perm or _ring(npod), group)
    return _dequantize_stream(codes, mn, mx, bits, dtype)


def baf_restore_stream(z_hat: torch.Tensor, *, baf: BaFStream,
                       forward_fn: Callable, sel_idx: torch.Tensor,
                       codes=None, qp: QuantParams | None = None,
                       dtype=None,
                       order: torch.Tensor | None = None) -> torch.Tensor:
    """Receiver-side BaF restore of a C-channel transfer: z_hat (B, S, C)
    -> the estimate of all D channels, the transmitted ones consolidated
    (eq. 6) when ``codes`` are given."""
    return baf_stream_predict(baf, forward_fn, sel_idx, z_hat, codes=codes,
                              qp=qp, dtype=dtype, order=order)


def subset_pod_transfer(x: torch.Tensor, mesh, *, sel_idx, baf: BaFStream,
                        forward_fn: Callable, bits: int = 8,
                        pod_axis: str = "pod", consolidation: bool = True,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """The paper's scheme on the pod boundary: send only the channels
    ``sel_idx`` of x (B, S, D), quantized (the kernel gathers them), and
    restore all D on the receiving pod by back-and-forth prediction. Wire
    bytes: C/D · n/16 of the bf16 transfer."""
    group, npod, _ = axis_group(mesh, pod_axis)
    sel = torch.as_tensor(sel_idx, dtype=torch.int32, device=x.device)
    order = channel_order(sel)
    codes, mn, mx = _quantize_stream(x, bits, sel, order=order)
    codes, mn, mx = _send(codes, mn, mx, bits, _ring(npod), group)
    z_hat = _dequantize_stream(codes, mn, mx, bits, dtype)
    keep = consolidation
    return baf_restore_stream(
        z_hat, baf=baf, forward_fn=forward_fn, sel_idx=sel,
        codes=codes if keep else None,
        qp=QuantParams(mins=mn, maxs=mx, bits=bits) if keep else None,
        dtype=dtype, order=order).to(dtype)
