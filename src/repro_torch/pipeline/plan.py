"""Plan/execute split for the BaF compression pipeline, on the card.

Counterpart of ``repro/pipeline/plan.py``. ``compile(op, spec)`` turns an
:class:`OperatingPoint` and the model into a :class:`CompressionPlan`:

    plan.encode(z)            -> WireBlob     quantize kernel, histogram
                                              kernel, one copy, host rANS
    plan.decode_batch(blobs)  -> DecodedBatch vectorized host decode
    plan.restore(decoded)     -> z_tilde      BaF restore + consolidate kernel

The plan runs on ``device`` (``None`` = the card). On the card, ``encode``
quantizes the selected channels with the quantize kernel and, for the
static ``rans`` backend, counts their symbols with the histogram kernel
while the codes are still on the card; codes, side info and counts then
come to the host in one copy, and the host coder takes the counts as they
are. The wire bytes equal the JAX package's for the same codes.
Codes are uint8 up to 8 bits and uint16 from 9 to 16, as in the JAX
package; the rANS backends take up to 12 bits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core import codec as wire
from repro_torch.core.quant import QuantParams
from repro_torch.core.split import (SplitStats, restore_codes,
                                    restore_codes_fused, to_device)
from repro_torch.core.tiling import tile_batch, tile_grid, untile_batch
from repro_torch.device import resolve_device
from repro_torch.kernels.histogram import MAX_NSYM, histogram
from repro_torch.kernels.quantize import channel_order, quantize_fused
from repro_torch.obs import hooks
from repro_torch.pipeline.op import OperatingPoint

_NP_DTYPES = {torch.uint8: np.uint8, torch.uint16: np.uint16,
              torch.float16: np.float16, torch.int32: np.int32}


@dataclass(frozen=True, eq=False)
class ModelSpec:
    """Model-side inputs a plan binds to (identity-compared, like JAX's).

    ``params`` is the CNN (its ``split`` ConvBN is the BaF forward layer),
    ``baf_params`` the BaF predictor for this C; both may be None for an
    encode/decode-only plan, whose ``restore`` then refuses.
    """
    sel_idx: Any                 # (C,) ordered selected-channel indices
    params: Any = None           # repro_torch.models.cnn.CNN
    baf_params: Any = None       # repro_torch.core.baf.BaFConv
    _plans: dict = field(default_factory=dict, init=False, repr=False)


@dataclass(frozen=True)
class WireBlob:
    """One request's serialized container plus plan-level metadata."""
    data: bytes
    op: OperatingPoint
    shape: tuple                 # codes shape, (B, H, W, C)
    stats: SplitStats | None = None

    @property
    def nbytes(self) -> int:
        return len(self.data)

    def to_tensor(self) -> wire.EncodedTensor:
        """Parse back to the wire-format view (header validation included)."""
        return wire.EncodedTensor.from_bytes(self.data)


@dataclass
class DecodedBatch:
    """Stacked host decode output, restore-ready."""
    codes: np.ndarray            # (N, H, W, C) integer codes
    mins: np.ndarray             # (N, 1, 1, C) fp16
    maxs: np.ndarray             # (N, 1, 1, C) fp16

    def __len__(self) -> int:
        return self.codes.shape[0]

    def pad_to(self, target: int) -> "DecodedBatch":
        """Pad to a bucket size by repeating the last row (its outputs are
        dropped after the restore); the card sees only bucket shapes."""
        n = len(self)
        if target < n:
            raise ValueError(f"cannot pad {n} rows down to {target}")
        if target == n:
            return self
        reps = [1] * n
        reps[-1] += target - n
        return DecodedBatch(codes=np.repeat(self.codes, reps, axis=0),
                            mins=np.repeat(self.mins, reps, axis=0),
                            maxs=np.repeat(self.maxs, reps, axis=0))


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Bring several tensors to the host in ONE device-to-host copy.

    Their bytes are concatenated on their device, copied once, and split
    back into numpy arrays. Pass wider element types first so every view
    stays aligned.
    """
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        out.append(buf[off:off + n].view(_NP_DTYPES[t.dtype]).reshape(t.shape))
        off += n
    return out


class CompressionPlan:
    """Executable coding pipeline for one operating point. Build via
    :func:`compile` (cached on the spec), not directly."""

    def __init__(self, op: OperatingPoint, spec: ModelSpec, *,
                 fused: bool = True, consolidation: bool = True,
                 device=None):
        self.op = op.resolve()
        self.spec = spec
        self.fused = fused
        self.consolidation = consolidation
        self.device = resolve_device(device)
        sel = np.asarray(spec.sel_idx)
        if sel.ndim != 1 or sel.shape[0] != self.op.c:
            raise ValueError(
                f"operating point transmits C={self.op.c} channels but the "
                f"model spec selects {sel.shape}")
        if sel.size and (not np.issubdtype(sel.dtype, np.integer)
                         or sel.min() < 0
                         or len(np.unique(sel)) != sel.size):
            raise ValueError("sel_idx must be distinct non-negative integers")
        if spec.params is not None and sel.size and \
                sel.max() >= spec.params.cfg.split_p:
            raise ValueError(f"sel_idx reaches channel {int(sel.max())} of a "
                             f"{spec.params.cfg.split_p}-channel split")
        self._sel = torch.as_tensor(sel.astype(np.int32), device=self.device)
        self._order = channel_order(self._sel)   # the kernels' table
        wire.backend_wants_tiling(self.op.wire_backend)

    @property
    def trace_key(self) -> tuple:
        """What the restore's shapes and code path depend on (plus the batch
        bucket supplied at call time): plans with equal keys run the same
        kernels at the same shapes."""
        return (self.op.c, self.op.bits, self.fused, self.consolidation)

    def to_device(self, x) -> torch.Tensor:
        """A numpy array (copied) or tensor as float32 on the plan's device."""
        return to_device(x, self.device)

    # -- encode (edge side) -------------------------------------------------
    def _quantize(self, z):
        """z (B, H, W, P) -> codes (B, H, W, C) u8/u16, mins/maxs (B, C)
        fp16, all on the plan's device."""
        z = self.to_device(z).contiguous()
        b, h, w, p = z.shape
        with hooks.timed("pipeline.quantize"):
            codes, mins, maxs = quantize_fused(z.view(b, h * w, p),
                                               self.op.bits, self._sel,
                                               order=self._order)
        return codes.view(b, h, w, self.op.c), mins, maxs

    def quantize(self, z) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Quantize only -> host (codes, mins, maxs), side info (B,1,1,C)."""
        codes, mins, maxs = self._quantize(z)
        mins, maxs, codes = _to_host(mins, maxs, codes)
        b, c = mins.shape
        return codes, mins.reshape(b, 1, 1, c), maxs.reshape(b, 1, 1, c)

    def encode_codes(self, codes: np.ndarray, qp: QuantParams,
                     raw_bits: int | None = None,
                     counts: np.ndarray | None = None) -> WireBlob:
        """Tile + entropy-code host codes (B, H, W, C).

        ``counts`` (C, 2^bits), the per-channel symbol counts of ``codes``,
        spare the ``rans`` coder its own histogram.
        """
        with hooks.timed("pipeline.encode", backend=self.op.wire_backend):
            if self.op.tiling == "tiled":
                tiled = tile_batch(torch.from_numpy(codes)).numpy()
                stream = tiled.reshape(-1, tiled.shape[-1])
                counts = None          # the chunk layout of a tiled stream
            else:
                stream = codes
            enc = wire.encode(stream, qp, backend=self.op.wire_backend,
                              counts=counts)
            if raw_bits is None:
                raw_bits = int(np.prod(codes.shape)) * 32
            stats = SplitStats(
                total_bits=enc.total_bits(),
                payload_bits=8 * len(enc.payload),
                side_info_bits=8 * len(enc.side_info),
                raw_bits=raw_bits,
                entropy_bits=wire.empirical_entropy_bits(
                    codes, self.op.bits, counts),
                wire_bits=enc.wire_bits(),
            )
            return WireBlob(data=enc.to_bytes(), op=self.op,
                            shape=tuple(codes.shape), stats=stats)

    def encode(self, z) -> WireBlob:
        """Quantize/entropy-code the split activation ``z`` (B, H, W, P)."""
        codes, mins, maxs = self._quantize(z)
        if self.op.wire_backend == "rans" and 1 << self.op.bits <= MAX_NSYM:
            c = self.op.c
            with hooks.timed("pipeline.histogram"):
                counts = histogram(codes.view(-1, c), 1 << self.op.bits)
            counts, mins, maxs, codes = _to_host(counts, mins, maxs, codes)
            counts = counts.astype(np.int64)
        else:
            counts = None
            mins, maxs, codes = _to_host(mins, maxs, codes)
        qp = QuantParams(mins=mins, maxs=maxs, bits=self.op.bits)
        return self.encode_codes(codes, qp, counts=counts,
                                 raw_bits=int(np.prod(np.shape(z))) * 32)

    # -- decode (cloud side, host) ------------------------------------------
    def _check_blob(self, blob: WireBlob, shape: tuple) -> None:
        if blob.op.resolve() != self.op:
            raise ValueError(
                f"blob was encoded at {blob.op.resolve()}, this plan "
                f"executes {self.op}")
        if tuple(blob.shape) != shape:
            raise ValueError(
                f"mixed shapes in one decode batch: {blob.shape} vs {shape}")

    def decode(self, blob: WireBlob) -> DecodedBatch:
        """Single-blob decode (= ``decode_batch([blob])``)."""
        return self.decode_batch([blob])

    def decode_batch(self, blobs: "list[WireBlob]") -> DecodedBatch:
        """Vectorized host decode across N same-shape requests, bit-exact
        with per-request decode, in input order."""
        if not blobs:
            raise ValueError("decode_batch needs at least one blob")
        with hooks.timed("pipeline.decode_batch",
                         backend=self.op.wire_backend):
            hooks.observe("pipeline_decode_batch_size", len(blobs))
            shape = tuple(blobs[0].shape)
            for blob in blobs:
                self._check_blob(blob, shape)
            encs = [wire.EncodedTensor.from_bytes(b.data) for b in blobs]
            streams, qps = wire.decode_many(encs)
            n = len(blobs)
            b, h, w, c = shape
            if self.op.tiling == "tiled":
                rows, cols = tile_grid(c)
                codes = untile_batch(torch.from_numpy(
                    streams.reshape(n * b, rows * h, cols * w)), c)
                codes = codes.contiguous().numpy()
            else:
                codes = streams.reshape(n * b, h, w, c)
            mins = np.stack([np.asarray(qp.mins, np.float16) for qp in qps])
            maxs = np.stack([np.asarray(qp.maxs, np.float16) for qp in qps])
            return DecodedBatch(codes=codes,
                                mins=mins.reshape(n * b, 1, 1, c),
                                maxs=maxs.reshape(n * b, 1, 1, c))

    # -- restore (cloud side, device) ---------------------------------------
    def restore(self, decoded: DecodedBatch) -> torch.Tensor:
        """Dequantize + BaF restore on the plan's device -> z~ (N, H, W, P)."""
        if self.spec.params is None or self.spec.baf_params is None:
            raise ValueError(
                "plan was compiled without model weights (encode/decode "
                "only); supply params and baf_params in the ModelSpec "
                "to restore")
        with hooks.timed("pipeline.restore", fused=self.fused):
            codes = torch.from_numpy(
                np.ascontiguousarray(decoded.codes)).to(self.device)
            mins = torch.from_numpy(decoded.mins).to(self.device)
            maxs = torch.from_numpy(decoded.maxs).to(self.device)
            split = self.spec.params.split
            if self.fused:
                return restore_codes_fused(self.spec.baf_params, split,
                                           self._sel, codes, mins, maxs,
                                           bits=self.op.bits,
                                           order=self._order)
            return restore_codes(self.spec.baf_params, split, self._sel,
                                 codes, mins, maxs, bits=self.op.bits,
                                 consolidation=self.consolidation)

    def __repr__(self) -> str:
        return (f"CompressionPlan(op={self.op}, fused={self.fused}, "
                f"consolidation={self.consolidation}, device={self.device})")


def blob_from_tensor(enc: wire.EncodedTensor, op: OperatingPoint,
                     batch: int) -> WireBlob:
    """Wrap a parsed wire tensor as a plan blob.

    The container's ``shape`` field stores the coded *stream* shape (the
    tiled 2D image for image-style backends), so the codes shape is
    rebuilt from the operating point's tiling grid.
    """
    rop = op.resolve()
    if rop.tiling == "tiled":
        rows, cols = tile_grid(rop.c)
        th, tw = enc.shape
        shape = (batch, th // (batch * rows), tw // cols, rop.c)
    else:
        shape = tuple(enc.shape)
    return WireBlob(data=enc.to_bytes(), op=rop, shape=shape)


def compile(op: OperatingPoint, model_spec: ModelSpec, *,   # noqa: A001
            fused: bool = True, consolidation: bool = True,
            device=None) -> CompressionPlan:
    """Build (or fetch the cached) plan for ``op`` on ``device`` (``None`` =
    the card), cached on the spec per (resolved op, flags, device)."""
    op = op.resolve()
    dev = resolve_device(device)
    key = (op, fused, consolidation, dev)
    plan = model_spec._plans.get(key)
    if plan is None:
        plan = CompressionPlan(op, model_spec, fused=fused,
                               consolidation=consolidation, device=dev)
        model_spec._plans[key] = plan
    return plan
