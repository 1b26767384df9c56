"""Lossless wire codec for quantized/tiled tensors — host-side by design.

Copy of ``repro/core/codec.py`` for the port: the same backends, the same
BaF2 container, the same bytes. The context-adaptive interleaved rANS
subsystem in ``repro_torch.codec`` sits behind a backend registry so every
caller keeps the same ``encode``/``decode`` API:

  * ``rans``     — interleaved multi-stream rANS with static per-channel
                   frequency tables (histogram kernel on the card, or the
                   caller's host counts -> host coding pass); per-tile
                   chunks, partial decode.
  * ``rans-ctx`` — the same coder with an adaptive quantized-up-neighbor /
                   channel context model; nothing transmitted but lane
                   states, typically at or below the order-0 entropy floor
                   on BaF residual tiles.
  * ``zlib``     — DEFLATE over n-bit-packed codes (legacy default).
  * ``png``      — PIL PNG for 8-bit tiled images (the codec of prior
                   work [3]).
  * ``raw``      — n-bit packing only (no entropy coding).

plus :func:`empirical_entropy_bits` as a codec-independent order-0 floor.

The rANS backends code the channel-last code tensor directly (their
container is documented in ``repro_torch/codec/container.py``); the
image-style backends expect the pre-tiled 2D stream — ``backend_wants_tiling``
tells ``pipeline/plan.py`` which detour to take.

Wire format (``EncodedTensor.to_bytes``): ``BaF2`` magic, backend id, bit
depth, shape, explicit side-info and payload lengths. ``from_bytes``
validates structurally — bad magic, unknown backend, every truncation, and
trailing garbage each raise a distinct ``ValueError`` — so corrupt blobs
fail at the header, not deep inside ``unpack_bits``.

Bit accounting follows the paper: ``total_bits`` counts payload + C*32 bits
of fp16 min/max side info; ``wire_bits`` additionally counts the container
header — the number the serving channel/scheduler actually meter.
"""
from __future__ import annotations

import io
import struct
import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

import torch

from repro_torch.core.quant import QuantParams

MAGIC = b"BaF2"
_OLD_MAGICS = (b"BaF1",)


# ---------------------------------------------------------------------------
# n-bit packing
# ---------------------------------------------------------------------------

def pack_bits(codes: np.ndarray, bits: int) -> bytes:
    """Pack integer codes (values < 2^bits) into a dense little-endian bitstream."""
    flat = np.asarray(codes, dtype=np.uint64).ravel()
    if bits == 8:
        return flat.astype(np.uint8).tobytes()
    if bits == 16:
        # explicit little-endian, matching unpack's '<u2' view — the wire
        # format must not depend on host byte order
        return flat.astype("<u2").tobytes()
    n = flat.size
    total_bits = n * bits
    out = np.zeros((total_bits + 7) // 8, dtype=np.uint8)
    positions = np.arange(n, dtype=np.uint64) * bits
    for b in range(bits):
        bitpos = positions + b
        byte_idx = (bitpos >> 3).astype(np.int64)
        bit_in_byte = (bitpos & 7).astype(np.uint8)
        vals = ((flat >> np.uint64(b)) & np.uint64(1)).astype(np.uint8)
        np.bitwise_or.at(out, byte_idx, vals << bit_in_byte)
    return out.tobytes()


def unpack_bits(data: bytes, bits: int, count: int) -> np.ndarray:
    return unpack_bits_batch([data], bits, count)[0]


def unpack_bits_batch(streams: list[bytes], bits: int,
                      count: int) -> np.ndarray:
    """Unpack N equal-length bitstreams in one vectorized pass -> (N, count).

    Every stream packs exactly ``count`` codes at ``bits`` each (all wire
    payloads of one micro-batch bucket share an operating point and shape),
    so the per-bit gather loop runs ``bits`` times *total* instead of
    ``bits`` times per request — the coalesced host decode the batched
    pipeline (repro_torch.pipeline) is built on.
    """
    n = len(streams)
    need = (count * bits + 7) // 8
    for i, s in enumerate(streams):
        if len(s) < need:
            raise ValueError(
                f"bitstream {i} too short: {len(s)} bytes but {count} codes "
                f"at {bits} bits need {need}")
    buf = np.stack([np.frombuffer(s, dtype=np.uint8, count=need)
                    for s in streams]) if n else np.empty((0, need), np.uint8)
    if bits == 8:
        return buf[:, :count].copy()
    if bits == 16:
        return np.ascontiguousarray(buf[:, :2 * count]).view("<u2")[:, :count]
    out = np.zeros((n, count), dtype=np.uint32)
    positions = np.arange(count, dtype=np.uint64) * bits
    for b in range(bits):
        bitpos = positions + b
        byte_idx = (bitpos >> 3).astype(np.int64)
        bit_in_byte = (bitpos & 7).astype(np.uint8)
        vals = (buf[:, byte_idx] >> bit_in_byte) & 1
        out |= vals.astype(np.uint32) << b
    return out


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Backend:
    name: str
    wire_id: int
    tiled: bool        # expects the pre-tiled 2D image (pipeline/plan.py)
    encode: Callable   # (codes, bits, level, counts) -> payload bytes;
                       # counts: per-channel histogram or None (rans only)
    decode: Callable   # (payload, shape, bits, count) -> flat/shaped codes
    # optional coalesced decode across N same-shape payloads:
    # (payloads, shape, bits, count) -> (N, count) codes. None = the batched
    # pipeline falls back to a per-payload loop over ``decode``.
    decode_batch: Callable | None = None


_REGISTRY: dict[str, _Backend] = {}
_BY_ID: dict[int, str] = {}
# name -> registrar called on first use, so importing core.codec never pulls
# in the rANS subsystem; populated at module bottom
_LAZY: dict[str, Callable[[], None]] = {}


def register_backend(name: str, wire_id: int, *, tiled: bool,
                     encode: Callable, decode: Callable,
                     decode_batch: Callable | None = None) -> None:
    if name in _REGISTRY:
        raise ValueError(f"backend {name!r} already registered")
    if wire_id in _BY_ID:
        raise ValueError(f"wire id {wire_id} already taken by "
                         f"{_BY_ID[wire_id]!r}")
    _REGISTRY[name] = _Backend(name=name, wire_id=wire_id, tiled=tiled,
                               encode=encode, decode=decode,
                               decode_batch=decode_batch)
    _BY_ID[wire_id] = name


def _get_backend(name: str) -> _Backend:
    if name not in _REGISTRY and name in _LAZY:
        _LAZY[name]()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{sorted(set(_REGISTRY) | set(_LAZY))}") from None


def backend_wants_tiling(name: str) -> bool:
    """Does this backend expect the channels tiled into a 2D image?"""
    return _get_backend(name).tiled


# -- built-in backends ------------------------------------------------------

def _zlib_encode(codes, bits, level, counts):
    return zlib.compress(pack_bits(codes, bits), level)


def _zlib_decode(payload, shape, bits, count):
    return unpack_bits(zlib.decompress(payload), bits, count)


def _zlib_decode_batch(payloads, shape, bits, count):
    return unpack_bits_batch([zlib.decompress(p) for p in payloads],
                             bits, count)


def _raw_encode(codes, bits, level, counts):
    return pack_bits(codes, bits)


def _raw_decode(payload, shape, bits, count):
    return unpack_bits(payload, bits, count)


def _raw_decode_batch(payloads, shape, bits, count):
    return unpack_bits_batch(list(payloads), bits, count)


def _png_encode(codes, bits, level, counts):
    from PIL import Image
    if bits > 8:
        raise ValueError("png backend supports <=8 bits")
    if codes.size and codes.min() < 0:
        raise ValueError("png backend: negative codes are invalid")
    if codes.size and codes.max() > 255:
        raise ValueError(
            f"png backend: codes up to {int(codes.max())} do not fit in "
            "8 bits")
    img = codes.astype(np.uint8)
    if img.ndim != 2:
        raise ValueError("png backend expects a 2D tiled image")
    buf = io.BytesIO()
    Image.fromarray(img, mode="L").save(buf, format="PNG", optimize=True)
    return buf.getvalue()


def _png_decode(payload, shape, bits, count):
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(payload)))
    return img.ravel()[:count]


register_backend("zlib", 0, tiled=True, encode=_zlib_encode,
                 decode=_zlib_decode, decode_batch=_zlib_decode_batch)
register_backend("png", 1, tiled=True, encode=_png_encode,
                 decode=_png_decode)
register_backend("raw", 2, tiled=True, encode=_raw_encode,
                 decode=_raw_decode, decode_batch=_raw_decode_batch)


def _register_rans_backends() -> None:
    if "rans" in _REGISTRY:
        return
    from repro_torch.codec import (decode_tensor, encode_adaptive_tensor,
                                   encode_static_tensor)
    from repro_torch.codec.batch import decode_tensor_batch

    def _batch(payloads, shape, bits, count):
        # chunk-level interleave across the whole batch of containers —
        # one decode loop per coding geometry instead of one per blob
        return decode_tensor_batch(list(payloads), shape, bits)

    register_backend(
        "rans", 3, tiled=False,
        encode=lambda codes, bits, level, counts:
            encode_static_tensor(codes, bits, counts),
        decode=lambda payload, shape, bits, count:
            decode_tensor(payload, shape, bits),
        decode_batch=_batch)
    register_backend(
        "rans-ctx", 4, tiled=False,
        encode=lambda codes, bits, level, counts:
            encode_adaptive_tensor(codes, bits),
        decode=lambda payload, shape, bits, count:
            decode_tensor(payload, shape, bits),
        decode_batch=_batch)


_LAZY["rans"] = _register_rans_backends
_LAZY["rans-ctx"] = _register_rans_backends


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------

@dataclass
class EncodedTensor:
    payload: bytes          # entropy-coded channel codes
    backend: str            # registry name ('zlib'|'png'|'raw'|'rans'|...)
    bits: int
    shape: tuple            # original codes shape, channel-last
    side_info: bytes        # fp16 mins/maxs

    def total_bits(self) -> int:
        """Paper-style accounting: payload + C*32 side-info bits."""
        return 8 * (len(self.payload) + len(self.side_info))

    def header_bytes(self) -> int:
        return 7 + 4 * len(self.shape) + 8

    def wire_bits(self) -> int:
        """Everything that crosses the channel: header + side info + payload.

        This is what the serving channel meters and the scheduler budgets;
        ``total_bits`` stays the paper's (header-free) reporting quantity.
        """
        return 8 * (self.header_bytes() + len(self.side_info)
                    + len(self.payload))

    def to_bytes(self) -> bytes:
        hdr = struct.pack("<4sB B B", MAGIC,
                          _get_backend(self.backend).wire_id,
                          self.bits, len(self.shape))
        hdr += struct.pack(f"<{len(self.shape)}I", *self.shape)
        hdr += struct.pack("<II", len(self.side_info), len(self.payload))
        return hdr + self.side_info + self.payload

    @classmethod
    def from_bytes(cls, data: bytes) -> "EncodedTensor":
        if len(data) < 7:
            raise ValueError(
                f"truncated wire header: {len(data)} bytes, need >= 7")
        magic, backend_id, bits, ndim = struct.unpack_from("<4sB B B", data, 0)
        if magic in _OLD_MAGICS:
            raise ValueError(
                f"unsupported wire-format version {magic.decode('ascii', 'replace')} "
                f"(this build writes {MAGIC.decode('ascii')}; re-encode)")
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic!r}")
        if backend_id not in _BY_ID:
            # rans ids are lazily registered; resolve them before failing
            for lazy in _LAZY:
                _get_backend(lazy)
            if backend_id not in _BY_ID:
                raise ValueError(f"unknown backend id {backend_id}")
        off = 7
        if off + 4 * ndim + 8 > len(data):
            raise ValueError(
                f"truncated wire header: {ndim}-d shape + lengths need "
                f"{off + 4 * ndim + 8} bytes, have {len(data)}")
        shape = struct.unpack_from(f"<{ndim}I", data, off)
        off += 4 * ndim
        silen, plen = struct.unpack_from("<II", data, off)
        off += 8
        if off + silen > len(data):
            raise ValueError(
                f"truncated side info: header claims {silen} bytes, "
                f"{len(data) - off} remain")
        side_info = data[off:off + silen]
        off += silen
        if off + plen > len(data):
            raise ValueError(
                f"truncated payload: header claims {plen} bytes, "
                f"{len(data) - off} remain")
        payload = data[off:off + plen]
        off += plen
        if off != len(data):
            raise ValueError(
                f"{len(data) - off} bytes of trailing garbage after payload")
        return cls(payload=payload, backend=_BY_ID[backend_id], bits=bits,
                   shape=tuple(shape), side_info=side_info)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _pack_side_info(qp: QuantParams) -> bytes:
    mins = _host(qp.mins).astype(np.float16, copy=False)
    maxs = _host(qp.maxs).astype(np.float16, copy=False)
    return mins.tobytes() + maxs.tobytes()


def _unpack_side_info(data: bytes, bits: int) -> QuantParams:
    half = len(data) // 2
    mins = np.frombuffer(data[:half], dtype=np.float16)
    maxs = np.frombuffer(data[half:], dtype=np.float16)
    return QuantParams(mins=mins, maxs=maxs, bits=bits)


def encode(codes: np.ndarray, qp: QuantParams, backend: str = "zlib",
           level: int = 9, counts: np.ndarray | None = None) -> EncodedTensor:
    """Entropy-code quantized channel codes (any shape, channel-last).

    ``counts``: per-channel symbol counts (C, 2^bits) of ``codes`` when the
    caller already has them (the ``rans`` backend then skips its own
    histogram); other backends ignore it.
    """
    codes = np.asarray(codes)
    be = _get_backend(backend)
    payload = be.encode(codes, qp.bits, level, counts)
    return EncodedTensor(payload=payload, backend=backend, bits=qp.bits,
                         shape=tuple(codes.shape), side_info=_pack_side_info(qp))


def decode(enc: EncodedTensor) -> tuple[np.ndarray, QuantParams]:
    qp = _unpack_side_info(enc.side_info, enc.bits)
    count = int(np.prod(enc.shape)) if enc.shape else 1
    be = _get_backend(enc.backend)
    codes = np.asarray(be.decode(enc.payload, enc.shape, enc.bits, count))
    dtype = np.uint8 if enc.bits <= 8 else (np.uint16 if enc.bits <= 16 else np.uint32)
    return codes.astype(dtype).reshape(enc.shape), qp


def decode_many(encs: "list[EncodedTensor]") -> tuple[np.ndarray,
                                                      list[QuantParams]]:
    """Decode N same-(backend, bits, shape) tensors -> ((N, *shape), qps).

    The batched host-decode primitive behind ``repro_torch.pipeline``'s
    ``CompressionPlan.decode_batch``: backends that registered a
    ``decode_batch`` hook (zlib, raw) coalesce the per-payload numpy loops
    into one vectorized pass; the rest fall back to a per-payload loop but
    still hand the caller one stacked array.
    """
    if not encs:
        raise ValueError("decode_many needs at least one tensor")
    first = encs[0]
    for e in encs[1:]:
        if (e.backend, e.bits, e.shape) != (first.backend, first.bits,
                                            first.shape):
            raise ValueError(
                f"decode_many requires a homogeneous batch; got "
                f"({e.backend}, {e.bits}, {e.shape}) vs "
                f"({first.backend}, {first.bits}, {first.shape})")
    be = _get_backend(first.backend)
    count = int(np.prod(first.shape)) if first.shape else 1
    if be.decode_batch is not None:
        codes = np.asarray(be.decode_batch([e.payload for e in encs],
                                           first.shape, first.bits, count))
    else:
        codes = np.stack([
            np.asarray(be.decode(e.payload, e.shape, e.bits, count)).ravel()
            for e in encs])
    dtype = (np.uint8 if first.bits <= 8
             else (np.uint16 if first.bits <= 16 else np.uint32))
    codes = codes.astype(dtype, copy=False).reshape(
        (len(encs),) + tuple(first.shape))
    qps = [_unpack_side_info(e.side_info, e.bits) for e in encs]
    return codes, qps


def empirical_entropy_bits(codes: np.ndarray, bits: int,
                           counts: np.ndarray | None = None) -> float:
    """Order-0 empirical entropy of the code stream, in total bits.

    Codec-independent floor used in benchmarks to separate "what the
    quantizer achieved" from "what the entropy coder realized". With
    ``counts`` (C, 2^bits), the per-channel histogram of ``codes``, the
    pooled counts are their sum and the codes are not read again.
    """
    if counts is None:
        flat = np.asarray(codes).ravel()
        if flat.size == 0:
            return 0.0
        counts = np.bincount(flat.astype(np.int64), minlength=1 << bits)
    else:
        counts = np.asarray(counts, np.int64).sum(axis=0)
    n = int(counts.sum())
    if n == 0:
        return 0.0
    p = counts[counts > 0] / n
    return float(-np.sum(p * np.log2(p)) * n)
