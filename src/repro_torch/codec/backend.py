"""Tensor-level rANS backends for the wire codec (core/codec.py registry).

Maps a channel-last code tensor onto the container's per-tile chunks:

  * chunk i = channel i's symbols in raster order over the leading axes
    (for a (B, H, W, C) BaF residual tensor: all of channel i, batch-major);
  * ``neighbor_dist = shape[-2]`` so the adaptive model's lane-strided
    context is exactly the up-neighbor inside each tile row structure;
  * ``rans``     — static per-channel frequency tables. Symbol statistics
    are the per-channel counts the caller measured where the codes were
    made (the histogram kernel on the card, see pipeline/plan.py), or, when
    none are passed, the plain histogram of the host codes; tables
    travel in the container's zlib'd table blob. Encoder picks per-channel
    tables or one shared pooled table, whichever yields fewer wire bytes
    (small tiles can't amortize C tables) — the choice is recorded per
    container by simply repeating the pooled table, so the decoder never
    special-cases it.
  * ``rans-ctx`` — context-adaptive, nothing transmitted but lane states.

Unlike the image-codec backends, rANS needs no tiled 2D image: the tensor is
coded directly and the tiling step is skipped (core/split.py).
"""
from __future__ import annotations

import zlib

import numpy as np

from repro_torch.codec import container as box
from repro_torch.codec import context as ctx
from repro_torch.obs import hooks
from repro_torch.codec.rans import (MAX_PROB_BITS, CorruptStream, RansTable,
                              encode_static, normalize_freqs)

MAX_BITS = 12                # slot tables are 2^prob_bits; keep them sane
STATIC_LANES = 32
PROB_BITS_STATIC = 14


def _chunk_layout(shape: tuple) -> tuple[int, int, int]:
    """(n_chunks, symbols per chunk, up-neighbor distance) for a shape.

    Channel-last for >= 2-D tensors; a 1-D/0-D stream is a SINGLE chunk
    (treating each element of a flat array as its own channel would emit a
    chunk header + lane states per element — a 14x blowup).
    """
    if len(shape) >= 2:
        c = shape[-1]
        k = int(np.prod(shape[:-1]))
        return c, k, shape[-2]
    k = shape[0] if shape else 1
    return (1 if k else 0), k, 0


def _as_symbol_matrix(codes: np.ndarray, bits: int) -> tuple[np.ndarray, int]:
    """(..., C) -> (C, K) uint32 symbol streams + up-neighbor distance."""
    arr = np.asarray(codes)
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"rans backends support 1..{MAX_BITS} bits, "
                         f"got {bits}")
    if arr.size:
        amin, amax = int(arr.min()), int(arr.max())
        if amin < 0:
            raise ValueError(f"rans backend: negative code {amin}")
        if amax >= 1 << bits:
            raise ValueError(f"rans backend: code {amax} does not fit "
                             f"{bits} bits")
    c, _k, neighbor = _chunk_layout(arr.shape)
    mat = arr.reshape(-1, c).T.astype(np.uint32) if c else \
        np.empty((0, 0), np.uint32)
    return np.ascontiguousarray(mat), neighbor


def _expected_payload_bits(counts: np.ndarray, tables: list[RansTable],
                           prob_bits: int) -> float:
    """Cross-entropy estimate of the coded size of each chunk under its
    table: sum_s counts[s] * (prob_bits - log2(freq[s])). rANS realizes
    this within ~1%, which is plenty to pick a table layout without coding."""
    total = 0.0
    for i, t in enumerate(tables):
        f = t.freqs.astype(np.float64)
        total += float(np.sum(counts[i] * (prob_bits - np.log2(f))))
    return total


def encode_static_tensor(codes: np.ndarray, bits: int,
                         counts: np.ndarray | None = None) -> bytes:
    """The ``rans`` backend: per-channel (or pooled) static tables.

    ``counts`` (C, 2^bits): per-channel symbol counts of ``codes`` already
    measured by the caller; None counts them here, on the host.
    """
    with hooks.timed("codec.encode", mode="static"):
        return _encode_static_tensor(codes, bits, counts)


def _encode_static_tensor(codes: np.ndarray, bits: int,
                          counts: np.ndarray | None) -> bytes:
    mat, _ = _as_symbol_matrix(codes, bits)
    n_ch, k = mat.shape
    if counts is None:
        from repro_torch.kernels.histogram import channel_histogram
        counts = channel_histogram(mat.T, bits)   # (K, C): chunk layout
    counts = np.asarray(counts, np.int64)
    if counts.shape != (n_ch, 1 << bits):
        raise ValueError(f"counts of shape {counts.shape} do not fit "
                         f"{n_ch} channels at {bits} bits")

    # scale lanes with the chunk's expected *compressed* size: each lane
    # costs 4 bytes of state on the wire, so a heavily skewed (low-entropy)
    # chunk takes fewer lanes — target <= ~6% state overhead — while long
    # high-entropy chunks take the full vector width
    total = counts.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = counts / np.maximum(total, 1)
        ent_bits = float(-(counts * np.where(p > 0, np.log2(p, where=p > 0),
                                             0.0)).sum())
    payload_guess = max(1, int(ent_bits / 8) // max(n_ch, 1))
    lanes = max(1, min(STATIC_LANES, k // 32 or 1, payload_guess // 64 or 1))
    if hooks.enabled():
        # lane occupancy: interleave width per chunk and symbols each lane
        # carries — how well the chunk fills the SIMD decode loop
        hooks.observe("codec_rans_lanes", lanes, mode="static")
        hooks.observe("codec_rans_lane_occupancy", k / lanes, mode="static")
    prob_bits = min(MAX_PROB_BITS, max(PROB_BITS_STATIC, bits + 2))
    if n_ch == 0 or k == 0:
        chunks = [(0, np.full(lanes, ctx.RANS_L, "<u4"), b"")] * n_ch
        tables = [normalize_freqs(np.ones(1 << bits), prob_bits)] * n_ch
        return box.pack_container(
            mode=box.MODE_STATIC, bits=bits, prob_bits=prob_bits,
            lanes=lanes, neighbor_dist=0, tables=tables, chunks=chunks)

    def build(tables: list[RansTable]):
        chunks = []
        for i in range(n_ch):
            states, words = encode_static(mat[i], tables[i], lanes)
            chunks.append((k, states, words))
        return box.pack_container(
            mode=box.MODE_STATIC, bits=bits, prob_bits=prob_bits,
            lanes=lanes, neighbor_dist=0,
            tables=[t.freqs for t in tables], chunks=chunks)

    per_channel = [RansTable.from_counts(counts[i], prob_bits)
                   for i in range(n_ch)]
    tables = per_channel
    if n_ch > 1:
        # pick the table layout BEFORE coding: compare the cross-entropy
        # payload estimate plus the zlib'd table blob each layout transmits
        # (small tiles cannot amortize C tables), then code once
        pooled = RansTable.from_counts(counts.sum(axis=0), prob_bits)
        pooled_tables = [pooled] * n_ch

        def table_blob_bits(ts):
            raw = np.concatenate([t.freqs.astype("<u2") for t in ts])
            return 8 * len(zlib.compress(raw.tobytes(), 9))

        cost_per = (_expected_payload_bits(counts, per_channel, prob_bits)
                    + table_blob_bits(per_channel))
        cost_pool = (_expected_payload_bits(counts, pooled_tables, prob_bits)
                     + table_blob_bits(pooled_tables))
        if cost_pool < cost_per:
            tables = pooled_tables
    return build(tables)


def encode_adaptive_tensor(codes: np.ndarray, bits: int) -> bytes:
    """The ``rans-ctx`` backend: adaptive up-neighbor/channel context."""
    with hooks.timed("codec.encode", mode="adaptive"):
        return _encode_adaptive_tensor(codes, bits)


def _encode_adaptive_tensor(codes: np.ndarray, bits: int) -> bytes:
    mat, neighbor = _as_symbol_matrix(codes, bits)
    n_ch, k = mat.shape
    lanes = ctx.plan_lanes(k, neighbor)
    if hooks.enabled() and k:
        hooks.observe("codec_rans_lanes", lanes, mode="adaptive")
        hooks.observe("codec_rans_lane_occupancy", k / lanes,
                      mode="adaptive")
    chunks = []
    for i in range(n_ch):
        states, words = ctx.encode_ctx(mat[i], bits, lanes, neighbor)
        chunks.append((k, states, words))
    return box.pack_container(
        mode=box.MODE_ADAPTIVE, bits=bits, prob_bits=ctx.ctx_prob_bits(bits),
        lanes=lanes, neighbor_dist=neighbor, tables=None, chunks=chunks)


def decode_tensor(payload: bytes, shape: tuple, bits: int) -> np.ndarray:
    """Decode a container back to the channel-last code tensor ``shape``."""
    with hooks.timed("codec.decode"):
        return _decode_tensor(payload, shape, bits)


def _decode_tensor(payload: bytes, shape: tuple, bits: int) -> np.ndarray:
    cont = box.RansContainer.parse(payload)
    h = cont.header
    if h.bits != bits:
        raise CorruptStream(
            f"container codes {h.bits} bits, wire header says {bits}")
    n_ch, k, _ = _chunk_layout(tuple(shape))
    if h.n_chunks != n_ch:
        raise CorruptStream(
            f"container has {h.n_chunks} tile chunks, shape {shape} "
            f"needs {n_ch}")
    for i in range(n_ch):
        if cont.chunk_count(i) != k:
            raise CorruptStream(
                f"chunk {i} holds {cont.chunk_count(i)} symbols, shape "
                f"{shape} needs {k}")
    if n_ch == 0 or k == 0:
        return np.zeros(shape, np.uint32)
    mat = cont.decode_all()                        # (C, K)
    return mat.T.reshape(shape)


def decode_channels(payload: bytes, indices, count: int | None = None
                    ) -> np.ndarray:
    """Partial decode of selected tile chunks -> (len(indices), K)."""
    cont = box.RansContainer.parse(payload)
    out = cont.decode_channels(indices)
    if count is not None and out.size and out.shape[1] != count:
        raise CorruptStream(
            f"chunks hold {out.shape[1]} symbols, expected {count}")
    return out
