"""Cross-container batched rANS decode — chunk-level interleave.

``decode_many`` used to fall back to a per-blob loop for the rANS backends:
each container's chunks decode one after another, and every chunk pays the
full python-loop overhead of its ``steps = count / lanes`` interleave steps
at a vector width of only ``lanes`` (often 2-8 on small BaF tiles). A
micro-batch bucket of N same-shape containers therefore runs
``N * C * steps`` tiny numpy dispatches.

This module coalesces the interleave across *all* chunks of *all*
containers in the batch: chunks with identical coding geometry (lanes,
probability resolution, symbol count, context distance) stack into one
``(M, lanes)`` state matrix and the decode loop runs ``steps`` iterations
total at vector width ``M * lanes`` — each chunk still consumes its own
word stream through a per-row pointer, so outputs are bit-identical to the
per-blob decoder (the batched pipeline's hard invariant).

Static-table chunks and adaptive-context chunks batch separately; within
the adaptive group the per-chunk adaptation state (context counts, tables)
carries a leading batch axis and refreshes on the same schedule as the
scalar model, so encoder/decoder symmetry is preserved by construction.

All integrity checks of the scalar path run here too: container/chunk CRCs
(via ``RansContainer.chunk_parts``), word-stream exhaustion, and the
lane-state return-to-initial check, each raising :class:`CorruptStream`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.codec import container as box
from repro_torch.codec import context as ctx
from repro_torch.codec.backend import _chunk_layout
from repro_torch.codec.rans import RANS_L, WORD_BITS, CorruptStream, RansTable
from repro_torch.obs import hooks

_U64 = np.uint64


def _pad_words(jobs_words: "list[bytes]") -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged word streams -> (padded (M, W) uint16, lengths (M,))."""
    rows = [np.frombuffer(w, "<u2") for w in jobs_words]
    wlen = np.array([r.size for r in rows], np.int64)
    out = np.zeros((len(rows), int(wlen.max()) if len(rows) else 0),
                   np.uint16)
    for r, row in enumerate(rows):
        out[r, :row.size] = row
    return out, wlen


def _renorm(x, need, words, ptr, wlen):
    """One shared renormalization step: rows gather their own next words."""
    nneed = need.sum(axis=1)
    if nneed.any():
        if np.any(ptr + nneed > wlen):
            bad = int(np.argmax(ptr + nneed > wlen))
            raise CorruptStream(
                f"rANS word stream truncated in batch row {bad}: needed "
                f"{int(ptr[bad] + nneed[bad])} words, have {int(wlen[bad])}")
        idx = ptr[:, None] + np.cumsum(need, axis=1) - 1
        rowi = np.arange(x.shape[0])[:, None]
        w = words[rowi, np.where(need, idx, 0)]
        x = np.where(need, (x << _U64(WORD_BITS)) | w.astype(_U64), x)
        ptr += nneed
    return x, ptr


def _finish_checks(x, ptr, wlen):
    if np.any(ptr != wlen):
        bad = int(np.argmax(ptr != wlen))
        raise CorruptStream(
            f"rANS word stream has {int(wlen[bad] - ptr[bad])} unread "
            f"trailing words in batch row {bad}")
    if not bool(np.all(x == _U64(RANS_L))):
        raise CorruptStream(
            "rANS lane states did not return to initial value "
            "(corrupt payload)")


def _slot_lookup(slot: np.ndarray, cums_rows: np.ndarray) -> np.ndarray:
    """Slot -> symbol without materializing 2^prob_bits lookup tables.

    ``cums_rows`` is each row's exclusive cumulative-frequency array; the
    decoded symbol is the last one whose cum <= slot. The scalar coder
    answers this with a ``(1 << prob_bits)``-entry table — thousands of
    entries per symbol decoded on small tiles, the dominant cost of the
    per-blob loop. The broadcast count over the S-symbol alphabet is
    bit-identical and O(S) per lane instead of O(2^prob_bits) per table."""
    return (np.sum(slot[..., None] >= cums_rows, axis=-1) - 1).astype(
        np.int64)


def _decode_static_group(jobs, count: int, prob_bits: int,
                         lanes: int) -> np.ndarray:
    """jobs: [(states, words bytes, freq table (S,) array)] -> (M, count)."""
    m = len(jobs)
    steps = -(-count // lanes)
    tables = [RansTable(freqs=np.asarray(t, np.uint32), prob_bits=prob_bits)
              for _, _, t in jobs]
    freqs = np.stack([t.freqs for t in tables]).astype(_U64)
    cums = np.stack([t.cum for t in tables]).astype(_U64)
    x = np.stack([np.asarray(s) for s, _, _ in jobs]).astype(_U64)
    words, wlen = _pad_words([w for _, w, _ in jobs])
    mask = _U64((1 << prob_bits) - 1)
    pb = _U64(prob_bits)
    ptr = np.zeros(m, np.int64)
    rowi = np.arange(m)[:, None]
    out = np.empty((m, steps * lanes), np.uint32)
    cums_b = cums[:, None, :]                      # (M, 1, S) for the lookup
    for t in range(steps):
        slot = x & mask
        s = _slot_lookup(slot, cums_b)
        out[:, t * lanes:(t + 1) * lanes] = s
        x = freqs[rowi, s] * (x >> pb) + slot - cums[rowi, s]
        x, ptr = _renorm(x, x < _U64(RANS_L), words, ptr, wlen)
    _finish_checks(x, ptr, wlen)
    return out[:, :count]


def _decode_adaptive_group(jobs, count: int, bits: int, lanes: int,
                           neighbor_dist: int) -> np.ndarray:
    """jobs: [(states, words bytes)] -> (M, count), adaptive context model.

    The batch axis rides in front of the scalar model's state
    (``counts/freqs/cums/slot_tables``); adaptation math and the refresh
    schedule are the scalar model's, row for row, so every row decodes
    exactly as the per-blob path would."""
    m = len(jobs)
    neighbor_dist = ctx._normalize_neighbor(lanes, neighbor_dist)
    steps = -(-count // lanes)
    nsym = 1 << bits
    nctx = ctx._n_ctx(bits)
    shift = ctx._ctx_shift(bits)
    prob_bits = ctx.ctx_prob_bits(bits)
    refresh_every = max(1, ctx.REFRESH_SYMBOLS // lanes)
    counts = np.ones((m, nctx, nsym), np.int64)
    freqs = np.empty((m, nctx, nsym), np.uint64)
    cums = np.empty((m, nctx, nsym), np.uint64)

    def rebuild_freqs():
        # the scalar model's own rebuild, once per batch row — adaptation
        # math stays single-sourced in repro_torch.codec.context
        for r in range(m):
            ctx.rebuild_tables(counts[r], prob_bits, freqs[r], cums[r])

    rebuild_freqs()
    x = np.stack([np.asarray(s) for s, _ in jobs]).astype(_U64)
    words, wlen = _pad_words([w for _, w in jobs])
    mask = _U64((1 << prob_bits) - 1)
    pb = _U64(prob_bits)
    ptr = np.zeros(m, np.int64)
    rowi = np.arange(m)[:, None]
    base = np.arange(lanes, dtype=np.int64)
    out = np.empty((m, steps * lanes), np.uint32)
    for t in range(steps):
        if t and ctx.refresh_due(t, refresh_every):
            rebuild_freqs()
        idx = t * lanes + base
        if neighbor_dist < 1:
            cxv = np.full((m, lanes), nctx - 1, np.int64)
        else:
            nb = idx - neighbor_dist
            has = nb >= 0
            cxv = np.full((m, lanes), nctx - 1, np.int64)
            cxv[:, has] = out[:, nb[has]].astype(np.int64) >> shift
        slot = x & mask
        s = _slot_lookup(slot, cums[rowi, cxv])
        x = freqs[rowi, cxv, s] * (x >> pb) + slot - cums[rowi, cxv, s]
        x, ptr = _renorm(x, x < _U64(RANS_L), words, ptr, wlen)
        out[:, idx] = s
        np.add.at(counts, (rowi, cxv, s), ctx.COUNT_INCREMENT)
    _finish_checks(x, ptr, wlen)
    return out[:, :count]


def decode_tensor_batch(payloads: "list[bytes]", shape: tuple,
                        bits: int) -> np.ndarray:
    """Decode N same-shape containers -> (N, prod(shape)) channel-last rows.

    The backend's ``decode_batch`` hook (core/codec.py registry): output
    row i equals ``decode_tensor(payloads[i], shape, bits).ravel()`` bit for
    bit, but all compatible chunks across the whole batch share one
    interleaved decode loop."""
    with hooks.timed("codec.decode_batch"):
        return _decode_tensor_batch(payloads, shape, bits)


def _decode_tensor_batch(payloads: "list[bytes]", shape: tuple,
                         bits: int) -> np.ndarray:
    shape = tuple(shape)
    n_ch, k, _ = _chunk_layout(shape)
    count_total = int(np.prod(shape)) if shape else 1
    conts = [box.RansContainer.parse(p) for p in payloads]
    for cont in conts:
        h = cont.header
        if h.bits != bits:
            raise CorruptStream(
                f"container codes {h.bits} bits, wire header says {bits}")
        if h.n_chunks != n_ch:
            raise CorruptStream(
                f"container has {h.n_chunks} tile chunks, shape {shape} "
                f"needs {n_ch}")
        # symbol-count validation runs before the zero-size shortcut, like
        # the scalar decoder — a chunk claiming symbols for an empty shape
        # is corrupt, not ignorable
        for j in range(h.n_chunks):
            if cont.chunk_count(j) != k:
                raise CorruptStream(
                    f"chunk {j} holds {cont.chunk_count(j)} symbols, "
                    f"shape {shape} needs {k}")
    n = len(conts)
    if n_ch == 0 or k == 0:
        return np.zeros((n, count_total), np.uint32)
    mats = np.empty((n, n_ch, k), np.uint32)
    # group chunks by coding geometry; each group shares one decode loop
    static_groups: dict = {}
    adaptive_groups: dict = {}
    for i, cont in enumerate(conts):
        h = cont.header
        for j in range(h.n_chunks):
            _count, states, words = cont.chunk_parts(j)   # CRC-verified
            if h.mode == box.MODE_STATIC:
                key = (h.prob_bits, h.lanes)
                static_groups.setdefault(key, []).append(
                    ((i, j), (states, words, cont.chunk_table(j))))
            else:
                key = (h.lanes, h.neighbor_dist)
                adaptive_groups.setdefault(key, []).append(
                    ((i, j), (states, words)))
    trace_lanes = hooks.enabled()
    for (prob_bits, lanes), entries in static_groups.items():
        if trace_lanes:
            # effective interleave width: all grouped chunks' lanes decode
            # in one vector pass (the whole point of the batched path)
            hooks.observe("codec_rans_batch_width", len(entries) * lanes,
                          mode="static")
        rows = _decode_static_group([job for _, job in entries], k,
                                    prob_bits, lanes)
        for (i, j), row in zip((pos for pos, _ in entries), rows):
            mats[i, j] = row
    for (lanes, neighbor), entries in adaptive_groups.items():
        if trace_lanes:
            hooks.observe("codec_rans_batch_width", len(entries) * lanes,
                          mode="adaptive")
        rows = _decode_adaptive_group([job for _, job in entries], k, bits,
                                      lanes, neighbor)
        for (i, j), row in zip((pos for pos, _ in entries), rows):
            mats[i, j] = row
    # channel-last reassembly, one transpose over the whole stack
    return np.ascontiguousarray(
        mats.transpose(0, 2, 1)).reshape(n, count_total)
