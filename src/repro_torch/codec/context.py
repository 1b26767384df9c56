"""Context-adaptive rANS modeling for BaF residual tiles.

The static backend transmits one frequency table per channel; for small
tiles that table blob dominates the payload. This model transmits *nothing*:
encoder and decoder run the same deterministic adaptation, so the only
per-chunk overhead is the lane states.

Model
-----
  * context = the quantized **up-neighbor**: the symbol one tile row above,
    bucketed to its top ``CTX_BITS`` bits (BaF residual tiles are spatially
    smooth, so the up-neighbor's coarse magnitude is a strong predictor of
    the current symbol's distribution), plus one extra bucket for positions
    with no neighbor (first row / flat streams). Channels are separate
    chunks, so the model is per-channel by construction — the
    "quantized-neighbor/channel" context.
  * adaptation = per-context symbol counts start uniform and increment with
    every coded symbol; frequency tables are renormalized every
    ``refresh_every`` interleave steps (not every symbol) so table rebuilds
    amortize while the model still tracks local statistics.

Lane causality: with ``lanes <= neighbor_dist`` the up-neighbor of every
symbol in step t was decoded in a strictly earlier step, so the decoder can
compute all N lane contexts with one gather before decoding the step — the
same vectorized loop shape as the static coder. ``plan_lanes`` enforces
this; when the stream has no usable row structure the model degrades to a
single-context adaptive order-0 coder.
"""
from __future__ import annotations

import numpy as np

from repro_torch.codec.rans import (RANS_L, WORD_BITS, CorruptStream,
                              normalize_freqs, pad_to_lanes, rans_encode)

CTX_BITS = 2                 # context buckets = 2^CTX_BITS (+1 "no neighbor")
PROB_BITS_CTX = 12           # floor; see ctx_prob_bits
MAX_PROB_BITS_CTX = 15
DEFAULT_LANES = 8
REFRESH_SYMBOLS = 128        # rebuild tables roughly this often
COUNT_INCREMENT = 32         # adaptation speed: observed mass per symbol vs
                             # the uniform prior mass of 1 per alphabet entry

_U64 = np.uint64


def plan_lanes(count: int, neighbor_dist: int) -> int:
    """Lane count compatible with the up-neighbor context.

    Needs ``lanes <= neighbor_dist`` so contexts come from earlier steps;
    a degenerate ``neighbor_dist`` (< 2) keeps vector lanes but drops the
    neighbor context (callers pass neighbor_dist=0 then).
    """
    if count <= 0:
        return 1
    cap = neighbor_dist if neighbor_dist >= 2 else DEFAULT_LANES
    return max(1, min(DEFAULT_LANES, cap, count))


def ctx_prob_bits(bits: int) -> int:
    """Probability resolution for the adaptive model at this bit depth.

    Must exceed the alphabet size by a margin: at prob_bits == bits every
    frequency is pinned to the min of 1 (uniform — no compression at all),
    so wide alphabets get 2 extra bits of headroom. Encoder and decoder
    derive this identically from ``bits``; the container header records it.
    """
    return min(MAX_PROB_BITS_CTX, max(PROB_BITS_CTX, bits + 2))


def _n_ctx(bits: int) -> int:
    return (1 << min(CTX_BITS, bits)) + 1      # + the "no neighbor" bucket


def _ctx_shift(bits: int) -> int:
    return max(0, bits - CTX_BITS)


def refresh_due(t: int, refresh_every: int) -> bool:
    """Table-refresh schedule: exponential early (steps 1, 2, 4, 8, …) so
    the model escapes the uniform prior quickly, then periodic. ONE source
    of truth — the scalar model and the cross-container batch decoder
    (repro_torch.codec.batch) must refresh on identical steps or decode diverges
    from encode."""
    if t == 0:
        return False                     # initial tables already built
    if t < refresh_every:
        return t & (t - 1) == 0          # powers of two
    return t % refresh_every == 0


def rebuild_tables(counts: np.ndarray, prob_bits: int, freqs_out: np.ndarray,
                   cums_out: np.ndarray) -> None:
    """Renormalize per-context counts (nctx, nsym) into frequency +
    exclusive-cumulative tables, written in place. Shared by the scalar
    model and the batch decoder so the adaptation math cannot fork."""
    for cx in range(counts.shape[0]):
        f = normalize_freqs(counts[cx], prob_bits)
        freqs_out[cx] = f
        cums_out[cx] = np.cumsum(f, dtype=np.uint64) - f


class _AdaptiveModel:
    """Shared encoder/decoder adaptation state (identical on both sides)."""

    def __init__(self, bits: int, lanes: int):
        self.nsym = 1 << bits
        self.nctx = _n_ctx(bits)
        self.shift = _ctx_shift(bits)
        self.prob_bits = ctx_prob_bits(bits)
        self.counts = np.ones((self.nctx, self.nsym), np.int64)
        self.refresh_every = max(1, REFRESH_SYMBOLS // lanes)
        self.freqs = np.empty((self.nctx, self.nsym), np.uint32)
        self.cums = np.empty((self.nctx, self.nsym), np.uint32)
        self.rebuild()

    def rebuild(self) -> None:
        rebuild_tables(self.counts, self.prob_bits, self.freqs, self.cums)

    def refresh_due(self, t: int) -> bool:
        return refresh_due(t, self.refresh_every)

    def contexts(self, idx: np.ndarray, stream: np.ndarray,
                 neighbor_dist: int) -> np.ndarray:
        """Context bucket per symbol index, gathered from decoded history."""
        if neighbor_dist < 1:
            return np.full(idx.size, self.nctx - 1, np.int64)
        nb = idx - neighbor_dist
        has = nb >= 0
        ctx = np.full(idx.size, self.nctx - 1, np.int64)
        ctx[has] = stream[nb[has]].astype(np.int64) >> self.shift
        return ctx

    def update(self, ctx: np.ndarray, syms: np.ndarray) -> None:
        np.add.at(self.counts, (ctx, syms.astype(np.int64)), COUNT_INCREMENT)


def _normalize_neighbor(lanes: int, neighbor_dist: int) -> int:
    """The up-neighbor context is usable only when every lane's neighbor
    comes from an earlier interleave step (lanes <= dist); anything else
    degrades to the single-context adaptive order-0 model. Encoder and
    decoder apply the same rule, so the geometry is consistent by
    construction."""
    return neighbor_dist if neighbor_dist >= lanes else 0


def encode_ctx(symbols: np.ndarray, bits: int, lanes: int,
               neighbor_dist: int) -> tuple[np.ndarray, bytes]:
    """Adaptive encode: forward model pass gathers per-symbol (f, c), then
    the model-agnostic reverse rANS pass codes them."""
    symbols = np.asarray(symbols, np.uint32).reshape(-1)
    if symbols.size == 0:
        return np.full(lanes, RANS_L, "<u4"), b""
    neighbor_dist = _normalize_neighbor(lanes, neighbor_dist)
    padded = pad_to_lanes(symbols, lanes, 0)
    steps = padded.size // lanes
    model = _AdaptiveModel(bits, lanes)
    f = np.empty(padded.size, np.uint32)
    c = np.empty(padded.size, np.uint32)
    base = np.arange(lanes, dtype=np.int64)
    for t in range(steps):
        if model.refresh_due(t):
            model.rebuild()
        idx = t * lanes + base
        ctx = model.contexts(idx, padded, neighbor_dist)
        s = padded[idx]
        f[idx] = model.freqs[ctx, s]
        c[idx] = model.cums[ctx, s]
        model.update(ctx, s)
    return rans_encode(f, c, model.prob_bits, lanes)


def decode_ctx(states: np.ndarray, words: bytes, count: int, bits: int,
               lanes: int, neighbor_dist: int) -> np.ndarray:
    """Mirror of :func:`encode_ctx`: identical adaptation, forward decode."""
    if lanes < 1 or states.size != lanes:
        raise CorruptStream(
            f"expected {lanes} lane states, got {states.size}")
    neighbor_dist = _normalize_neighbor(lanes, neighbor_dist)
    if count == 0:
        if len(words):
            raise CorruptStream("nonempty word stream for an empty chunk")
        return np.empty(0, np.uint32)
    steps = -(-count // lanes)
    model = _AdaptiveModel(bits, lanes)
    mask = _U64((1 << model.prob_bits) - 1)
    pb = _U64(model.prob_bits)
    w = np.frombuffer(words, "<u2")
    x = states.astype(_U64)
    out = np.empty(steps * lanes, np.uint32)
    base = np.arange(lanes, dtype=np.int64)
    slot_tables = None
    ptr = 0
    for t in range(steps):
        if slot_tables is None or model.refresh_due(t):
            if t:
                model.rebuild()
            slot_tables = np.empty((model.nctx, 1 << model.prob_bits),
                                   np.uint32)
            for ctx in range(model.nctx):
                slot_tables[ctx] = np.repeat(
                    np.arange(model.nsym, dtype=np.uint32),
                    model.freqs[ctx])
        idx = t * lanes + base
        ctx = model.contexts(idx, out, neighbor_dist)
        slot = x & mask
        s = slot_tables[ctx, slot]
        x = (model.freqs[ctx, s].astype(_U64) * (x >> pb)
             + slot - model.cums[ctx, s].astype(_U64))
        need = x < _U64(RANS_L)
        nneed = int(np.count_nonzero(need))
        if nneed:
            if ptr + nneed > w.size:
                raise CorruptStream(
                    f"rANS word stream truncated: needed {ptr + nneed} "
                    f"words, have {w.size}")
            x[need] = (x[need] << _U64(WORD_BITS)) | w[ptr:ptr + nneed]
            ptr += nneed
        out[idx] = s
        model.update(ctx, s)
    if ptr != w.size:
        raise CorruptStream(
            f"rANS word stream has {w.size - ptr} unread trailing words")
    if not bool(np.all(x == _U64(RANS_L))):
        raise CorruptStream(
            "rANS lane states did not return to initial value "
            "(corrupt payload)")
    return out[:count]
