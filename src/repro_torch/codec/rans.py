"""Interleaved multi-stream rANS — the repo's real entropy coder.

Range asymmetric numeral systems (Duda 2013) in the interleaved formulation
of Giesen's ryg_rans: N independent lane states share one 16-bit word stream
with a fixed, deterministic interleaving, so encode/decode vectorize over
lanes with numpy while remaining bit-exact.

Construction (all little-endian):

  * state x ∈ [L, L·2^16) with L = 2^16; renormalization emits/reads one
    16-bit word. ``x_max = f << (32 - prob_bits)`` ≥ 2^16 whenever
    ``prob_bits <= 16``, so at most ONE renormalization per symbol — the
    per-step emit is a single masked operation, no data-dependent loops.
  * lane l owns symbols l, l+N, l+2N, …; encoding walks the symbols in
    reverse, emitting each step's renorm words in reverse lane order and
    reversing the whole word array at the end, so the decoder (walking
    forward) reads words in increasing lane order with a single pointer.
  * the encoder takes *per-symbol* (freq, cumfreq) arrays — one static table
    (``RansTable``) or a context model (repro_torch.codec.context) both reduce to
    a gather before the coding loop, so the loop itself is model-agnostic.
  * decoding a full stream must return every lane to the initial state L;
    ``rans_decode`` checks this, which catches most payload corruption that
    happens to keep slots in range.

Frequencies are normalized to sum exactly to ``1 << prob_bits`` with every
alphabet symbol kept ≥ 1 (``normalize_freqs``), so any symbol — including
lane padding — is always codable.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

RANS_L = 1 << 16            # lower bound of the normalization interval
WORD_BITS = 16              # renormalization word size
MAX_PROB_BITS = 15          # freqs must fit uint16 in the table blob

_U64 = np.uint64


class CorruptStream(ValueError):
    """A bitstream failed structural or arithmetic validation."""


def normalize_freqs(counts: np.ndarray, prob_bits: int) -> np.ndarray:
    """Scale histogram ``counts`` to sum exactly to ``1 << prob_bits``.

    Every symbol of the alphabet gets frequency >= 1 (even zero-count ones),
    so the resulting table can code *any* symbol — required for lane padding
    and for adaptive models that may meet unseen symbols. Deterministic:
    ties break by symbol index, so encoder and decoder derive identical
    tables from identical counts.
    """
    if not 1 <= prob_bits <= MAX_PROB_BITS:
        raise ValueError(f"prob_bits must be in [1, {MAX_PROB_BITS}], "
                         f"got {prob_bits}")
    c = np.maximum(np.asarray(counts, dtype=np.int64), 0)
    n = c.size
    target = 1 << prob_bits
    if n == 0:
        raise ValueError("empty alphabet")
    if n > target:
        raise ValueError(f"alphabet of {n} symbols does not fit "
                         f"prob_bits={prob_bits}")
    total = int(c.sum())
    if total == 0:
        c = np.ones(n, dtype=np.int64)
        total = n
    scaled = (c * target) // total
    freqs = np.maximum(scaled, 1)
    diff = target - int(freqs.sum())
    if diff > 0:
        # hand the shortfall to the largest fractional remainders
        rem = c * target - scaled * total
        order = np.lexsort((np.arange(n), -rem))
        freqs[order[:diff]] += 1
    elif diff < 0:
        # the min-1 bumps oversubscribed the budget; reclaim from the
        # largest frequencies (they lose the least precision)
        order = np.argsort(-freqs, kind="stable")
        need = -diff
        for i in order:
            take = min(int(freqs[i]) - 1, need)
            freqs[i] -= take
            need -= take
            if need == 0:
                break
        assert need == 0, "cannot normalize: alphabet too large"
    return freqs.astype(np.uint32)


@dataclass
class RansTable:
    """Static frequency table: freqs + exclusive cumulative + slot lookup."""
    freqs: np.ndarray               # (S,) uint32, sums to 1 << prob_bits
    prob_bits: int
    cum: np.ndarray = field(init=False)           # (S,) exclusive prefix sum
    _slots: np.ndarray | None = field(init=False, default=None, repr=False)

    def __post_init__(self):
        self.freqs = np.asarray(self.freqs, np.uint32)
        if int(self.freqs.sum()) != 1 << self.prob_bits:
            raise CorruptStream(
                f"frequency table sums to {int(self.freqs.sum())}, "
                f"expected {1 << self.prob_bits}")
        if self.freqs.size and int(self.freqs.min()) < 1:
            raise CorruptStream("frequency table has zero-frequency symbols")
        self.cum = (np.cumsum(self.freqs, dtype=np.uint64)
                    - self.freqs).astype(np.uint32)

    @classmethod
    def from_counts(cls, counts, prob_bits: int) -> "RansTable":
        return cls(freqs=normalize_freqs(counts, prob_bits),
                   prob_bits=prob_bits)

    def slot_symbols(self) -> np.ndarray:
        """(1 << prob_bits,) slot -> symbol decode lookup (lazily built)."""
        if self._slots is None:
            self._slots = np.repeat(
                np.arange(self.freqs.size, dtype=np.uint32),
                self.freqs).astype(np.uint32)
        return self._slots


def pad_to_lanes(symbols: np.ndarray, lanes: int,
                 pad_value: int) -> np.ndarray:
    """Pad the symbol stream to a whole number of interleave steps."""
    k = symbols.size
    rem = (-k) % lanes
    if rem == 0:
        return symbols
    return np.concatenate(
        [symbols, np.full(rem, pad_value, dtype=symbols.dtype)])


def rans_encode(freqs: np.ndarray, cums: np.ndarray, prob_bits: int,
                lanes: int) -> tuple[np.ndarray, bytes]:
    """Encode a symbol stream given its per-symbol (freq, cumfreq) gathers.

    freqs/cums: (K,) with K a multiple of ``lanes`` (callers pad, see
    :func:`pad_to_lanes`); entry i belongs to symbol i of the stream.
    Returns ``(final lane states (lanes,) uint32, word stream bytes)``.
    """
    k = freqs.size
    if k % lanes or lanes < 1:
        raise ValueError(f"{k} symbols do not fill {lanes} lanes")
    shift = _U64(32 - prob_bits)
    pb = _U64(prob_bits)
    f = np.ascontiguousarray(freqs, _U64).reshape(-1, lanes)
    c = np.ascontiguousarray(cums, _U64).reshape(-1, lanes)
    x = np.full(lanes, RANS_L, _U64)
    chunks: list[np.ndarray] = []
    for t in range(f.shape[0] - 1, -1, -1):
        ft, ct = f[t], c[t]
        need = x >= (ft << shift)
        if need.any():
            # reverse lane order: the final global reversal flips it back,
            # so the decoder reads renorm words in increasing lane order
            chunks.append((x[need] & _U64(0xFFFF)).astype("<u2")[::-1])
            x = np.where(need, x >> _U64(WORD_BITS), x)
        x = ((x // ft) << pb) + (x % ft) + ct
    if chunks:
        words = np.concatenate(chunks)[::-1]
    else:
        words = np.empty(0, "<u2")
    return x.astype("<u4"), words.tobytes()


def rans_decode(states: np.ndarray, words: bytes, count: int,
                table: RansTable, lanes: int) -> np.ndarray:
    """Decode ``count`` symbols coded with one static table.

    Raises :class:`CorruptStream` on a short/overlong word stream or when
    the lane states fail to return to the initial value (bit corruption).
    """
    if lanes < 1 or states.size != lanes:
        raise CorruptStream(
            f"expected {lanes} lane states, got {states.size}")
    steps = -(-count // lanes) if count else 0
    slot_syms = table.slot_symbols()
    freqs = table.freqs.astype(_U64)
    cums = table.cum.astype(_U64)
    mask = _U64((1 << table.prob_bits) - 1)
    pb = _U64(table.prob_bits)
    w = np.frombuffer(words, "<u2")
    x = states.astype(_U64)
    out = np.empty((steps, lanes), np.uint32)
    ptr = 0
    for t in range(steps):
        slot = x & mask
        s = slot_syms[slot]
        out[t] = s
        x = freqs[s] * (x >> pb) + slot - cums[s]
        need = x < _U64(RANS_L)
        nneed = int(np.count_nonzero(need))
        if nneed:
            if ptr + nneed > w.size:
                raise CorruptStream(
                    f"rANS word stream truncated: needed {ptr + nneed} "
                    f"words, have {w.size}")
            x[need] = (x[need] << _U64(WORD_BITS)) | w[ptr:ptr + nneed]
            ptr += nneed
    if ptr != w.size:
        raise CorruptStream(
            f"rANS word stream has {w.size - ptr} unread trailing words")
    if steps and not bool(np.all(x == _U64(RANS_L))):
        raise CorruptStream(
            "rANS lane states did not return to initial value "
            "(corrupt payload)")
    return out.reshape(-1)[:count]


def encode_static(symbols: np.ndarray, table: RansTable,
                  lanes: int) -> tuple[np.ndarray, bytes]:
    """Static-table convenience wrapper: pad, gather (f, c), run the coder.

    Padding uses the table's most probable symbol (cheapest per pad symbol);
    the decoder truncates by count, so only the wire cost is affected.
    """
    symbols = np.asarray(symbols).reshape(-1)
    if symbols.size == 0:
        return np.full(lanes, RANS_L, "<u4"), b""
    pad_value = int(np.argmax(table.freqs))
    padded = pad_to_lanes(symbols.astype(np.uint32), lanes, pad_value)
    f = table.freqs[padded]
    c = table.cum[padded]
    return rans_encode(f, c, table.prob_bits, lanes)
