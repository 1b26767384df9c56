"""Micro-batching queue for the serving gateway.

Copy of ``repro/serve/batcher.py`` for the port. Requests arrive with
heterogeneous operating points (the rate controller varies them per
request), and every distinct batch size is one more shape for the restore
and the cloud forward (one more cuDNN algorithm choice, one more size class
of the caching allocator, one more launch plan of the consolidate kernel).
The batcher therefore:

  * groups requests by bucket key — requests in a group share one restore
    *and* one batched host decode (``plan.decode_batch``),
  * pads each flushed group up to a small set of power-of-two batch sizes
    (1, 2, 4, ... max_batch), so the number of shapes the card sees is
    bounded by ``|keys| * |bucket sizes|``,
  * preserves request identity: every :class:`MicroBatch` carries its
    requests in arrival order and ``pad`` tells the consumer how many
    trailing rows to drop.

Two request currencies are supported:

  * :class:`EncodedRequest` — the plan-API path: the bucket holds *encoded*
    wire blobs keyed by ``(operating point, H, W)`` and the gateway decodes
    the whole bucket in one ``plan.decode_batch`` call at dispatch time;
  * :class:`DecodedRequest` — the already-decoded currency (arrays stacked
    and padded here) for callers that decode upstream of the batcher.

Batch windows bound how long a partially-filled bucket may wait. With
``adaptive=True`` the window is *burst-aware*: each bucket tracks an EWMA of
its inter-arrival gap, and the deadline is the time the group is *expected*
to fill — ``gap_ewma * (max_batch - len(group))`` — clamped to
``[min_window_s, window_s]``. Bursty traffic fills buckets anyway, so the
deadline collapses toward ``min_window_s`` and latency is not spent waiting
for stragglers that are already in flight; sparse traffic would never fill
the bucket inside the window, so the group flushes early instead of idling
the full fixed window.

Pure host-side data plumbing — no torch in here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

EWMA_ALPHA = 0.3     # weight of the newest inter-arrival gap


@dataclass(frozen=True)
class BucketKey:
    c: int
    bits: int
    h: int
    w: int


@dataclass(frozen=True)
class PlanBucketKey:
    """Bucket key of the plan-API path: the full operating point (backend,
    tiling, context included — mixed backends must never share one batched
    decode) plus the spatial shape."""
    op: Any                    # repro_torch.pipeline.OperatingPoint
    h: int
    w: int

    @property
    def c(self) -> int:
        return self.op.c

    @property
    def bits(self) -> int:
        return self.op.bits


@dataclass
class EncodedRequest:
    """One request still in wire form — decoded batched, at dispatch."""
    req_id: int
    blob: Any                  # repro_torch.pipeline.WireBlob
    t_arrive: float = 0.0      # channel arrival (virtual clock)
    meta: Any = None           # opaque caller payload (stats, op point, ...)
    tenant: str = ""           # owning tenant ("" = single-tenant serving)
    priority: int = 0          # TenantSpec.priority (executor scheduling)

    @property
    def key(self) -> PlanBucketKey:
        _, h, w, _ = self.blob.shape
        return PlanBucketKey(op=self.blob.op, h=h, w=w)


@dataclass
class DecodedRequest:
    """One request after wire decode, ready for restore (legacy path)."""
    req_id: int
    codes: np.ndarray          # (1, H, W, C) integer codes
    mins: np.ndarray           # (1, 1, 1, C) fp16
    maxs: np.ndarray           # (1, 1, 1, C) fp16
    c: int
    bits: int
    t_arrive: float = 0.0      # channel arrival (virtual clock)
    meta: Any = None           # opaque caller payload (stats, op point, ...)
    tenant: str = ""           # owning tenant ("" = single-tenant serving)
    priority: int = 0          # TenantSpec.priority (executor scheduling)

    @property
    def key(self) -> BucketKey:
        _, h, w, _ = self.codes.shape
        return BucketKey(c=self.c, bits=self.bits, h=h, w=w)


@dataclass
class MicroBatch:
    key: Any                             # BucketKey | PlanBucketKey
    requests: list                       # arrival order, len = true batch
    codes: np.ndarray | None = None      # (Npad, H, W, C); None = encoded
    mins: np.ndarray | None = None       # (Npad, 1, 1, C)
    maxs: np.ndarray | None = None       # (Npad, 1, 1, C)
    pad: int = 0                         # trailing padded rows to drop
    target: int | None = None            # padded size (encoded batches)

    @property
    def padded_size(self) -> int:
        if self.codes is not None:
            return self.codes.shape[0]
        return self.target if self.target is not None else len(self.requests)

    @property
    def encoded(self) -> bool:
        """True when the batch still holds wire blobs (decode at dispatch)."""
        return self.codes is None

    @property
    def priority(self) -> int:
        """Batch priority class the executor schedules on: the max over its
        requests' priorities (buckets mix tenants; the batch rides at the
        highest class aboard)."""
        return max((getattr(r, "priority", 0) for r in self.requests),
                   default=0)


def bucket_sizes(max_batch: int) -> tuple[int, ...]:
    """Powers of two up to and including ``max_batch``."""
    sizes, s = [], 1
    while s < max_batch:
        sizes.append(s)
        s *= 2
    sizes.append(max_batch)
    return tuple(dict.fromkeys(sizes))


class MicroBatcher:
    """Groups requests into padded bucket-shaped micro-batches.

    Buckets are keyed by the request's ``key`` property only — NOT by tenant
    — so heterogeneous multi-tenant traffic at the same operating point
    shares one bucket and the batched decode + fused restore + cloud forward
    see only the bucket sizes (``tenant`` rides along for telemetry/routing).

    ``window_s`` bounds how long a partially-filled bucket may wait: ``add``
    stamps each new group with its first arrival, ``deadline(key)`` is when
    that group must flush, and ``take(key, gen)`` flushes one group by its
    generation stamp — the event-driven gateway schedules a flush event per
    group and ``gen`` keeps a stale event from flushing a *newer* group that
    formed after the original filled up. With ``adaptive=True`` the deadline
    follows the bucket's arrival-rate EWMA (module docstring) and may move
    in *either* direction as arrivals update the estimate — re-read
    ``deadline`` after every add, and re-check it when a scheduled flush
    fires (the event-driven gateway re-pushes a flush whose deadline
    drifted later instead of flushing undersized).
    """

    def __init__(self, *, max_batch: int = 8, window_s: float | None = None,
                 adaptive: bool = False, min_window_s: float = 0.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if window_s is not None and window_s < 0:
            raise ValueError("window_s must be >= 0")
        if adaptive and window_s is None:
            raise ValueError("adaptive windows need a window_s cap")
        if min_window_s < 0:
            raise ValueError("min_window_s must be >= 0")
        self.max_batch = max_batch
        self.window_s = window_s
        self.adaptive = adaptive
        self.min_window_s = min_window_s
        self.sizes = bucket_sizes(max_batch)
        self._pending: dict[Any, list] = {}
        self._opened: dict[Any, tuple[float, int]] = {}   # (t_first, gen)
        self._gen = 0
        # burst estimation state persists across groups at the same key
        self._last_arrival: dict[Any, float] = {}
        self._gap_ewma: dict[Any, float] = {}

    def __len__(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def _observe_arrival(self, key, now: float) -> None:
        last = self._last_arrival.get(key)
        self._last_arrival[key] = now
        if last is None:
            return
        gap = max(now - last, 0.0)
        if self.window_s is not None:
            # a gap beyond the window cap measures *idleness* between
            # traffic epochs, not arrival rate — clamp it so one quiet
            # stretch cannot poison the burst estimate for the next epoch
            gap = min(gap, self.window_s)
        prev = self._gap_ewma.get(key)
        self._gap_ewma[key] = (gap if prev is None
                               else EWMA_ALPHA * gap + (1 - EWMA_ALPHA) * prev)

    def arrival_gap_ewma(self, key) -> float | None:
        """Current EWMA of the inter-arrival gap at ``key`` (None = fewer
        than two arrivals observed)."""
        return self._gap_ewma.get(key)

    def add(self, req, now: float | None = None) -> list[MicroBatch]:
        """Enqueue; returns any group that reached max_batch (flushed full)."""
        t = req.t_arrive if now is None else now
        self._observe_arrival(req.key, t)
        group = self._pending.setdefault(req.key, [])
        if not group:
            self._gen += 1
            self._opened[req.key] = (t, self._gen)
        group.append(req)
        if len(group) >= self.max_batch:
            del self._pending[req.key]
            self._opened.pop(req.key, None)
            return [self._make_batch(req.key, group)]
        return []

    def deadline(self, key) -> tuple[float, int] | None:
        """(flush-due time, generation) for the group at ``key``; None when
        no group is open or no window is configured."""
        if self.window_s is None or key not in self._opened:
            return None
        t_first, gen = self._opened[key]
        window = self.window_s
        if self.adaptive:
            ewma = self._gap_ewma.get(key)
            if ewma is not None:
                # expected time for the stragglers that would fill the
                # bucket; bursts collapse this toward min_window_s, sparse
                # traffic flushes early instead of idling the full window
                remaining = self.max_batch - len(self._pending.get(key, ()))
                window = min(window, max(ewma * remaining, self.min_window_s))
        return t_first + window, gen

    def take(self, key, gen: int | None = None) -> MicroBatch | None:
        """Flush the group at ``key`` now; None when it is gone or, with
        ``gen`` given, when a different (newer) group occupies the key."""
        if key not in self._pending:
            return None
        if gen is not None and self._opened.get(key, (0.0, -1))[1] != gen:
            return None
        group = self._pending.pop(key)
        self._opened.pop(key, None)
        return self._make_batch(key, group)

    def flush(self) -> list[MicroBatch]:
        """Drain every pending group (end of tick / shutdown)."""
        out = [self._make_batch(k, g) for k, g in self._pending.items()]
        self._pending.clear()
        self._opened.clear()
        return out

    def _make_batch(self, key, group: list) -> MicroBatch:
        n = len(group)
        target = next(s for s in self.sizes if s >= n)
        pad = target - n
        if isinstance(group[0], EncodedRequest):
            # wire blobs stay packed; the gateway decodes the whole bucket
            # in one plan.decode_batch and pads the decoded stack to target
            return MicroBatch(key=key, requests=list(group), pad=pad,
                              target=target)

        def stack(field_name):
            arrs = [getattr(r, field_name) for r in group]
            arrs += [arrs[-1]] * pad            # repeat last row as padding
            return np.concatenate(arrs, axis=0)
        return MicroBatch(key=key, requests=list(group), codes=stack("codes"),
                          mins=stack("mins"), maxs=stack("maxs"), pad=pad)
