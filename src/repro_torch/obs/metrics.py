"""Low-overhead metrics: counters, gauges, and mergeable log-bucket
histograms, with a Prometheus-style text dump.

Copy of ``repro/obs/metrics.py`` for the port: the aggregation layer under
the stage-timer hooks (:mod:`repro_torch.obs.hooks`). Design constraints, in
order:

  * **Recording is cheap.** ``Counter.inc`` / ``Histogram.observe`` are a
    dict lookup plus a couple of float ops — no locks, no label-string
    formatting, no allocation on the hot path once a series exists. Callers
    on hot loops should hold the metric object (returned by
    ``registry.counter(...)``) instead of re-resolving it per event.
  * **Histograms are mergeable.** :class:`LogHistogram` buckets observations
    on a geometric grid, so two histograms (per-tenant, per-shard, per-run)
    merge by adding bucket counts — the property the store-every-record
    numpy percentile path lacks. Memory is O(occupied buckets), not
    O(observations), which is what makes long serving runs affordable.
  * **Bounded percentile error.** With the default ``growth = 2**(1/8)``
    a bucket spans ~9% of relative range; the nearest-rank percentile read
    off the bucket grid is within one bucket (<= ~9% relative) of the exact
    sample percentile, and exact min/max clamping makes single-observation
    (and p0/p100) reads exact.
  * **Deterministic text dump.** ``to_prometheus_text`` orders families and
    series lexicographically so dumps diff cleanly across runs.

No JAX, no serve imports — anything may depend on this module.
"""
from __future__ import annotations

import math

# Default bucket growth factor: 8 buckets per octave (~9.05% wide buckets,
# ~4.4% worst-case error at the geometric bucket midpoint).
GROWTH = 2.0 ** 0.125


class Counter:
    """Monotonically increasing value."""
    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increments must be >= 0, got {v}")
        self.value += v


class Gauge:
    """Last-written value (queue depth, utilization, backlog)."""
    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class LogHistogram:
    """Mergeable histogram over geometric (log-spaced) buckets.

    Bucket ``b`` holds values in ``[growth**b, growth**(b+1))``; zeros get
    their own bucket. Exact ``count`` / ``total`` / ``vmin`` / ``vmax`` ride
    alongside the bucket counts, so means are exact and percentile reads are
    clamped into the observed range (a single observation reports exactly
    itself at any percentile).
    """
    kind = "histogram"
    __slots__ = ("growth", "_lg", "buckets", "zero_count", "count", "total",
                 "vmin", "vmax")

    def __init__(self, growth: float = GROWTH):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = float(growth)
        self._lg = math.log(self.growth)
        self.buckets: dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def bucket_index(self, v: float) -> int:
        # small epsilon keeps exact powers of `growth` in their own bucket
        # despite log() rounding
        return int(math.floor(math.log(v) / self._lg + 1e-9))

    def observe(self, v: float) -> None:
        v = float(v)
        if v < 0 or math.isnan(v):
            raise ValueError(f"histogram observations must be >= 0, got {v}")
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v == 0.0:
            self.zero_count += 1
        else:
            b = self.bucket_index(v)
            self.buckets[b] = self.buckets.get(b, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    # -- merging -------------------------------------------------------------
    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into self (bucket grids must match)."""
        if abs(other.growth - self.growth) > 1e-12:
            raise ValueError(f"cannot merge histograms with different bucket "
                             f"growth ({self.growth} vs {other.growth})")
        for b, n in other.buckets.items():
            self.buckets[b] = self.buckets.get(b, 0) + n
        self.zero_count += other.zero_count
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    @classmethod
    def merged(cls, hists) -> "LogHistogram":
        """A fresh histogram holding the union of ``hists``."""
        hists = list(hists)
        out = cls(growth=hists[0].growth if hists else GROWTH)
        for h in hists:
            out.merge(h)
        return out

    # -- percentiles ---------------------------------------------------------
    def percentile(self, p: float) -> float:
        """Nearest-rank percentile off the bucket grid.

        Matches ``numpy.percentile(..., method="higher")`` to within one
        bucket (<= ``growth - 1`` relative error), exactly at the observed
        min/max. Raises on an empty histogram — an explicit error beats a
        silent NaN.
        """
        if self.count == 0:
            raise ValueError("no observations")
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        rank = max(1, math.ceil(p / 100.0 * self.count))   # nearest rank
        if rank >= self.count:
            return float(self.vmax)       # the max observation is exact
        seen = self.zero_count
        if rank <= seen:
            return 0.0
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if rank <= seen:
                rep = self.growth ** (b + 0.5)             # geometric middle
                return float(min(max(rep, self.vmin), self.vmax))
        return float(self.vmax)                            # numeric safety


class MetricsRegistry:
    """Keyed store of metric series: ``(name, sorted label items)`` -> metric.

    ``counter`` / ``gauge`` / ``histogram`` are get-or-create; re-registering
    a name with a different metric kind is an error (one name, one kind, as
    in Prometheus). ``collect`` and ``to_prometheus_text`` iterate in sorted
    order so output is deterministic.
    """

    def __init__(self):
        self._series: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict, **kwargs):
        key = (name, tuple(sorted(labels.items())))
        m = self._series.get(key)
        if m is None:
            m = cls(**kwargs)
            self._series[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, growth: float = GROWTH,
                  **labels) -> LogHistogram:
        return self._get(LogHistogram, name, labels, growth=growth)

    def get(self, name: str, **labels):
        """The existing series, or None — never creates."""
        return self._series.get((name, tuple(sorted(labels.items()))))

    def __len__(self) -> int:
        return len(self._series)

    def collect(self):
        """Yield ``(name, labels_dict, metric)`` in deterministic order."""
        for (name, labels) in sorted(self._series):
            yield name, dict(labels), self._series[(name, labels)]

    def histograms(self, name: str):
        """All histogram series registered under ``name`` (any labels)."""
        return [m for n, _, m in self.collect()
                if n == name and isinstance(m, LogHistogram)]

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry's series into this one (shard fan-in):
        counters add, gauges take the other's value, histograms merge."""
        for key, m in other._series.items():
            mine = self._series.get(key)
            if mine is None:
                if isinstance(m, LogHistogram):
                    mine = LogHistogram(growth=m.growth)
                else:
                    mine = type(m)()
                self._series[key] = mine
            if isinstance(m, Counter):
                mine.inc(m.value)
            elif isinstance(m, Gauge):
                mine.set(m.value)
            else:
                mine.merge(m)
        return self

    # -- text dump -----------------------------------------------------------
    @staticmethod
    def _fmt_labels(labels: dict, extra: dict | None = None) -> str:
        items = dict(labels)
        if extra:
            items.update(extra)
        if not items:
            return ""

        def esc(v) -> str:
            return str(v).replace("\\", "\\\\").replace('"', '\\"')

        body = ",".join(f'{k}="{esc(v)}"' for k, v in sorted(items.items()))
        return "{" + body + "}"

    def to_prometheus_text(self) -> str:
        """Prometheus exposition-style dump, deterministically ordered."""
        lines: list[str] = []
        seen_type: set[str] = set()
        for name, labels, m in self.collect():
            if name not in seen_type:
                seen_type.add(name)
                lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{name}{self._fmt_labels(labels)} "
                             f"{m.value:.10g}")
            else:
                cum = 0
                if m.zero_count:
                    cum += m.zero_count
                    lines.append(f"{name}_bucket"
                                 f"{self._fmt_labels(labels, {'le': '0'})} "
                                 f"{cum}")
                for b in sorted(m.buckets):
                    cum += m.buckets[b]
                    le = f"{m.growth ** (b + 1):.6g}"
                    lines.append(f"{name}_bucket"
                                 f"{self._fmt_labels(labels, {'le': le})} "
                                 f"{cum}")
                lines.append(f"{name}_bucket"
                             f"{self._fmt_labels(labels, {'le': '+Inf'})} "
                             f"{m.count}")
                lines.append(f"{name}_sum{self._fmt_labels(labels)} "
                             f"{m.total:.10g}")
                lines.append(f"{name}_count{self._fmt_labels(labels)} "
                             f"{m.count}")
        return "\n".join(lines) + ("\n" if lines else "")
