"""Per-request and aggregate serving telemetry for the gateway.

Copy of ``repro/serve/telemetry.py`` for the port.

Wire-side numbers (bits on wire, channel latency, queue wait) come from the
simulated channel's virtual clock; compute-side numbers (restore + cloud
forward) follow the executor's virtual-clock cost model (identical to the
measured wall clock under the default ``MeasuredCost``). ``total_latency_s``
adds the two, which is the quantity the benchmark reports percentiles over.

Shed requests live in their own series (:class:`ShedRecord`, recorded via
:meth:`Telemetry.record_shed`): admission rejections never appear among the
served records, so latency p50/p99 measure *served* requests only — an
overloaded gateway shedding half its traffic cannot fake a good p99 (or be
charged zero-latency phantoms). ``summary()`` reports the shed series
alongside, as counts and a shed rate.

:class:`Telemetry` is built on
:class:`repro_torch.obs.metrics.MetricsRegistry`:
every record also lands in counters and mergeable log-bucket histograms
(``gateway_requests_total``, ``gateway_request_latency_seconds{tenant=...}``,
...), dumpable as Prometheus text via ``telemetry.metrics``. By default the
full record list is kept and percentiles stay the exact numpy computation;
pass ``max_records=N`` to bound memory on long runs — the list caps at N
while counts/sums/percentiles keep covering *every* record through the
registry aggregates (percentiles then carry the histogram's bucket
tolerance, ~9% relative at the default growth; see repro_torch.obs.metrics).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.obs.metrics import LogHistogram, MetricsRegistry


@dataclass(frozen=True)
class RequestRecord:
    req_id: int
    c: int
    bits: int
    bits_on_wire: int
    wire_latency_s: float       # submit -> arrival at the cloud (simulated)
    queue_wait_s: float         # arrival -> executor service start (virtual)
    compute_s: float            # restore + cloud forward (executor cost model)
    batch_size: int             # true (unpadded) size of the micro-batch
    padded_size: int
    tenant: str = ""            # owning tenant ("" = single-tenant serving)
    sched_wait_s: float = 0.0   # encode done -> uplink grant (simulated)
    exec_queue: int = 0         # executor queue that served the batch

    @property
    def total_latency_s(self) -> float:
        return (self.sched_wait_s + self.wire_latency_s + self.queue_wait_s
                + self.compute_s)


@dataclass(frozen=True)
class ShedRecord:
    """One admission rejection — its own series, never a latency record."""
    req_id: int                 # per-tenant sequence number
    tenant: str
    t_submit: float
    reason: str                 # admission policy's explicit justification
    priority: int = 0


@dataclass(frozen=True)
class DegradeRecord:
    """One QoS ladder step-down — degrade-before-shed's distinct outcome.

    A streaming session under pressure steps to a coarser operating point
    (or sparser cadence) *instead of* being shed; the request is still
    served, so it also appears among the latency records. This series
    meters how often and why quality was traded for admission, separate
    from both the served and the shed series.
    """
    tenant: str
    t: float
    frame_seq: int
    from_level: int             # QoS ladder index before the step (0 = best)
    to_level: int               # ladder index after
    reason: str                 # the admission rejection that triggered it


def jain_fairness(values) -> float:
    """Jain's fairness index over per-tenant allocations: 1 = perfectly
    fair, 1/n = one tenant holds everything."""
    v = np.asarray(list(values), np.float64)
    if v.size == 0 or float(np.sum(v)) == 0.0:
        return 1.0
    return float(np.sum(v) ** 2 / (v.size * np.sum(v * v)))


# histogram series a truncated Telemetry can still answer percentiles from
_HIST_FIELDS = {
    "total_latency_s": "gateway_request_latency_seconds",
    "compute_s": "gateway_compute_seconds",
    "queue_wait_s": "gateway_queue_wait_seconds",
}


class _TenantAgg:
    """Running per-tenant aggregates + cached registry series handles (one
    key construction per tenant, not per record)."""
    __slots__ = ("count", "bits", "sched_sum", "batch_sum", "ops",
                 "c_req", "c_bits", "hists")

    def __init__(self, metrics: MetricsRegistry, tenant: str):
        self.count = 0
        self.bits = 0
        self.sched_sum = 0.0
        self.batch_sum = 0.0
        self.ops: set[tuple[int, int]] = set()
        self.c_req = metrics.counter("gateway_requests_total", tenant=tenant)
        self.c_bits = metrics.counter("gateway_wire_bits_total",
                                      tenant=tenant)
        self.hists = {f: metrics.histogram(name, tenant=tenant)
                      for f, name in _HIST_FIELDS.items()}


class Telemetry:
    """Accumulates request records and reports aggregate percentiles.

    Served requests (``records``) and admission rejections (``shed``) are
    separate series; ``__len__``/``percentile`` cover served only.

    Parameters
    ----------
    registry : share an existing :class:`MetricsRegistry` (the gateway
        passes its own so request series land beside executor/scheduler
        gauges); None = a private registry
    max_records : cap on the stored record list (None = keep every record,
        the exact-percentile default). Aggregates always cover all records.
    """

    def __init__(self, *, registry: MetricsRegistry | None = None,
                 max_records: int | None = None):
        if max_records is not None and max_records < 1:
            raise ValueError(f"max_records must be >= 1, got {max_records}")
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.max_records = max_records
        self.records: list[RequestRecord] = []
        self.shed: list[ShedRecord] = []
        self.degraded: list[DegradeRecord] = []
        self._n = 0
        self._tenant: dict[str, _TenantAgg] = {}

    @property
    def truncated(self) -> bool:
        """True when the record list stopped growing at ``max_records``
        (aggregate counts/sums/histograms still cover everything)."""
        return self._n > len(self.records)

    def _agg(self, tenant: str) -> _TenantAgg:
        agg = self._tenant.get(tenant)
        if agg is None:
            agg = _TenantAgg(self.metrics, tenant)
            self._tenant[tenant] = agg
        return agg

    def record(self, rec: RequestRecord) -> None:
        if self.max_records is None or len(self.records) < self.max_records:
            self.records.append(rec)
        self._n += 1
        agg = self._agg(rec.tenant)
        agg.count += 1
        agg.bits += rec.bits_on_wire
        agg.sched_sum += rec.sched_wait_s
        agg.batch_sum += rec.batch_size
        agg.ops.add((rec.c, rec.bits))
        agg.c_req.inc()
        agg.c_bits.inc(rec.bits_on_wire)
        for field_name, hist in agg.hists.items():
            # virtual-clock records can carry tiny negative waits (a ticket
            # may start a hair before the packet's nominal arrival in the
            # adaptive-window path); latency histograms clamp at zero
            hist.observe(max(0.0, getattr(rec, field_name)))

    def record_shed(self, rec: ShedRecord) -> None:
        self.shed.append(rec)
        self.metrics.counter("gateway_shed_total", tenant=rec.tenant).inc()

    def record_degrade(self, rec: DegradeRecord) -> None:
        self.degraded.append(rec)
        self.metrics.counter("gateway_degrade_total", tenant=rec.tenant).inc()

    def degrade_by_tenant(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for d in self.degraded:
            out[d.tenant] = out.get(d.tenant, 0) + 1
        return out

    def __len__(self) -> int:
        return self._n            # true served count, even when truncated

    def shed_by_tenant(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for s in self.shed:
            out[s.tenant] = out.get(s.tenant, 0) + 1
        return out

    def shed_rate(self) -> float:
        """Fraction of all submissions that were shed (0.0 when none)."""
        total = self._n + len(self.shed)
        return len(self.shed) / total if total else 0.0

    # -- percentiles ---------------------------------------------------------
    def _hist_percentile(self, field_name: str, p: float,
                         tenant: str | None) -> float:
        name = _HIST_FIELDS.get(field_name)
        if name is None:
            raise ValueError(
                f"record history truncated at max_records="
                f"{self.max_records}; histogram percentiles cover only "
                f"{sorted(_HIST_FIELDS)}, not {field_name!r}")
        if tenant is None:
            hists = [a.hists[field_name] for a in self._tenant.values()]
            h = hists[0] if len(hists) == 1 else LogHistogram.merged(hists)
        else:
            agg = self._tenant.get(tenant)
            h = agg.hists[field_name] if agg is not None else None
        if h is None or h.count == 0:
            raise ValueError(self._no_records_msg(tenant))
        return h.percentile(p)

    def _no_records_msg(self, tenant: str | None) -> str:
        scope = f"tenant {tenant!r}" if tenant is not None else "telemetry"
        msg = f"no served records in {scope}"
        if self.shed:
            msg += (f" ({len(self.shed)} shed by admission — the shed "
                    f"series has no latency percentiles)")
        return msg

    def percentile(self, field_name: str, p: float,
                   tenant: str | None = None) -> float:
        """Percentile of ``field_name`` over served records.

        Exact (numpy, linear interpolation) while the full record list is
        retained; within histogram bucket tolerance once truncated. A single
        record reports itself at every percentile; no served records raises
        ValueError naming the shed count instead of returning NaN."""
        if self.truncated:
            return self._hist_percentile(field_name, p, tenant)
        vals = [getattr(r, field_name) for r in self.records
                if tenant is None or r.tenant == tenant]
        if not vals:
            raise ValueError(self._no_records_msg(tenant))
        if len(vals) == 1:
            return float(vals[0])
        return float(np.percentile(np.asarray(vals, np.float64), p))

    def tenants(self) -> list[str]:
        return sorted(self._tenant)

    def per_tenant(self) -> dict[str, dict]:
        """{tenant: summary} over each tenant's own records.

        Tenants with served traffic report latency percentiles over their
        *served* requests only; their shed count rides alongside. A tenant
        whose every request was shed still appears — shedding must never
        erase a tenant from the report — with the same row schema (latency
        fields None, counts 0), so consumers never hit a KeyError; guard on
        ``count`` before using the latency numbers."""
        shed = self.shed_by_tenant()
        out = {}
        for t in sorted(set(self.tenants()) | set(shed)):
            agg = self._tenant.get(t)
            count = agg.count if agg is not None else 0
            row = {
                "count": count,
                "shed": shed.get(t, 0),
                "bits_on_wire": int(agg.bits) if agg is not None else 0,
                "p50_latency_s": None,
                "p99_latency_s": None,
                "mean_sched_wait_s": None,
                "operating_points": sorted(agg.ops) if agg is not None
                else [],
            }
            if count:
                row["p50_latency_s"] = self.percentile(
                    "total_latency_s", 50, tenant=t)
                row["p99_latency_s"] = self.percentile(
                    "total_latency_s", 99, tenant=t)
                row["mean_sched_wait_s"] = agg.sched_sum / count
            out[t] = row
        return out

    def fairness(self, field_name: str = "bits_on_wire") -> float:
        """Jain's index over per-tenant sums of ``field_name`` (1 = fair)."""
        if field_name == "bits_on_wire":
            # aggregate path: exact regardless of record truncation
            return jain_fairness(a.bits for a in self._tenant.values())
        if self.truncated:
            raise ValueError(
                f"record history truncated at max_records="
                f"{self.max_records}; fairness over {field_name!r} needs "
                f"the full record list (bits_on_wire stays available)")
        per: dict[str, float] = {}
        for r in self.records:
            per[r.tenant] = per.get(r.tenant, 0.0) + getattr(r, field_name)
        return jain_fairness(per.values())

    # -- aggregate views -----------------------------------------------------
    def summary(self, *, wall_s: float | None = None) -> dict:
        """Aggregate view; pass the measured wall time for requests/sec.

        Latency percentiles cover served requests only; the shed series is
        summarized separately (``shed``/``shed_rate``). An empty served
        series with a non-empty shed series reports counts (not a crash and
        not phantom zero latencies)."""
        if self._n == 0:
            out = {"count": 0}
            if self.shed:
                out.update({"shed": len(self.shed), "shed_rate": 1.0,
                            "shed_by_tenant": self.shed_by_tenant()})
            if self.degraded:
                out.update({"degraded": len(self.degraded),
                            "degrade_by_tenant": self.degrade_by_tenant()})
            return out
        total_bits = sum(a.bits for a in self._tenant.values())
        total_batch = sum(a.batch_sum for a in self._tenant.values())
        ops = set()
        for a in self._tenant.values():
            ops |= a.ops
        out = {
            "count": self._n,
            "mean_bits_on_wire": total_bits / self._n,
            "mean_batch_size": total_batch / self._n,
            "p50_latency_s": self.percentile("total_latency_s", 50),
            "p99_latency_s": self.percentile("total_latency_s", 99),
            "p50_compute_s": self.percentile("compute_s", 50),
            "p99_compute_s": self.percentile("compute_s", 99),
            "operating_points": sorted(ops),
        }
        if self.shed:
            out["shed"] = len(self.shed)
            out["shed_rate"] = self.shed_rate()
            out["shed_by_tenant"] = self.shed_by_tenant()
        if self.degraded:
            out["degraded"] = len(self.degraded)
            out["degrade_by_tenant"] = self.degrade_by_tenant()
        if wall_s is not None and wall_s > 0:
            out["requests_per_s"] = self._n / wall_s
        tenants = self.tenants()
        if len(tenants) > 1 or (tenants and tenants != [""]):
            out["tenants"] = tenants
            out["fairness_bits"] = self.fairness("bits_on_wire")
        return out

    def format_summary(self, *, wall_s: float | None = None) -> str:
        s = self.summary(wall_s=wall_s)
        if not s["count"]:
            return ("no requests" if not self.shed
                    else f"no requests served ({len(self.shed)} shed)")
        lines = [f"requests           : {s['count']}"]
        if "shed" in s:
            lines.append(f"shed (admission)   : {s['shed']} "
                         f"({100 * s['shed_rate']:.0f}% of offered)")
        if "requests_per_s" in s:
            lines.append(f"requests/sec       : {s['requests_per_s']:.1f}")
        lines += [
            f"mean bits on wire  : {s['mean_bits_on_wire']:.0f}",
            f"mean batch size    : {s['mean_batch_size']:.2f}",
            f"p50 / p99 latency  : {s['p50_latency_s']*1e3:.2f} / "
            f"{s['p99_latency_s']*1e3:.2f} ms",
            f"p50 / p99 compute  : {s['p50_compute_s']*1e3:.2f} / "
            f"{s['p99_compute_s']*1e3:.2f} ms",
            f"operating points   : {s['operating_points']}",
        ]
        if "fairness_bits" in s:
            lines.append(f"fairness (bits)    : {s['fairness_bits']:.3f}")
            for t, ts in self.per_tenant().items():
                shed = f" shed={ts['shed']}" if ts["shed"] else ""
                if ts["count"]:
                    lines.append(
                        f"  tenant {t or '<default>':<10}: "
                        f"n={ts['count']:<4} "
                        f"p50/p99 {ts['p50_latency_s']*1e3:.2f}/"
                        f"{ts['p99_latency_s']*1e3:.2f} ms  "
                        f"ops {ts['operating_points']}{shed}")
                else:
                    lines.append(f"  tenant {t or '<default>':<10}: "
                                 f"n=0   {shed}")
        return "\n".join(lines)
