"""Pluggable cloud-side execution for the serving gateway.

Copy of ``repro/serve/executor.py`` for the port (stdlib only).

The gateways used to model the cloud as one hardwired serial executor baked
into the event loop (``cloud_busy = start + compute_s``). This module makes
the cloud half a first-class, swappable object:

  * :class:`CloudExecutor` — the protocol every cloud model implements:
    ``submit(batch, t_ready) -> ExecTicket`` plans the batch onto a queue on
    the *virtual* clock (the real compute runs inline, its wall time
    is measured separately), ``poll(now)`` / ``drain()`` surface finished
    tickets, and capacity / queue-depth introspection feeds admission
    control.
  * :class:`SerialExecutor` — one queue, measured-wall-time cost model:
    bit-identical to the old inline serial cloud. The default.
  * :class:`MultiQueueExecutor` — N parallel queues (think N accelerator
    replicas behind the gateway) with per-queue service rates.
    Work-conserving selection: a batch goes to whichever queue finishes it
    first (earliest ``max(t_ready, busy_until) + cost/rate``); ties prefer
    the queue that last served the same plan bucket (trace/cache affinity),
    then the lowest index — fully deterministic.
  * :class:`AdmissionPolicy` objects — token buckets per tenant,
    queue-depth thresholds with per-priority limits, and composition.
    Every rejection is an explicit :class:`RequestShed` outcome; nothing is
    ever silently dropped.

Virtual-clock cost model: the executor *plans* service durations with a
:class:`CostModel`. :class:`MeasuredCost` (default) uses the measured wall
time of the real compute — honest, but not replayable bit-for-bit.
:class:`LinearCostModel` is a deterministic ``base + per_item * padded_size``
model: two runs of the same workload produce bit-identical tickets and
telemetry (the replay tests and the overload benchmark pin this).

Pure host-side scheduling — the only device work in here is whatever the
bound ``run_fn`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


# ---------------------------------------------------------------------------
# Cost models (virtual-clock service durations)
# ---------------------------------------------------------------------------

class CostModel:
    """Maps one micro-batch to its virtual service duration in seconds."""

    def duration_s(self, batch, measured_s: float) -> float:
        raise NotImplementedError


class MeasuredCost(CostModel):
    """Virtual duration = measured wall time of the real compute.

    Matches the pre-executor gateways exactly, but replays only as
    bit-identically as the host's clock does (use :class:`LinearCostModel`
    when the run must replay bit-for-bit)."""

    def duration_s(self, batch, measured_s: float) -> float:
        return measured_s


@dataclass(frozen=True)
class LinearCostModel(CostModel):
    """Deterministic affine cost: ``base_s + per_item_s * padded_size``.

    The virtual clock then depends only on the workload, never on host
    timing — same seed, same tickets, same telemetry, bit for bit."""
    base_s: float = 0.002
    per_item_s: float = 0.001

    def duration_s(self, batch, measured_s: float) -> float:
        return self.base_s + self.per_item_s * batch.padded_size


class CalibratedCostModel(CostModel):
    """Affine cost **fit from measured compute** — calibrate, freeze, replay.

    Life cycle:

      1. *Calibrating* (``frozen=False``): every ``duration_s`` call records a
         ``(padded_size, wall_s)`` sample and returns the measured wall time
         (behaves like :class:`MeasuredCost`). Drive a warm executor through
         a spread of batch sizes to collect the samples.
      2. ``freeze()``: least-squares affine fit ``base_s + per_item_s * n``
         over the samples (coefficients clamped >= 0; degenerate sample sets
         fall back to the seed coefficients, e.g. roofline estimates from
         ``launch/hlo_cost``).
      3. *Frozen*: ``duration_s`` is a pure function of ``padded_size`` —
         the virtual clock depends only on the workload, so two runs replay
         bit-identically, like :class:`LinearCostModel` but with constants
         the hardware chose.

    Calibrate on warm compute only: a sample that includes a first call
    (cuDNN's algorithm search, the allocator's growth) poisons the fit.
    """

    def __init__(self, *, seed_base_s: float = 0.0,
                 seed_per_item_s: float = 0.0):
        if seed_base_s < 0 or seed_per_item_s < 0:
            raise ValueError("seed coefficients must be >= 0")
        self.seed_base_s = float(seed_base_s)
        self.seed_per_item_s = float(seed_per_item_s)
        self.base_s = self.seed_base_s
        self.per_item_s = self.seed_per_item_s
        self.samples: list[tuple[int, float]] = []
        self.frozen = False

    def observe(self, n_items: int, wall_s: float) -> None:
        if self.frozen:
            raise RuntimeError("frozen CalibratedCostModel takes no samples")
        self.samples.append((int(n_items), float(wall_s)))

    def duration_s(self, batch, measured_s: float) -> float:
        if self.frozen:
            return self.predict(batch.padded_size)
        self.observe(batch.padded_size, measured_s)
        return measured_s

    def predict(self, n_items: int) -> float:
        return self.base_s + self.per_item_s * n_items

    def fit(self) -> tuple[float, float]:
        """Closed-form least squares over the samples -> (base_s, per_item_s).

        Needs >= 2 distinct batch sizes to separate the intercept from the
        slope; with fewer, the seed slope is kept and only the intercept is
        adjusted to the sample mean."""
        if not self.samples:
            return self.base_s, self.per_item_s
        ns = [float(n) for n, _ in self.samples]
        ys = [y for _, y in self.samples]
        k = len(ns)
        n_mean = sum(ns) / k
        y_mean = sum(ys) / k
        var = sum((n - n_mean) ** 2 for n in ns)
        if var > 0:
            cov = sum((n - n_mean) * (y - y_mean) for n, y in zip(ns, ys))
            per_item = max(cov / var, 0.0)
        else:
            per_item = self.seed_per_item_s
        base = max(sum(y - per_item * n for n, y in zip(ns, ys)) / k, 0.0)
        self.base_s, self.per_item_s = base, per_item
        return base, per_item

    def freeze(self) -> "CalibratedCostModel":
        """Fit (if samples were collected) and pin the coefficients."""
        if not self.frozen:
            self.fit()
            self.frozen = True
        return self

    def fit_rel_err(self) -> float:
        """Mean |predicted - measured| / measured over the calibration
        samples — the acceptance gate asks this to stay within 0.25."""
        errs = [abs(self.predict(n) - y) / y for n, y in self.samples if y > 0]
        return sum(errs) / len(errs) if errs else 0.0


# ---------------------------------------------------------------------------
# Tickets
# ---------------------------------------------------------------------------

@dataclass
class ExecTicket:
    """One submitted micro-batch's journey through the cloud executor."""
    seq: int                     # submission order (deterministic tiebreak)
    batch: Any                   # serve.batcher.MicroBatch
    t_submit: float              # virtual time the gateway handed it over
    t_start: float               # virtual time its queue begins service
    t_done: float                # virtual completion time
    service_s: float             # virtual service duration (cost model)
    wall_s: float                # measured wall time of the real compute
    queue: int                   # queue index that served it
    logits: Any = None           # real compute output (set at submit)
    state: str = "queued"        # queued -> running -> done
    priority: int = 0            # batch priority class (max over requests)

    @property
    def queue_wait_s(self) -> float:
        return self.t_start - self.t_submit


@dataclass(frozen=True)
class RequestShed:
    """Explicit not-served outcome of admission control.

    Takes the response slot the request would have occupied, so callers see
    every submission end in exactly one of {response, shed} — never a silent
    drop. Telemetry keeps these in their own series (``Telemetry.shed``),
    separate from the served-latency percentiles."""
    req_id: int                  # per-tenant sequence number
    tenant: str
    t_submit: float
    reason: str                  # e.g. "token-bucket" / "queue-depth 8>=8"
    priority: int = 0

    @property
    def shed(self) -> bool:      # duck-type discriminator vs GatewayResponse
        return True


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------

@dataclass
class _Queue:
    rate: float                  # service-rate multiplier (1.0 = nominal)
    busy_until: float = 0.0
    depth: int = 0               # tickets submitted but not completed
    served: int = 0
    busy_s: float = 0.0          # integrated virtual service time
    last_key: Any = None         # plan bucket last served (affinity)
    last_priority: int | None = None   # priority class last served


class CloudExecutor:
    """Base class + protocol for cloud-side batch execution.

    The gateway binds ``run_fn`` (its batched decode+restore+forward) at
    construction; ``submit`` runs it inline (real compute, measured wall
    time) and plans ``t_start``/``t_done`` on the virtual clock. The event
    loop then replays those times as ``exec_start``/``exec_done`` events,
    calling :meth:`on_start` / :meth:`complete` so depth introspection — the
    signal admission control keys on — tracks the virtual clock exactly.
    """

    def __init__(self, *, queues: "list[_Queue]", cost: CostModel | None):
        if not queues:
            raise ValueError("executor needs at least one queue")
        self.cost = cost if cost is not None else MeasuredCost()
        self.run_fn: Callable | None = None
        self.metrics = None       # obs.MetricsRegistry: live depth gauges
        self._gauge_cache = None  # (registry, depth gauge, per-queue gauges)
        self._template = [q.rate for q in queues]
        self._queues = queues
        self._seq = 0
        self.history: list[ExecTicket] = []     # every ticket, submit order
        self._outstanding: dict[int, ExecTicket] = {}   # seq -> not-yet-done
        self.max_depth_seen = 0

    # -- lifecycle ----------------------------------------------------------
    def reset(self) -> None:
        """Back to an idle executor — serve runs replay bit-identically."""
        self._queues = [_Queue(rate=r) for r in self._template]
        self._seq = 0
        self.history = []
        self._outstanding = {}
        self.max_depth_seen = 0

    # -- introspection -------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Parallel service slots (number of queues)."""
        return len(self._queues)

    def depth(self) -> int:
        """Batches submitted but not yet completed (all queues)."""
        return sum(q.depth for q in self._queues)

    def queue_depths(self) -> list[int]:
        return [q.depth for q in self._queues]

    def busy_until(self) -> float:
        return max(q.busy_until for q in self._queues)

    def utilization(self, span_s: float) -> float:
        """Mean fraction of queue-seconds spent serving over ``span_s``."""
        if span_s <= 0:
            return 0.0
        return sum(q.busy_s for q in self._queues) / (
            span_s * len(self._queues))

    def _gauge_depths(self, queue: int) -> None:
        m = self.metrics
        if m is not None:
            # handle cache: submit/complete run per request, a registry
            # lookup per event would dominate the gauge update itself
            cache = self._gauge_cache
            if cache is None or cache[0] is not m:
                cache = self._gauge_cache = (
                    m, m.gauge("executor_depth"),
                    {i: m.gauge("executor_queue_depth", queue=i)
                     for i in range(len(self._queues))})
            cache[2][queue].set(self._queues[queue].depth)
            cache[1].set(self.depth())

    def export_metrics(self, registry=None, *, span_s: float | None = None):
        """Dump per-queue counters/gauges into an obs registry.

        ``span_s`` defaults to the virtual makespan of the run history, so
        ``executor_utilization`` reports busy-seconds per queue-second over
        the span actually served. Returns the registry written to."""
        m = registry if registry is not None else self.metrics
        if m is None:
            raise ValueError("no registry: pass one or set executor.metrics")
        if span_s is None:
            span_s = (max(t.t_done for t in self.history)
                      - min(t.t_submit for t in self.history)
                      if self.history else 0.0)
        for i, q in enumerate(self._queues):
            m.gauge("executor_queue_depth", queue=i).set(q.depth)
            m.gauge("executor_queue_served", queue=i).set(q.served)
            m.gauge("executor_queue_busy_seconds", queue=i).set(q.busy_s)
        m.gauge("executor_depth").set(self.depth())
        m.gauge("executor_max_depth_seen").set(self.max_depth_seen)
        m.gauge("executor_utilization").set(self.utilization(span_s))
        return m

    # -- queue selection -----------------------------------------------------
    def _select_queue(self, batch, t_ready: float,
                      duration: float) -> tuple[int, float, float]:
        """Work-conserving pick: earliest finish; ties broken by plan-bucket
        affinity, then priority affinity, then index.

        The priority tie-break (TenantSpec.priority, carried on the batch)
        prefers a queue that last served this batch's priority class — under
        contention, priority classes settle onto disjoint queues, so
        best-effort churn stops evicting the premium class's bucket
        affinity. A fresh queue (``last_priority`` None) matches every
        class, and when all traffic shares one priority every queue matches
        always, so the rank ordering reduces exactly to the pre-priority
        ``(done, affinity, index)`` — equal-priority workloads replay
        bit-identically.
        """
        key = getattr(batch, "key", None)
        priority = int(getattr(batch, "priority", 0))
        best = None
        for i, q in enumerate(self._queues):
            start = max(t_ready, q.busy_until)
            dur = duration / q.rate
            done = start + dur
            affinity = 0 if (key is not None and q.last_key == key) else 1
            prio_tie = 0 if q.last_priority in (None, priority) else 1
            rank = (done, affinity, prio_tie, i)
            if best is None or rank < best[0]:
                best = (rank, i, start, dur)
        _, i, start, dur = best
        return i, start, dur

    # -- protocol ------------------------------------------------------------
    def _plan_duration(self, batch, wall_s: float) -> float:
        """Virtual service duration for one batch. Subclass hook — the mesh
        executor evaluates the cost model at its per-shard row count."""
        return self.cost.duration_s(batch, wall_s)

    def submit(self, batch, t_ready: float, *,
               run_fn: Callable | None = None) -> ExecTicket:
        """Run the real compute and plan the batch onto the virtual clock.

        ``run_fn`` overrides the bound callable for this submission — how
        federated gateways share one executor while each supplying their own
        batched decode+restore+forward."""
        run = run_fn if run_fn is not None else self.run_fn
        if run is None:
            raise RuntimeError("executor has no bound run_fn (the gateway "
                               "binds its batched decode+restore+forward at "
                               "construction)")
        logits, wall_s = run(batch)
        duration = self._plan_duration(batch, wall_s)
        i, start, dur = self._select_queue(batch, t_ready, duration)
        q = self._queues[i]
        q.busy_until = start + dur
        q.busy_s += dur
        q.depth += 1
        q.last_key = getattr(batch, "key", None)
        q.last_priority = int(getattr(batch, "priority", 0))
        ticket = ExecTicket(seq=self._seq, batch=batch, t_submit=t_ready,
                            t_start=start, t_done=start + dur,
                            service_s=dur, wall_s=wall_s, queue=i,
                            logits=logits, priority=q.last_priority)
        self._seq += 1
        self.history.append(ticket)
        self._outstanding[ticket.seq] = ticket
        self.max_depth_seen = max(self.max_depth_seen, self.depth())
        self._gauge_depths(i)
        return ticket

    def on_start(self, ticket: ExecTicket) -> None:
        """The ``exec_start`` event: the queue begins serving this batch."""
        ticket.state = "running"

    def complete(self, ticket: ExecTicket) -> None:
        """The ``exec_done`` event: service finished, slot freed.

        Releases the ticket's payload references (batch, logits) — consume
        them *before* completing, or memory grows with the whole workload
        instead of with what is in flight. Timing fields survive for
        post-run introspection (``history`` makespans, replay audits)."""
        if ticket.state == "done":
            raise RuntimeError(f"ticket {ticket.seq} completed twice")
        ticket.state = "done"
        ticket.batch = None
        ticket.logits = None
        self._outstanding.pop(ticket.seq, None)
        q = self._queues[ticket.queue]
        q.depth -= 1
        q.served += 1
        self._gauge_depths(ticket.queue)

    def poll(self, now: float) -> list[ExecTicket]:
        """Tickets whose virtual completion time has passed, in completion
        order — the same order the gateways' exec_done events fire in.
        Scans only outstanding tickets, not the whole run history."""
        out = [t for t in self._outstanding.values() if t.t_done <= now]
        return sorted(out, key=lambda t: (t.t_done, t.seq))

    def drain(self) -> list[ExecTicket]:
        """Every ticket still outstanding, in completion order."""
        return sorted(self._outstanding.values(),
                      key=lambda t: (t.t_done, t.seq))


class SerialExecutor(CloudExecutor):
    """One queue, measured cost by default — the old inline serial cloud."""

    def __init__(self, *, cost: CostModel | None = None):
        super().__init__(queues=[_Queue(rate=1.0)], cost=cost)


class MultiQueueExecutor(CloudExecutor):
    """N parallel queues with per-queue service rates.

    ``rates`` scales each queue's speed (duration / rate); defaults to
    1.0 everywhere. Queue selection is work-conserving and deterministic
    (see :meth:`CloudExecutor._select_queue`)."""

    def __init__(self, n_queues: int = 4, *,
                 rates: "list[float] | tuple[float, ...] | None" = None,
                 cost: CostModel | None = None):
        if n_queues < 1:
            raise ValueError(f"n_queues must be >= 1, got {n_queues}")
        if rates is None:
            rates = [1.0] * n_queues
        rates = [float(r) for r in rates]
        if len(rates) != n_queues:
            raise ValueError(f"{len(rates)} rates for {n_queues} queues")
        if any(r <= 0 for r in rates):
            raise ValueError(f"service rates must be > 0, got {rates}")
        super().__init__(queues=[_Queue(rate=r) for r in rates], cost=cost)


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    reason: str = ""             # set when shed ("" when admitted)


class AdmissionPolicy:
    """Decides, per submission, whether the cloud takes the request.

    Called by the multi-tenant event loop *before* any edge compute or
    encoding is spent on the request. Policies are deterministic functions
    of (tenant, priority, virtual time, executor state); ``reset()`` returns
    them to their initial state so serve runs replay bit-identically."""

    def reset(self) -> None:
        pass

    def admit(self, *, tenant: str, priority: int, t: float,
              executor: CloudExecutor) -> AdmissionDecision:
        raise NotImplementedError


class AlwaysAdmit(AdmissionPolicy):
    def admit(self, *, tenant, priority, t, executor) -> AdmissionDecision:
        return AdmissionDecision(True)


class TokenBucketAdmission(AdmissionPolicy):
    """Per-tenant request-rate token bucket.

    Each tenant's bucket refills at ``rate_per_s`` tokens/second up to
    ``burst``; a submission spends one token or is shed. ``per_tenant``
    overrides ``(rate_per_s, burst)`` for named tenants (e.g. a premium
    tier with a deeper bucket)."""

    def __init__(self, rate_per_s: float, burst: float, *,
                 per_tenant: "dict[str, tuple[float, float]] | None" = None):
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError("token bucket needs rate_per_s > 0, burst > 0")
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst)
        self.per_tenant = dict(per_tenant or {})
        for name, (r, b) in self.per_tenant.items():
            if r <= 0 or b <= 0:
                raise ValueError(f"tenant {name!r}: rate/burst must be > 0")
        self._state: dict[str, tuple[float, float]] = {}  # (tokens, last_t)

    def reset(self) -> None:
        self._state.clear()

    def _params(self, tenant: str) -> tuple[float, float]:
        return self.per_tenant.get(tenant, (self.rate_per_s, self.burst))

    def admit(self, *, tenant, priority, t, executor) -> AdmissionDecision:
        rate, burst = self._params(tenant)
        tokens, last = self._state.get(tenant, (burst, t))
        tokens = min(burst, tokens + rate * max(t - last, 0.0))
        if tokens >= 1.0:
            self._state[tenant] = (tokens - 1.0, t)
            return AdmissionDecision(True)
        self._state[tenant] = (tokens, t)
        return AdmissionDecision(
            False, f"token-bucket: tenant {tenant!r} over {rate:g} req/s "
                   f"(burst {burst:g})")


class QueueDepthAdmission(AdmissionPolicy):
    """Shed when the executor backlog reaches this priority's depth limit.

    ``max_depth`` is the limit for any priority without an explicit entry in
    ``per_priority``. Give higher priorities larger limits and shedding is
    priority-ordered by construction: at any backlog, if a high-priority
    request is shed, every lower-priority request is too (brown-out: best
    effort goes first, premium last)."""

    def __init__(self, max_depth: int, *,
                 per_priority: "dict[int, int] | None" = None):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = int(max_depth)
        self.per_priority = {int(k): int(v)
                             for k, v in (per_priority or {}).items()}
        if any(v < 1 for v in self.per_priority.values()):
            raise ValueError("per-priority depth limits must be >= 1")

    def limit_for(self, priority: int) -> int:
        return self.per_priority.get(int(priority), self.max_depth)

    def admit(self, *, tenant, priority, t, executor) -> AdmissionDecision:
        limit = self.limit_for(priority)
        depth = executor.depth()
        if depth < limit:
            return AdmissionDecision(True)
        return AdmissionDecision(
            False, f"queue-depth {depth}>={limit} (priority {priority})")


class CompositeAdmission(AdmissionPolicy):
    """All sub-policies must admit; the first rejection's reason wins.

    Evaluation short-circuits, so a request shed by an earlier policy never
    spends a later policy's tokens."""

    def __init__(self, policies: "list[AdmissionPolicy]"):
        if not policies:
            raise ValueError("composite admission needs >= 1 policy")
        self.policies = list(policies)

    def reset(self) -> None:
        for p in self.policies:
            p.reset()

    def admit(self, *, tenant, priority, t, executor) -> AdmissionDecision:
        for p in self.policies:
            d = p.admit(tenant=tenant, priority=priority, t=t,
                        executor=executor)
            if not d.admitted:
                return d
        return AdmissionDecision(True)


def priority_depth_limits(base: int, priorities, *,
                          headroom: int | None = None) -> dict[int, int]:
    """Monotone per-priority limits: priority p gets ``base + p*headroom``.

    Convenience for :class:`QueueDepthAdmission` — guarantees the
    shed-priority ordering property (limits non-decreasing in priority).
    ``headroom`` defaults to ``base``."""
    if base < 1:
        raise ValueError("base depth must be >= 1")
    step = base if headroom is None else int(headroom)
    if step < 0:
        raise ValueError("headroom must be >= 0")
    return {int(p): base + int(p) * step for p in priorities}
