"""Multi-tenant uplink scheduling for the serving gateway.

Copy of ``repro/serve/scheduler.py`` for the port (stdlib only).

The ROADMAP's north star is many concurrent consumers sharing a
bandwidth-constrained edge->cloud fabric (paper Fig. 1 at fleet scale). This
module adds the missing arbitration layer: N tenants, each with its own
request queue, channel, and quality floor, compete for a *shared* per-tick
bit budget. Following the multi-task bit-allocation line of work (Alvar &
Bajić 2020), the scheduler decides per tick who sends what:

  * **Deficit round robin (DRR)** over tenants: every scheduling round a
    tenant earns ``quantum_bits * weight`` of credit ("deficit"); its
    head-of-line job is granted once the credit covers the job's wire bits
    and the tick budget has room. Weighted fairness + O(1) per decision.
  * **Starvation freedom**: the rotation start advances every tick and
    credit persists across ticks, so a backlogged tenant cannot be locked
    out by a saturating neighbour — its head job is granted after a bounded
    number of ticks.
  * **Budget conservation**: the sum of granted bits inside one tick window
    never exceeds ``budget_bits_per_tick`` (``tick_grants`` keeps the audit
    trail; an oversize job — larger than a whole tick budget — consumes its
    tick exclusively, mirroring the channel's spanning-packet rule).
  * **Determinism**: no wall clock, no randomness — given the same enqueue
    sequence the grant sequence is bit-identical (the replay tests pin this).

The scheduler only *orders and meters* jobs; transmission timing stays in
each tenant's :class:`repro_torch.serve.channel.SimulatedChannel`
(construct those unmetered — the shared budget lives here, per-link
serialization there).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable


@dataclass(frozen=True)
class TenantSpec:
    """Static per-tenant policy: DRR weight, an optional quality floor
    override consulted by the rate controller (None = controller default),
    the priority class admission control sheds by (higher = shed later;
    see repro_torch.serve.executor.QueueDepthAdmission), and the declared task
    set — which downstream heads this tenant consumes (empty = undeclared:
    a task-aware gateway serves its full head set; see repro.tasks). The
    declaration is negotiated against the gateway's capabilities
    (pipeline.negotiate_tasks) and drives bit allocation, so a tenant
    declaring only ``classify`` never pays detection-grade bits."""
    name: str
    weight: float = 1.0
    quality_floor_db: float | None = None
    priority: int = 0
    tasks: tuple = ()

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if not isinstance(self.tasks, tuple):
            object.__setattr__(self, "tasks", tuple(self.tasks))
        if any(not isinstance(t, str) or not t for t in self.tasks):
            raise ValueError(f"tenant {self.name!r}: tasks must be non-empty "
                             f"head names, got {self.tasks!r}")


@dataclass
class UplinkJob:
    """One encoded request waiting for an uplink grant."""
    tenant: str
    req_id: int              # per-tenant sequence number
    bits: int                # true wire cost: 8 * len(serialized container)
                             # (header + side info + entropy-coded payload)
    t_enqueue: float         # virtual time the edge finished encoding
    payload: Any = None      # opaque (op, enc, stats, ...) carried through


@dataclass
class _TenantQueue:
    spec: TenantSpec
    queue: deque = field(default_factory=deque)
    deficit: float = 0.0
    enqueued_bits: int = 0
    granted_bits: int = 0
    granted_jobs: int = 0


class DeficitRoundRobinScheduler:
    """Weighted DRR over per-tenant queues under a shared per-tick bit budget.

    Parameters
    ----------
    tenants : tenant specs (order fixes the base rotation order)
    budget_bits_per_tick : shared uplink budget per ``tick_s`` window
                           (None = unmetered: pure round-robin interleave)
    tick_s : budget accounting window on the virtual clock
    quantum_bits : DRR credit per round per unit weight; default is a quarter
                   of the per-weight tick budget, so a full rotation spends
                   at most ~1/4 tick and head-of-line jobs cannot monopolize
    """

    def __init__(self, tenants: Iterable[TenantSpec], *,
                 budget_bits_per_tick: int | None = None,
                 tick_s: float = 1.0, quantum_bits: int | None = None):
        specs = list(tenants)
        if not specs:
            raise ValueError("need at least one tenant")
        names = [t.name for t in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        if tick_s <= 0:
            raise ValueError("tick_s must be > 0")
        self.tenants: dict[str, _TenantQueue] = {
            t.name: _TenantQueue(spec=t) for t in specs}
        self.budget_bits_per_tick = budget_bits_per_tick
        self.tick_s = tick_s
        if quantum_bits is None:
            total_w = sum(t.weight for t in specs)
            if budget_bits_per_tick is not None:
                quantum_bits = max(1, int(budget_bits_per_tick
                                          / (4.0 * total_w)))
            else:
                quantum_bits = 1            # unused when unmetered
        self.quantum_bits = quantum_bits
        self.tick_grants: dict[int, int] = {}   # tick index -> bits granted
        self._rr_start = 0
        self._order = names
        self._metrics = None

    def bind_metrics(self, registry) -> None:
        """Mirror grant accounting into an obs.MetricsRegistry: per-tenant
        ``sched_granted_bits_total``/``sched_granted_jobs_total`` counters
        and a live ``sched_backlog_jobs`` gauge.

        All handles resolve once here: enqueue/grant run per request and
        must not pay a registry lookup each time."""
        self._metrics = registry
        self._m_backlog = registry.gauge("sched_backlog_jobs")
        self._m_tenant = {
            name: (registry.counter("sched_enqueued_bits_total", tenant=name),
                   registry.counter("sched_granted_bits_total", tenant=name),
                   registry.counter("sched_granted_jobs_total", tenant=name))
            for name in self._order}

    # -- queue side ---------------------------------------------------------
    def enqueue(self, job: UplinkJob) -> None:
        tq = self.tenants.get(job.tenant)
        if tq is None:
            raise KeyError(f"unknown tenant {job.tenant!r}")
        if job.bits <= 0:
            raise ValueError(f"job bits must be > 0, got {job.bits}")
        tq.queue.append(job)
        tq.enqueued_bits += job.bits
        if self._metrics is not None:
            self._m_tenant[job.tenant][0].inc(job.bits)
            self._m_backlog.set(self.pending())

    def pending(self) -> int:
        return sum(len(t.queue) for t in self.tenants.values())

    # -- tick geometry ------------------------------------------------------
    def tick_of(self, t: float) -> int:
        return int(math.floor(t / self.tick_s))

    def next_tick_time(self, t: float) -> float:
        return (self.tick_of(t) + 1) * self.tick_s

    def budget_remaining(self, t: float) -> float:
        """Bits still grantable in the tick containing ``t`` — the quantity
        the rate controller keys operating points on."""
        if self.budget_bits_per_tick is None:
            return math.inf
        used = self.tick_grants.get(self.tick_of(t), 0)
        return self.budget_bits_per_tick - used

    # -- grant side ---------------------------------------------------------
    def drain(self, now: float) -> list[UplinkJob]:
        """Grant as much queued work as ``now``'s tick allows; DRR order.

        Returns granted jobs in grant order. Call again in a later tick for
        whatever remains (``pending()``).
        """
        tick = self.tick_of(now)
        per_tick = self.budget_bits_per_tick
        remaining = (math.inf if per_tick is None
                     else per_tick - self.tick_grants.get(tick, 0))
        order = [self.tenants[n] for n in
                 self._order[self._rr_start:] + self._order[:self._rr_start]]
        self._rr_start = (self._rr_start + 1) % len(self._order)

        granted: list[UplinkJob] = []
        if per_tick is None:
            # unmetered: no budget to apportion, so skip credit accrual
            # (which would cost O(job_bits / quantum) rounds per job) and
            # interleave head-of-line jobs round-robin until queues drain
            while self.pending():
                for tq in order:
                    if tq.queue:
                        job = tq.queue.popleft()
                        self._account(tick, tq, job)
                        granted.append(job)
            return granted
        while remaining > 0 and self.pending():
            # work conservation: keep cycling DRR rounds (credit accrues
            # every round) as long as SOME head-of-line job could still be
            # granted in this tick; stop only when nothing fits
            def _head_can_go(tq: _TenantQueue) -> bool:
                if not tq.queue:
                    return False
                bits = tq.queue[0].bits
                return (bits <= remaining
                        or (per_tick is not None and bits > per_tick
                            and remaining == per_tick))
            if not any(_head_can_go(tq) for tq in order):
                break
            for tq in order:
                if not tq.queue:
                    tq.deficit = 0.0        # classic DRR: no credit hoarding
                    continue
                tq.deficit += self.quantum_bits * tq.spec.weight
                while tq.queue and tq.queue[0].bits <= tq.deficit:
                    job = tq.queue[0]
                    if job.bits <= remaining:
                        tq.queue.popleft()
                        tq.deficit -= job.bits
                        remaining -= job.bits
                        self._account(tick, tq, job)
                        granted.append(job)
                    elif (per_tick is not None and job.bits > per_tick
                          and remaining == per_tick):
                        # oversize job on a fresh tick: ship it alone and
                        # close the tick (spanning-packet rule)
                        tq.queue.popleft()
                        tq.deficit = 0.0
                        remaining = 0
                        self._account_spanning(tick, tq, job, per_tick)
                        granted.append(job)
                        break
                    else:
                        break               # retry next tick
                if remaining <= 0:
                    break
        return granted

    def _account(self, tick: int, tq: _TenantQueue, job: UplinkJob) -> None:
        self.tick_grants[tick] = self.tick_grants.get(tick, 0) + job.bits
        tq.granted_bits += job.bits
        tq.granted_jobs += 1
        self._account_metrics(job)

    def _account_metrics(self, job: UplinkJob) -> None:
        if self._metrics is not None:
            _, bits, jobs = self._m_tenant[job.tenant]
            bits.inc(job.bits)
            jobs.inc()
            self._m_backlog.set(self.pending())

    def _account_spanning(self, tick: int, tq: _TenantQueue, job: UplinkJob,
                          per_tick: int) -> None:
        """Charge an oversize job across this and future ticks so per-tick
        conservation (``tick_grants[i] <= budget``) holds exactly."""
        left = job.bits
        while left > 0:
            room = per_tick - self.tick_grants.get(tick, 0)
            spend = min(left, room)
            if spend > 0:
                self.tick_grants[tick] = self.tick_grants.get(tick, 0) + spend
                left -= spend
            tick += 1
        tq.granted_bits += job.bits
        tq.granted_jobs += 1
        self._account_metrics(job)

    # -- introspection ------------------------------------------------------
    def grant_shares(self) -> dict[str, float]:
        """Fraction of total granted bits per tenant (fairness reporting)."""
        total = sum(t.granted_bits for t in self.tenants.values())
        if total == 0:
            return {n: 0.0 for n in self._order}
        return {n: self.tenants[n].granted_bits / total for n in self._order}
