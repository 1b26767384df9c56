"""Bit allocation across a tenant's declared task set.

Copy of ``repro/tasks/allocation.py`` for the port (pure host code).

One encoded stream feeds every head, so "allocation" picks the single
operating point whose wire bits cover ALL declared tasks' quality floors —
the weighted-Lagrangian view of Alvar & Bajić 2020 collapsed onto the
shared-stream constraint: the op's cost is paid once, each task prices it
through its own distortion table, and the weight vector decides who is
degraded first when the budget cannot cover everyone.

Selection policy (deterministic, replay-identical):

  1. candidates = operating points present in every declared task's table,
     sorted by (bits, op identity);
  2. among candidates fitting the bit budget, take the CHEAPEST point that
     meets every declared task's quality floor (ties: higher weighted
     quality). Cheapest-first (not budget-filling) makes allocation
     monotone: declaring fewer tasks removes constraints and can never
     cost more bits — the property tenants' billing relies on. (The
     guarantee is for the non-degraded regime — every declared floor
     servable within budget; once relaxation kicks in, a low-weight task
     may be sacrificed entirely, and a larger set that sacrifices it can
     legitimately be cheaper than the small set that must serve it);
  3. under pressure (no fitting point meets all floors), relax floors in
     ascending weight order — the lowest-weight task is degraded first and
     recorded as such, mirroring the session QoS ladder's
     degrade-before-shed shape — and retry;
  4. if every floor has been relaxed, serve best-effort: the fitting point
     with the highest weighted quality (nothing fits at all -> the
     globally cheapest point, never a drop).

The per-task bit attribution splits the chosen point's wire bits across
declared tasks proportionally to weight — an accounting view for telemetry
and billing; the stream itself is shared.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.serve.rate_control import RDPoint


@dataclass(frozen=True)
class AllocationDecision:
    """One deterministic allocation outcome for a declared task set."""
    op: object                               # OperatingPoint
    bits_per_example: float                  # shared-stream wire cost
    per_task_quality_db: tuple               # ((task, quality_db), ...) sorted
    per_task_bits: tuple                     # ((task, attributed bits), ...)
    degraded: tuple                          # tasks whose floor was relaxed,
                                             # in relaxation order

    def quality_db(self, task: str) -> float:
        return dict(self.per_task_quality_db)[task]


def _op_sort_key(op) -> tuple:
    return (op.c, op.bits, op.backend, op.tiling, op.context, op.profile)


class BitAllocationController:
    """Splits a tenant's channel budget across its declared task set.

    tables  : {task: [RDPoint]} from tasks/distortion.py —
              ``psnr_db`` = task quality dB, shared ``bits_per_example``
    weights : {task: weight > 0} (default 1.0) — degrade order and tie-breaks
    floors  : {task: quality floor dB} (default ``default_floor_db``)
    default_floor_db : floor for tasks absent from ``floors``
                       (-inf = no floor: that task never constrains)
    """

    def __init__(self, tables: dict, *, weights: dict | None = None,
                 floors: dict | None = None,
                 default_floor_db: float = -math.inf):
        if not tables:
            raise ValueError("empty task table set")
        self.tables = {t: list(pts) for t, pts in sorted(tables.items())}
        for t, pts in self.tables.items():
            if not pts:
                raise ValueError(f"task {t!r}: empty RD table")
        self.tasks = tuple(sorted(self.tables))
        weights = dict(weights or {})
        for t, w in weights.items():
            if w <= 0:
                raise ValueError(f"task {t!r}: weight must be > 0, got {w}")
        self.weights = {t: float(weights.get(t, 1.0)) for t in self.tasks}
        floors = dict(floors or {})
        self.floors = {t: float(floors.get(t, default_floor_db))
                       for t in self.tasks}
        # op identity -> {task: RDPoint}; only ops every table prices are
        # candidates (an op one task cannot price cannot serve that task)
        by_op: dict[tuple, dict] = {}
        for t in self.tasks:
            for p in self.tables[t]:
                by_op.setdefault(_op_sort_key(p.op), {})[t] = p
        self._by_op = by_op

    def weight(self, task: str) -> float:
        return self.weights[task]

    def floor(self, task: str) -> float:
        return self.floors[task]

    def _declared(self, tasks) -> tuple:
        declared = tuple(sorted(set(tasks)))
        if not declared:
            raise ValueError("empty declared task set")
        unknown = [t for t in declared if t not in self.tables]
        if unknown:
            raise KeyError(f"no RD table for tasks {unknown} "
                           f"(have {list(self.tasks)})")
        return declared

    def _candidates(self, declared) -> list:
        """[(bits, op_key, point_by_task)] sorted by (bits, op identity)."""
        out = []
        for op_key, pts in self._by_op.items():
            if all(t in pts for t in declared):
                bits = max(pts[t].bits_per_example for t in declared)
                out.append((bits, op_key, pts))
        if not out:
            raise ValueError(f"no operating point is priced by every task "
                             f"in {list(declared)}")
        out.sort(key=lambda c: (c[0], c[1]))
        return out

    def _weighted_quality(self, declared, pts) -> float:
        return sum(self.weights[t] * pts[t].psnr_db for t in declared)

    def select(self, tasks, bit_budget: float | None = None
               ) -> AllocationDecision:
        """Deterministic operating-point choice for one declared task set."""
        declared = self._declared(tasks)
        budget = math.inf if bit_budget is None else float(bit_budget)
        cands = self._candidates(declared)
        fitting = [c for c in cands if c[0] <= budget]
        degraded: list = []
        if not fitting:
            # nothing fits: cheapest overall, every unmet floor is degraded
            bits, _, pts = cands[0]
            degraded = [t for t in declared
                        if pts[t].psnr_db < self.floors[t]]
            return self._decision(declared, bits, pts, degraded)
        # degrade-before-shed: relax floors in ascending weight order
        relax_order = sorted(declared, key=lambda t: (self.weights[t], t))
        active = set(declared)
        while True:
            if not active:
                # every floor relaxed: best-effort, not cheapest — the
                # budget is already being paid, spend it on quality
                bits, _, pts = max(
                    fitting,
                    key=lambda c: (self._weighted_quality(declared, c[2]),
                                   -c[0]))
                return self._decision(declared, bits, pts, degraded)
            meeting = [c for c in fitting
                       if all(c[2][t].psnr_db >= self.floors[t]
                              for t in active)]
            if meeting:
                bits, _, pts = min(
                    meeting,
                    key=lambda c: (c[0],
                                   -self._weighted_quality(declared, c[2]),
                                   c[1]))
                return self._decision(declared, bits, pts, degraded)
            drop = next(t for t in relax_order if t in active)
            active.discard(drop)
            degraded.append(drop)

    def _decision(self, declared, bits, pts, degraded) -> AllocationDecision:
        total_w = sum(self.weights[t] for t in declared)
        return AllocationDecision(
            op=pts[declared[0]].op,
            bits_per_example=float(bits),
            per_task_quality_db=tuple((t, float(pts[t].psnr_db))
                                      for t in declared),
            per_task_bits=tuple((t, float(bits) * self.weights[t] / total_w)
                                for t in declared),
            degraded=tuple(degraded))

    def independent_bits(self, tasks, bit_budget: float | None = None
                         ) -> float:
        """Total wire bits if every declared task ran its OWN stream —
        each task independently picks its cheapest floor-meeting point.
        The benchmark's baseline the shared stream must beat."""
        declared = self._declared(tasks)
        return sum(self.select((t,), bit_budget).bits_per_example
                   for t in declared)
