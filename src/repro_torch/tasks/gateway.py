"""Multi-task serving: one decoded stream fanned out to N task heads.

Counterpart of ``repro/tasks/gateway.py`` on the port's gateway. Each
micro-batch is decoded once on the host and restored once at its padded
size on the gateway's device (one consolidate launch); every head a tenant
of the batch subscribes to then runs once over the whole restored batch
(the detect head's attention: one flash launch), and its output is copied
to the host once. As in the JAX package, a mesh executor (``run_sharded``)
is refused: the heads take the restored batch inline.

:class:`MultiTaskGateway` extends the event-driven multi-tenant gateway
(serve/gateway.py) with the task layer:

  * each tenant's ``TenantSpec.tasks`` declaration is negotiated once at
    construction against the gateway's capabilities
    (:func:`repro_torch.pipeline.negotiate_tasks`) — unsupported heads
    drop (or refuse) before any traffic flows;
  * per request, the
    :class:`repro_torch.tasks.allocation.BitAllocationController`
    picks the operating point covering exactly the tenant's declared task
    set within the scheduler's remaining budget — a classify-only tenant
    never pays detection-grade bits;
  * per micro-batch, ONE ``plan.decode_batch`` + ONE ``plan.restore`` feed
    every head the batch's tenants subscribe to, each head running exactly
    once over the whole restored batch (``decode_calls``/``head_calls``
    counters expose the invariant; the benchmark gates on it);
  * responses are :class:`MultiTaskResponse` — one output row per declared
    task — with per-task telemetry counters
    (``task_requests_total{tenant=,task=}``) and per-head ``head.<task>``
    trace spans on the executor track.

Replay: allocation, negotiation, and head fan-out are all deterministic, so
a repeated workload under a deterministic executor cost model
(``LinearCostModel``) reproduces responses bit-identically.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.split import check_device
from repro_torch.pipeline import negotiate_tasks
from repro_torch.serve.batcher import EncodedRequest, MicroBatch
from repro_torch.serve.executor import ExecTicket
from repro_torch.serve.gateway import MultiTenantGateway
from repro_torch.serve.telemetry import Telemetry
from repro_torch.tasks.allocation import BitAllocationController
from repro_torch.tasks.heads import HeadConfig, get_head, run_heads


@dataclass
class MultiTaskResponse:
    """One request's fan-out outcome: an output row per declared task."""
    req_id: int
    outputs: dict                 # task -> np.ndarray (this request's row)
    tasks: tuple                  # effective (negotiated) declared task set
    op: object                    # OperatingPoint the stream was coded at
    stats: object                 # SplitStats wire accounting

    @property
    def shed(self) -> bool:       # duck-type discriminator vs RequestShed
        return False

    @property
    def logits(self) -> np.ndarray:
        """Back-compat single-consumer view: the classify row when that head
        was declared, else the first declared task's output."""
        if "classify" in self.outputs:
            return self.outputs["classify"]
        return self.outputs[sorted(self.outputs)[0]]


class MultiTaskGateway(MultiTenantGateway):
    """Event-driven multi-tenant serving where each tenant subscribes to a
    declared subset of the registered task heads.

    Parameters (beyond :class:`MultiTenantGateway`)
    ----------
    head_bank : {task: head module} (tasks/heads.init_head_bank), on the
        gateway's device; its key set is the gateway's full head set — a
        tenant with an empty declaration subscribes to all of it
    head_cfg  : HeadConfig the bank was initialized with
    allocator : BitAllocationController splitting each tenant's budget
        across its declared task set (None = the inherited controller /
        default-op path picks the operating point; declarations still
        bound which heads run and which outputs are returned)
    """

    def __init__(self, params, baf_bank: dict, *, tenants, head_bank: dict,
                 head_cfg: HeadConfig,
                 allocator: BitAllocationController | None = None, **kw):
        super().__init__(params, baf_bank, tenants=tenants, **kw)
        if self._run_fn == self._run_batch_mesh:
            raise NotImplementedError(
                "MultiTaskGateway fans the restored batch out to task heads "
                "inline; mesh (run_sharded) executors are not supported")
        if not head_bank:
            raise ValueError("empty head bank")
        for name in head_bank:
            get_head(name)               # unknown head names fail loudly here
        check_device(self.device, **{
            f"head_{n}": m for n, m in head_bank.items()
            if next(m.parameters(), None) is not None})
        self.head_bank = dict(head_bank)
        self.head_cfg = head_cfg
        self.allocator = allocator
        all_heads = tuple(sorted(head_bank))
        if allocator is not None:
            missing = [t for t in all_heads if t not in allocator.tables]
            if missing:
                raise ValueError(f"allocator has no RD table for heads "
                                 f"{missing}")
        self.task_sets: dict[str, tuple] = {}
        for spec in self.specs.values():
            declared = spec.tasks if spec.tasks else all_heads
            unknown = [t for t in declared if t not in head_bank]
            if unknown:
                raise ValueError(f"tenant {spec.name!r} declares tasks "
                                 f"{unknown} with no head in the bank "
                                 f"{list(all_heads)}")
            self.task_sets[spec.name] = negotiate_tasks(declared,
                                                        self.capabilities)
        # "" is the single-tenant sentinel (ServingGateway.serve): full set
        self.task_sets[""] = negotiate_tasks(all_heads, self.capabilities)
        # one-decode-fan-out invariant counters (benchmarks gate on these)
        self.decode_calls = 0
        self.head_calls: dict[str, int] = {}

    def _tasks_for(self, tenant: str) -> tuple:
        return self.task_sets[tenant]

    # -- edge side ----------------------------------------------------------
    def _pick_tenant_op(self, spec, z, budget):
        if self.allocator is None:
            return super()._pick_tenant_op(spec, z, budget)
        decision = self.allocator.select(self._tasks_for(spec.name), budget)
        return self._fit_op(decision.op)

    # -- cloud side ---------------------------------------------------------
    def _run_batch(self, batch: MicroBatch):
        """ONE decode + ONE restore; every subscribed head runs once over
        the whole restored batch. Returns ({task: outputs}, wall_s); the
        clock stops after the last head's output is copied to the host,
        which waits for the card."""
        plan = self.plan_for(batch.key.op)
        # repro_torch: allow[RA01] -- warm-timing helper: measures real
        # compute wall for the cost model, never replayed state
        t0 = time.perf_counter()
        decoded = plan.decode_batch([r.blob for r in batch.requests])
        z_tilde = plan.restore(decoded.pad_to(batch.padded_size))
        needed = sorted({t for r in batch.requests
                         for t in self._tasks_for(r.tenant)})
        outputs = run_heads(self.params, self.head_bank, z_tilde, needed,
                            self.head_cfg)
        self.decode_calls += 1
        for task in needed:
            self.head_calls[task] = self.head_calls.get(task, 0) + 1
        # repro_torch: allow[RA01] -- warm-timing helper (see t0 above)
        return outputs, time.perf_counter() - t0

    # -- response fan-out ---------------------------------------------------
    def _response_for(self, req: EncodedRequest, ticket: ExecTicket,
                      row: int, op, stats) -> MultiTaskResponse:
        tasks = self._tasks_for(req.tenant)
        return MultiTaskResponse(
            req_id=req.req_id,
            outputs={t: ticket.logits[t][row] for t in tasks},
            tasks=tasks, op=op, stats=stats)

    def _exec_batch_spans(self, tracer, ticket: ExecTicket) -> None:
        super()._exec_batch_spans(tracer, ticket)
        for task in sorted(ticket.logits):
            tracer.span(f"head.{task}", ticket.t_start, ticket.t_done,
                        track=f"exec-q{ticket.queue}", seq=ticket.seq,
                        task=task, n_requests=len(ticket.batch.requests))

    def _post_record(self, req: EncodedRequest, out,
                     telemetry: Telemetry) -> None:
        for task in out.tasks:
            telemetry.metrics.counter("task_requests_total",
                                      tenant=req.tenant, task=task).inc()
