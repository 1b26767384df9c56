"""Collaborative-intelligence serving gateway — multi-client split inference.

Counterpart of ``repro/serve/gateway.py``. Turns the single-shot
:class:`repro_torch.core.split.SplitInferenceEngine` into a service loop over
many concurrent requests (paper Fig. 1 at serving scale):

    edge forward -> rate control picks an OperatingPoint -> negotiate against
    gateway capabilities -> plan.encode (quantize and histogram kernels) ->
    simulated channel -> micro-batch (wire blobs) -> plan.decode_batch
    (vectorized host decode) -> BaF restore (+ the consolidate kernel) ->
    cloud forward -> respond, with per-request telemetry.

The gateway runs on ``device`` (``None`` = the card), where the CNN and the
BaF bank must live; each request's image arrives as numpy and is moved to
the device once. With a :class:`repro_torch.serve.mesh_executor.MeshExecutor`
the restore and the cloud forward run sharded over its mesh of devices.

All coding state flows through :mod:`repro_torch.pipeline`: the rate
controller hands back an :class:`OperatingPoint`, the gateway compiles (cached) one
:class:`CompressionPlan` per point against its per-C model specs, and every
stage reads configuration from the plan — no loose ``(C, bits, backend)``
tuples.

Design points:
  * the rate controller (serve/rate_control.py) consults the channel's
    remaining bit budget per request, so operating points adapt to congestion;
  * ``capabilities`` (repro_torch.pipeline.Capabilities) lets a gateway
    refuse — or downgrade — operating points whose wire profile or backend
    it does not speak, *before* any bytes are encoded;
  * each C has its own BaF predictor (its input width is C) — the gateway
    holds a bank ``{c: (BaFConv, sel_idx)}`` compiled into per-C
    ``ModelSpec``s;
  * the micro-batcher (serve/batcher.py) buckets *encoded* requests by
    ``(operating point, H, W)``; decode runs once per micro-batch through
    ``plan.decode_batch`` — the per-channel host numpy loops coalesce across
    the whole bucket — and the restore + cloud forward run once per bucket
    at a padded bucket size, never per request;
  * the cloud's service capacity is a pluggable
    :class:`repro_torch.serve.executor.CloudExecutor`: flushed buckets are
    ``submit``-ted and come back as tickets with virtual start/done times
    (``SerialExecutor`` = the single serial cloud, the default;
    ``MultiQueueExecutor`` = N parallel replicas), and an optional
    ``AdmissionPolicy`` sheds excess load explicitly before any edge
    compute is spent;
  * transport and cloud-service timing run on a deterministic virtual
    clock; the real compute's wall time is measured separately (and is the
    virtual duration under the default ``MeasuredCost`` model). It ends
    after the logits' copy to the host, so it includes the card's work.
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import pipeline
from repro_torch.core.split import (SplitStats, activation_stats,
                                    check_device, cnn_fns, to_device)
from repro_torch.device import resolve_device
from repro_torch.obs import hooks
from repro_torch.pipeline import (Capabilities, ModelSpec, OperatingPoint,
                                  negotiate)
from repro_torch.serve.batcher import EncodedRequest, MicroBatch, MicroBatcher
from repro_torch.serve.channel import (ChannelConfig, SimulatedChannel,
                                       Transmission)
from repro_torch.serve.executor import (AdmissionPolicy, CloudExecutor,
                                        ExecTicket, RequestShed,
                                        SerialExecutor)
from repro_torch.serve.rate_control import (ContentKeyedController,
                                            RateController)
from repro_torch.serve.scheduler import (DeficitRoundRobinScheduler,
                                         TenantSpec, UplinkJob)
from repro_torch.serve.telemetry import RequestRecord, ShedRecord, Telemetry


@dataclass
class GatewayResponse:
    req_id: int
    logits: np.ndarray            # (num_classes,)
    op: OperatingPoint
    stats: SplitStats             # wire accounting for this request

    @property
    def shed(self) -> bool:       # duck-type discriminator vs RequestShed
        return False


class ServingGateway:
    """Orchestrates decode -> batch -> restore -> cloud for many clients.

    Parameters
    ----------
    params : the CNN (models/cnn.py), on ``device``
    baf_bank : {c: (BaFConv, sel_idx)} — BaF predictor + channel order per C,
              on ``device``
    channel : SimulatedChannel or None (None = ideal wire, zero latency)
    controller : RateController or None (None = fixed ``default_op``)
    default_op : operating point used when no controller is given
    backend : legacy override — when set, every selected operating point is
              re-based onto this entropy backend (None = respect the point's
              own backend, the plan-API default)
    capabilities : what this gateway speaks; selected operating points are
              negotiated against it (refuse or downgrade) before encoding
    max_batch : micro-batch cap (1 = naive one-at-a-time serving)
    fused : restore through the consolidate kernel (``fused=False``: the
              plain torch consolidation)
    executor : CloudExecutor modeling the cloud's service capacity on the
              virtual clock (None = SerialExecutor(), one serial cloud
              queue)
    tracer : repro_torch.obs.Tracer collecting virtual-clock span trees
              (None = tracing off, zero per-request overhead beyond an is-None
              check); reassignable between serve runs
    metrics : repro_torch.obs.MetricsRegistry shared across telemetry,
              executor gauges, scheduler and channel counters (None = each
              serve run's Telemetry keeps a private registry)
    device : where the plans, the CNN and the BaF bank run (None = the card)
    """

    def __init__(self, params, baf_bank: dict, *,
                 channel: SimulatedChannel | None = None,
                 controller: RateController | None = None,
                 default_op: OperatingPoint | None = None,
                 backend: str | None = None, max_batch: int = 8,
                 fused: bool = True,
                 capabilities: Capabilities | None = None,
                 executor: CloudExecutor | None = None,
                 shared_executor: bool = False,
                 tracer=None, metrics=None, device=None):
        if not baf_bank:
            raise ValueError("empty BaF bank")
        self.device = resolve_device(device)
        check_device(self.device, params=params,
                     **{f"baf_c{c}": p for c, (p, _) in baf_bank.items()})
        self.params = params
        self.baf_bank = {int(c): (p, np.asarray(s))
                         for c, (p, s) in baf_bank.items()}
        self._specs = {c: ModelSpec(sel_idx=s, params=params, baf_params=p)
                       for c, (p, s) in self.baf_bank.items()}
        self.channel = channel
        self.controller = controller
        self.backend = backend
        self.capabilities = capabilities
        if default_op is None:
            c = max(self.baf_bank)
            default_op = OperatingPoint(c=c, bits=8)
        self.default_op = self._fit_op(default_op)
        self.max_batch = max_batch
        self.fused = fused
        self.tracer = tracer
        self.metrics = metrics
        self.executor = executor if executor is not None else SerialExecutor()
        if shared_executor and executor is None:
            raise ValueError("shared_executor=True needs the shared executor "
                             "passed explicitly")
        self.shared_executor = shared_executor
        if metrics is not None:
            if not shared_executor:
                self.executor.metrics = metrics
            if channel is not None:
                channel.bind_metrics(metrics, tenant="")
        # a mesh-capable executor (duck-typed on run_sharded) takes restore +
        # cloud forward through its sharded runner; plain executors run the
        # whole batch inline here
        self._run_fn = (self._run_batch_mesh
                        if callable(getattr(self.executor, "run_sharded",
                                            None))
                        else self._run_batch)
        if not shared_executor:
            if self.executor.run_fn is not None:
                # an exclusively-owned executor binds one gateway's batched
                # decode+restore+forward; a second binder would silently run
                # the first gateway's plans against its own blobs (and each
                # serve() resets the other's queues mid-use). Federations
                # pass shared_executor=True and supply run_fn per submit.
                raise ValueError("executor is already bound to another "
                                 "gateway; construct one executor per "
                                 "gateway (or build every gateway with "
                                 "shared_executor=True to federate)")
            self.executor.run_fn = self._run_fn
        # the CNN's halves, bound once: edge(img) -> z, cloud(z) -> logits
        self._edge_fn, self._cloud_fn = cnn_fns(params)

    # -- plans --------------------------------------------------------------
    def _fit_op(self, op: OperatingPoint) -> OperatingPoint:
        """Re-base onto the legacy backend override, negotiate against the
        gateway's capabilities, and check the BaF bank covers the C."""
        if self.backend is not None and op.backend != self.backend:
            op = op.with_backend(self.backend)
        op = negotiate(op, self.capabilities)
        if op.c not in self.baf_bank:
            raise ValueError(f"operating point picked C={op.c} with no BaF "
                             f"predictor in the bank {sorted(self.baf_bank)}")
        return op

    def plan_for(self, op: OperatingPoint) -> pipeline.CompressionPlan:
        """The (cached) compression plan this gateway executes for ``op``."""
        return pipeline.compile(op, self._specs[op.c], fused=self.fused,
                                device=self.device)

    def _to_device(self, img) -> torch.Tensor:
        """One request's image (numpy, (H, W, 3) or (1, H, W, 3)) as a
        float32 (1, H, W, 3) tensor on the gateway's device: one copy."""
        img = np.asarray(img)
        return to_device(img[None] if img.ndim == 3 else img, self.device)

    # -- edge side ----------------------------------------------------------
    def _pick_op(self, t_submit: float) -> OperatingPoint:
        if self.controller is None:
            return self.default_op
        budget = (self.channel.budget_remaining(at=t_submit)
                  if self.channel is not None else None)
        return self._fit_op(self.controller.select(budget).op)

    def encode_request(self, img, t_submit: float = 0.0):
        """Edge-side work for one request: rate control + encode + transmit.

        img: (1, H, W, 3). Returns (op, WireBlob, SplitStats, Transmission).
        The blob is serialized here — the channel meters its true byte
        length (container header + side info + entropy-coded payload).
        """
        with hooks.timed("gateway.encode_request"):
            op = self._pick_op(t_submit)
            plan = self.plan_for(op)
            z = self._edge_fn(self._to_device(img))
            blob = plan.encode(z)
            if self.channel is not None:
                tx = self.channel.transmit_bytes(blob.data, t_submit)
            else:
                tx = Transmission(bits=8 * blob.nbytes, t_submit=t_submit,
                                  t_start=t_submit, t_arrive=t_submit)
        return op, blob, blob.stats, tx

    # -- cloud side ---------------------------------------------------------
    def _run_batch(self, batch: MicroBatch) -> tuple[np.ndarray, float]:
        """Batched decode + restore + cloud forward; measured wall time.

        The host decode runs once per micro-batch (plan.decode_batch). The
        restore and the cloud forward run at the padded bucket size; the
        padding rows' logits are dropped by the callers (they read one row
        per request). The clock stops after the logits' copy to the host,
        which waits for the card, so the measured time includes its work
        (it feeds MeasuredCost / CalibratedCostModel, never the virtual
        clock otherwise).
        """
        plan = self.plan_for(batch.key.op)
        # repro_torch: allow[RA01] -- warm-timing helper: measures real
        # compute wall for the cost model, never replayed state
        t0 = time.perf_counter()
        with hooks.timed("gateway.run_batch"):
            decoded = plan.decode_batch([r.blob for r in batch.requests])
            z_tilde = plan.restore(decoded.pad_to(batch.padded_size))
            out = self._cloud_fn(z_tilde)
            with hooks.timed("gateway.to_host"):
                logits = out.cpu().numpy()
        # repro_torch: allow[RA01] -- warm-timing helper (see t0 above)
        return logits, time.perf_counter() - t0

    def _run_batch_mesh(self, batch: MicroBatch) -> tuple[np.ndarray, float]:
        """Batched decode on the host, restore + cloud forward on the mesh.

        Same contract as :meth:`_run_batch` (logits rows align with
        ``batch.requests``, measured wall time), but the device half runs
        through the executor's ``run_sharded``; the clock stops once the
        logits are on the host."""
        plan = self.plan_for(batch.key.op)
        # repro_torch: allow[RA01] -- warm-timing helper: measures real
        # compute wall for the cost model, never replayed state
        t0 = time.perf_counter()
        with hooks.timed("gateway.run_batch"):
            decoded = plan.decode_batch([r.blob for r in batch.requests])
            logits = self.executor.run_sharded(plan, decoded,
                                               batch.padded_size)
        # repro_torch: allow[RA01] -- warm-timing helper (see t0 above)
        return logits, time.perf_counter() - t0

    def _response_for(self, req: EncodedRequest, ticket: ExecTicket,
                      row: int, op, stats):
        """Build one request's response from its executor ticket row.

        Subclass hook: a task-aware gateway returns a fan-out response
        carrying each of the tenant's declared head outputs (repro.tasks);
        the base gateway returns the single-consumer logits row."""
        return GatewayResponse(req_id=req.req_id, logits=ticket.logits[row],
                               op=op, stats=stats)

    def _exec_batch_spans(self, tracer, ticket: ExecTicket) -> None:
        """Emit batch-level spans for one executor ticket (tracer != None).

        Subclass hook: a task-aware gateway adds per-head ``head.<task>``
        child spans alongside the base ``exec.batch`` span."""
        batch = ticket.batch
        tracer.span("exec.batch", ticket.t_start, ticket.t_done,
                    track=f"exec-q{ticket.queue}", seq=ticket.seq,
                    n_requests=len(batch.requests),
                    padded_size=batch.padded_size)

    def _post_record(self, req: EncodedRequest, out,
                     telemetry: Telemetry) -> None:
        """Per-request hook after telemetry.record (base: no-op).

        A task-aware gateway meters per-task request counters here."""

    def _record_ticket(self, ticket: ExecTicket, responses,
                       telemetry: Telemetry) -> None:
        """Fan one finished executor ticket out to per-request results.

        When a tracer is attached, each served request also emits its span
        tree here — a ``request`` root whose children (sched.wait /
        channel.transmit / exec.queue / cloud.compute) are built from the
        *same* virtual-clock floats the RequestRecord holds, so per-request
        span durations sum to ``total_latency_s`` exactly, and a batch-level
        ``exec.batch`` span on the serving queue's track."""
        tracer = self.tracer
        batch = ticket.batch
        if tracer is not None:
            self._exec_batch_spans(tracer, ticket)
        for row, req in enumerate(batch.requests):      # padding rows ignored
            op, stats, tx = req.meta[:3]
            out = self._response_for(req, ticket, row, op, stats)
            # "" is the documented single-tenant sentinel (serve/batcher.py);
            # the multi-tenant arrive handler always sets a tenant name and
            # appends the UplinkJob as meta[3]
            multi_tenant = req.tenant != ""
            if multi_tenant:
                responses[req.tenant][req.req_id] = out
            else:
                responses[req.req_id] = out
            telemetry.record(RequestRecord(
                req_id=req.req_id, c=op.c, bits=op.bits,
                bits_on_wire=stats.wire_bits,
                wire_latency_s=tx.t_arrive - tx.t_submit,
                queue_wait_s=ticket.t_start - req.t_arrive,
                compute_s=ticket.service_s,
                batch_size=len(batch.requests),
                padded_size=batch.padded_size,
                tenant=req.tenant,
                sched_wait_s=(tx.t_submit - req.meta[3].t_enqueue
                              if multi_tenant else 0.0),
                exec_queue=ticket.queue))
            if tracer is not None:
                t0 = req.meta[3].t_enqueue if multi_tenant else tx.t_submit
                track = f"tenant:{req.tenant or 'default'}"
                root = tracer.span(
                    "request", t0, ticket.t_done, track=track,
                    tenant=req.tenant, req_id=req.req_id, op=str(op),
                    wire_bits=stats.wire_bits,
                    padded_size=batch.padded_size, exec_queue=ticket.queue)
                tracer.span("sched.wait", t0, tx.t_submit, track=track,
                            parent=root)
                tracer.span("channel.transmit", tx.t_submit, tx.t_arrive,
                            track=track, parent=root,
                            wire_bits=stats.wire_bits)
                tracer.span("exec.queue", req.t_arrive, ticket.t_start,
                            track=track, parent=root,
                            exec_queue=ticket.queue)
                tracer.span("cloud.compute", ticket.t_start, ticket.t_done,
                            track=track, parent=root,
                            exec_queue=ticket.queue,
                            batch_size=len(batch.requests))
            self._post_record(req, out, telemetry)

    # -- orchestration loop -------------------------------------------------
    def serve(self, imgs, *, submit_times=None) -> tuple[list[GatewayResponse],
                                                         Telemetry]:
        """Serve one request per row of ``imgs`` (N, H, W, 3).

        Responses come back in submission order regardless of channel
        reordering or batching; telemetry holds the per-request records.
        The cloud side runs through ``self.executor`` on the virtual clock,
        so queue_wait/latency telemetry includes waiting for busy cloud
        queues — the same accounting as the multi-tenant event loop.
        """
        imgs = np.asarray(imgs)
        n = imgs.shape[0]
        if submit_times is None:
            submit_times = [0.0] * n
        self.executor.reset()
        # 1. edge side: rate control, encode, transmit — in submit-time order
        # (the simulated link is FIFO by call, so out-of-order calls would
        # charge early requests for wire time the late ones occupied)
        inflight = []
        tracer = self.tracer
        for i in sorted(range(n), key=lambda k: float(submit_times[k])):
            t_submit = float(submit_times[i])
            op, blob, stats, tx = self.encode_request(imgs[i:i + 1], t_submit)
            if tracer is not None:
                tracer.instant("submit", t_submit, track="tenant:default",
                               req_id=i)
                tracer.instant("edge.encode", t_submit, track="tenant:default",
                               req_id=i, op=str(op),
                               wire_bits=8 * blob.nbytes)
            inflight.append((i, op, blob, stats, tx))
        # 2. cloud side: micro-batch encoded blobs in arrival order; decode
        # runs batched per bucket inside _run_batch, scheduled by the
        # executor (tickets carry the virtual start/done times)
        inflight.sort(key=lambda item: (item[4].t_arrive, item[0]))
        responses: list[GatewayResponse | None] = [None] * n
        telemetry = Telemetry(registry=self.metrics)
        batcher = MicroBatcher(max_batch=self.max_batch)

        def run(batch: MicroBatch) -> None:
            # submit plans the virtual times and runs the real compute;
            # results are consumed (and the batch/logits refs released)
            # immediately, so memory tracks one batch, not the workload
            ticket = self.executor.submit(
                batch, max(r.t_arrive for r in batch.requests),
                run_fn=self._run_fn)
            self.executor.on_start(ticket)
            self._record_ticket(ticket, responses, telemetry)
            self.executor.complete(ticket)

        for i, op, blob, stats, tx in inflight:
            req = EncodedRequest(req_id=i, blob=blob, t_arrive=tx.t_arrive,
                                 meta=(op, stats, tx))
            for full in batcher.add(req):
                run(full)
        for rest in batcher.flush():
            run(rest)
        assert all(r is not None for r in responses)
        if self.metrics is not None:
            self.executor.export_metrics(self.metrics)
        return responses, telemetry


# ---------------------------------------------------------------------------
# Multi-tenant, event-driven serving
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TenantRequest:
    """One request of the multi-tenant workload."""
    tenant: str
    img: object                  # numpy (H, W, 3) or (1, H, W, 3)
    t_submit: float = 0.0


class MultiTenantGateway(ServingGateway):
    """Event-driven serving over N tenants sharing one uplink bit budget.

    Replaces :meth:`ServingGateway.serve`'s strict encode -> batch -> restore
    phases with a virtual-clock event loop where edge submits, uplink drain
    ticks, channel arrivals, batch-window flushes, and cloud-compute
    completions interleave:

        submit  : edge forward + content-keyed rate control + capability
                  negotiation + plan.encode; the encoded job queues at the
                  DRR scheduler
        drain   : the scheduler grants queued jobs against the shared
                  per-tick budget (weighted DRR, starvation-free); granted
                  jobs enter their tenant's own channel
        arrive  : the wire blob goes straight into the micro-batcher —
                  buckets are keyed (operating point, H, W) only, so tenants
                  share buckets and decode/restore compiles stay bounded
                  under heterogeneous traffic (decode itself is deferred to
                  dispatch and runs batched)
        flush   : a partially-filled bucket hits its batch window; with
                  ``adaptive_window=True`` the window follows the bucket's
                  arrival-rate EWMA (burst-aware: bursts flush near-full
                  buckets fast, sparse traffic stops waiting for stragglers
                  that are not coming)
        exec_start : the cloud executor's queue begins serving a dispatched
                  batch (``executor.submit`` planned its virtual start/done
                  when the bucket flushed; depth introspection follows these
                  events, so admission control sees the live backlog)
        exec_done : batched decode + restore + cloud forward finished on the
                  executor's virtual clock; responses + telemetry record

    The cloud is a pluggable
    :class:`repro_torch.serve.executor.CloudExecutor`:
    the default ``SerialExecutor`` is one serial cloud queue;
    ``MultiQueueExecutor`` models N parallel replicas
    with work-conserving queue selection. An optional ``admission`` policy
    (token buckets, queue-depth thresholds) runs at submit — before any
    edge compute or encoding — and every rejection becomes an explicit
    :class:`RequestShed` in the tenant's response list plus a ``shed``
    telemetry record; nothing is ever silently dropped.

    Per-tenant channels must be unmetered — the *shared* budget lives in the
    scheduler; a per-channel budget would meter the same bits twice.
    Channels, executor, and admission state are reset at the start of every
    ``serve_tenants`` call, so a repeat of the same workload replays
    bit-identically (exactly so when the executor uses a deterministic cost
    model such as ``LinearCostModel``).
    """

    def __init__(self, params, baf_bank: dict, *,
                 tenants: "list[TenantSpec] | tuple[TenantSpec, ...]",
                 channel_cfg: ChannelConfig | None = None,
                 channels: dict[str, SimulatedChannel] | None = None,
                 controller: RateController | None = None,
                 default_op: OperatingPoint | None = None,
                 backend: str | None = None, max_batch: int = 8,
                 fused: bool = True,
                 capabilities: Capabilities | None = None,
                 budget_bits_per_tick: int | None = None,
                 tick_s: float = 1.0, quantum_bits: int | None = None,
                 batch_window_s: float | None = 0.02,
                 adaptive_window: bool = False,
                 min_window_s: float = 0.0, seed: int = 0,
                 executor: CloudExecutor | None = None,
                 shared_executor: bool = False,
                 admission: AdmissionPolicy | None = None,
                 tracer=None, metrics=None, device=None):
        super().__init__(params, baf_bank, channel=None, controller=None,
                         default_op=default_op, backend=backend,
                         max_batch=max_batch, fused=fused,
                         capabilities=capabilities, executor=executor,
                         shared_executor=shared_executor,
                         tracer=tracer, metrics=metrics, device=device)
        self.admission = admission
        specs = list(tenants)
        if not specs:
            raise ValueError("need at least one tenant")
        self.specs = {t.name: t for t in specs}
        if channels is None:
            cfg = channel_cfg if channel_cfg is not None else ChannelConfig()
            if cfg.budget_bits_per_tick is not None:
                raise ValueError("per-tenant channels must be unmetered; "
                                 "set budget_bits_per_tick on the gateway "
                                 "(shared scheduler budget) instead")
            channels = {t.name: SimulatedChannel(cfg, seed=seed + i)
                        for i, t in enumerate(specs)}
        missing = set(self.specs) - set(channels)
        if missing:
            raise ValueError(f"no channel for tenants {sorted(missing)}")
        metered = [n for n, ch in channels.items()
                   if ch.cfg.budget_bits_per_tick is not None]
        if metered:
            raise ValueError(f"per-tenant channels must be unmetered (the "
                             f"scheduler owns the shared budget; a channel "
                             f"budget would meter the same bits twice): "
                             f"{sorted(metered)}")
        self.channels = channels
        if metrics is not None:
            for name, ch in channels.items():
                ch.bind_metrics(metrics, tenant=name)
        self.mt_controller = controller
        self._sched_args = dict(budget_bits_per_tick=budget_bits_per_tick,
                                tick_s=tick_s, quantum_bits=quantum_bits)
        self.batch_window_s = batch_window_s
        self.adaptive_window = adaptive_window
        self.min_window_s = min_window_s

    # -- edge side ----------------------------------------------------------
    def _pick_tenant_op(self, spec: TenantSpec, z, budget: float):
        ctrl = self.mt_controller
        if ctrl is None:
            return self.default_op
        if isinstance(ctrl, ContentKeyedController):
            z_np = z.cpu().numpy()      # one device->host copy, not one per C
            stats = {c: activation_stats(z_np, sel)
                     for c, (_, sel) in self.baf_bank.items()}
            rd = ctrl.select_for(budget, stats, spec.quality_floor_db)
        else:
            rd = ctrl.select(budget)
        return self._fit_op(rd.op)

    # -- orchestration ------------------------------------------------------
    def _begin_run(self, workload: "list[TenantRequest]") -> "_FederatedRun":
        """Reset this gateway's per-run state (channels, admission, a fresh
        scheduler/batcher/telemetry) and return it bundled for the event
        loop. The shared executor is NOT reset here — the federation driver
        resets it exactly once per run."""
        for w in workload:
            if w.tenant not in self.specs:
                raise KeyError(f"unknown tenant {w.tenant!r}")
        for ch in self.channels.values():
            ch.reset()
        if self.admission is not None:
            self.admission.reset()
        sched = DeficitRoundRobinScheduler(self.specs.values(),
                                           **self._sched_args)
        if self.metrics is not None:
            sched.bind_metrics(self.metrics)
        self.last_scheduler = sched          # post-run introspection (tests,
        return _FederatedRun(                # fairness/budget audits)
            gateway=self, sched=sched,
            telemetry=Telemetry(registry=self.metrics),
            batcher=MicroBatcher(max_batch=self.max_batch,
                                 window_s=self.batch_window_s,
                                 adaptive=self.adaptive_window,
                                 min_window_s=self.min_window_s),
            responses={n: {} for n in self.specs},
            counts={n: 0 for n in self.specs},
            n_requests=len(workload))

    def _finish_run(self, st: "_FederatedRun") -> tuple[dict[str, list],
                                                        Telemetry]:
        # no silent drops: every submission ended as exactly one response
        # or one explicit shed outcome
        out = {}
        for name, got in st.responses.items():
            assert len(got) == st.counts[name], (
                f"tenant {name}: {len(got)}/{st.counts[name]} outcomes")
            out[name] = [got[i] for i in range(st.counts[name])]
        assert len(st.telemetry) + len(st.telemetry.shed) == st.n_requests
        if self.metrics is not None:
            self.executor.export_metrics(self.metrics)
        return out, st.telemetry

    def serve_tenants(self, workload: "list[TenantRequest]") -> tuple[
            dict[str, list], Telemetry]:
        """Run the event loop over the whole workload; returns per-tenant
        outcomes (in per-tenant submission order — each entry is a
        :class:`GatewayResponse` or an explicit :class:`RequestShed`) and
        merged telemetry (served records + the separate ``shed`` series).

        A federation of one: the full loop lives in
        :func:`serve_federated`, which drives M gateways on a single
        virtual clock against one shared executor."""
        return serve_federated([(self, workload)])[0]


# ---------------------------------------------------------------------------
# Gateway federation: M gateways, one shared cloud executor
# ---------------------------------------------------------------------------

@dataclass
class _FederatedRun:
    """One gateway's per-run state inside a federated event loop."""
    gateway: MultiTenantGateway
    sched: DeficitRoundRobinScheduler
    telemetry: Telemetry
    batcher: MicroBatcher
    responses: dict                   # tenant -> {req_id: outcome}
    counts: dict                      # tenant -> submissions seen
    n_requests: int
    # dedupe only drains that have not run yet: a submit landing at a
    # timestamp whose drain already executed must get a fresh one, or its
    # job would strand in the scheduler queue
    drain_times: "set[float]" = None
    # generation -> earliest flush time scheduled so far. Adaptive windows
    # can move a group's deadline *earlier* as arrivals sharpen the rate
    # estimate; re-push then (stale later events no-op via gen)
    scheduled_flushes: "dict[int, float]" = None

    def __post_init__(self):
        self.drain_times = set()
        self.scheduled_flushes = {}


def serve_federated(runs: "list[tuple[MultiTenantGateway, list]]"
                    ) -> "list[tuple[dict[str, list], Telemetry]]":
    """Drive M gateways' event loops on ONE virtual clock against ONE shared
    cloud executor.

    ``runs`` is ``[(gateway, workload), ...]``. Every gateway keeps its own
    tenants, uplink scheduler, channels, admission policy, batcher, and
    telemetry; the cloud capacity — the mesh — is common. Events from all
    gateways interleave in global time order on a single heap, so a bucket
    flushed by gateway 0 occupies the shared executor exactly when gateway
    1's admission policy reads ``executor.depth()`` (shared-mesh depth
    introspection: one gateway's burst sheds another's overflow).

    Each submit passes the owning gateway's ``run_fn``, so one executor
    serves every gateway's plans without rebinding. Returns one
    ``(outcomes, telemetry)`` per run, aligned with ``runs``; replay is
    bit-identical under a deterministic cost model (``LinearCostModel`` or a
    frozen ``CalibratedCostModel``).
    """
    if not runs:
        raise ValueError("serve_federated needs at least one "
                         "(gateway, workload) pair")
    gateways = [gw for gw, _ in runs]
    if len(set(map(id, gateways))) != len(gateways):
        raise ValueError("each gateway may appear once per federation")
    executor = gateways[0].executor
    for gw in gateways[1:]:
        if gw.executor is not executor:
            raise ValueError("federated gateways must share one executor "
                             "(build them with shared_executor=True around "
                             "a single instance)")
    executor.reset()
    states = [gw._begin_run(workload) for gw, workload in runs]

    events: list = []
    seq = itertools.count()

    def push(t: float, gi: int, kind: str, payload) -> None:
        heapq.heappush(events, (float(t), next(seq), gi, kind, payload))

    def schedule_drain(t: float, gi: int) -> None:
        t = float(t)
        st = states[gi]
        if t not in st.drain_times:
            st.drain_times.add(t)
            push(t, gi, "drain", None)

    def dispatch(gi: int, batch: MicroBatch, t_ready: float) -> None:
        # the executor plans the batch onto a queue of its virtual clock;
        # the loop replays the planned times as events so depth
        # introspection (admission's signal) tracks the virtual clock
        ticket = executor.submit(batch, t_ready,
                                 run_fn=states[gi].gateway._run_fn)
        push(ticket.t_start, gi, "exec_start", ticket)
        push(ticket.t_done, gi, "exec_done", ticket)

    for gi, (gw, workload) in enumerate(runs):
        for w in workload:
            push(w.t_submit, gi, "submit", w)

    while events:
        t, _, gi, kind, payload = heapq.heappop(events)
        gw = gateways[gi]
        st = states[gi]
        tracer = gw.tracer

        if kind == "submit":
            w = payload
            spec = gw.specs[w.tenant]
            local_id = st.counts[w.tenant]
            st.counts[w.tenant] += 1
            if tracer is not None:
                tracer.instant("submit", t, track=f"tenant:{w.tenant}",
                               tenant=w.tenant, req_id=local_id)
            if gw.admission is not None:
                decision = gw.admission.admit(
                    tenant=w.tenant, priority=spec.priority, t=t,
                    executor=executor)
                if not decision.admitted:
                    # shed BEFORE any edge compute or encoding is spent;
                    # the outcome is explicit: it takes the response slot
                    # and lands in telemetry's separate shed series
                    outcome = RequestShed(
                        req_id=local_id, tenant=w.tenant, t_submit=t,
                        reason=decision.reason, priority=spec.priority)
                    st.responses[w.tenant][local_id] = outcome
                    st.telemetry.record_shed(ShedRecord(
                        req_id=local_id, tenant=w.tenant, t_submit=t,
                        reason=decision.reason, priority=spec.priority))
                    if tracer is not None:
                        tracer.instant(
                            "admission.shed", t,
                            track=f"tenant:{w.tenant}", tenant=w.tenant,
                            req_id=local_id, reason=decision.reason,
                            priority=spec.priority)
                    continue
            z = gw._edge_fn(gw._to_device(w.img))
            op = gw._pick_tenant_op(spec, z, st.sched.budget_remaining(t))
            blob = gw.plan_for(op).encode(z)
            if tracer is not None:
                tracer.instant("edge.encode", t,
                               track=f"tenant:{w.tenant}",
                               tenant=w.tenant, req_id=local_id,
                               op=str(op), wire_bits=8 * blob.nbytes)
            # the scheduler meters the job at its true container length,
            # so DRR shares reflect real bits on the wire
            st.sched.enqueue(UplinkJob(
                tenant=w.tenant, req_id=local_id, bits=8 * blob.nbytes,
                t_enqueue=t, payload=(op, blob, blob.stats)))
            schedule_drain(t, gi)

        elif kind == "drain":
            st.drain_times.discard(t)
            for job in st.sched.drain(t):
                blob = job.payload[1]
                tx = gw.channels[job.tenant].transmit_bytes(blob.data, t)
                push(tx.t_arrive, gi, "arrive", (job, tx))
            if st.sched.pending():
                schedule_drain(st.sched.next_tick_time(t), gi)

        elif kind == "arrive":
            job, tx = payload
            op, blob, stats = job.payload
            req = EncodedRequest(
                req_id=job.req_id, blob=blob, t_arrive=t,
                meta=(op, stats, tx, job), tenant=job.tenant,
                priority=gw.specs[job.tenant].priority)
            fulls = st.batcher.add(req, now=t)
            for full in fulls:
                dispatch(gi, full, t)
            if not fulls:
                deadline = st.batcher.deadline(req.key)
                if deadline is not None:
                    due, gen = deadline
                    if due < st.scheduled_flushes.get(gen, float("inf")):
                        st.scheduled_flushes[gen] = due
                        push(due, gi, "flush", (req.key, gen))

        elif kind == "flush":
            key, gen = payload
            current = st.batcher.deadline(key)
            if (current is not None and current[1] == gen
                    and current[0] > t + 1e-12):
                # the adaptive estimate drifted *later* (traffic
                # decelerated after this event was scheduled): chase the
                # new due time instead of flushing undersized. Each
                # re-push is strictly later and the deadline is capped
                # at t_first + window_s, so the chase terminates.
                st.scheduled_flushes[gen] = current[0]
                push(current[0], gi, "flush", (key, gen))
            else:
                batch = st.batcher.take(key, gen)
                if batch is not None:
                    st.scheduled_flushes.pop(gen, None)
                    dispatch(gi, batch, t)

        elif kind == "exec_start":
            executor.on_start(payload)

        elif kind == "exec_done":
            gw._record_ticket(payload, st.responses, st.telemetry)
            executor.complete(payload)   # releases batch/logits refs

        # events may drain while buckets still hold requests (no batch
        # window): sweep every gateway's leftovers through the same
        # dispatch path, in federation order (deterministic)
        if not events:
            for gj, sj in enumerate(states):
                for rest in sj.batcher.flush():
                    dispatch(gj, rest,
                             max(r.t_arrive for r in rest.requests))

    return [gw._finish_run(st) for gw, st in zip(gateways, states)]


class GatewayFederation:
    """M multi-tenant gateways sharing one cloud executor (the shared mesh).

    Construction validates the sharing contract — every gateway holds the
    same executor instance and (for M > 1) was built with
    ``shared_executor=True``. :meth:`serve` zips gateways with their
    workloads onto one virtual clock via :func:`serve_federated`; admission
    stays per-gateway while ``depth()`` exposes the shared-mesh backlog all
    of them key on.
    """

    def __init__(self, gateways: "list[MultiTenantGateway]"):
        gateways = list(gateways)
        if not gateways:
            raise ValueError("federation needs at least one gateway")
        executor = gateways[0].executor
        for gw in gateways:
            if gw.executor is not executor:
                raise ValueError("federated gateways must share one executor")
            if len(gateways) > 1 and not gw.shared_executor:
                raise ValueError("build federated gateways with "
                                 "shared_executor=True")
        self.gateways = gateways
        self.executor = executor

    def serve(self, workloads: "list[list[TenantRequest]]"
              ) -> "list[tuple[dict[str, list], Telemetry]]":
        if len(workloads) != len(self.gateways):
            raise ValueError(f"{len(workloads)} workloads for "
                             f"{len(self.gateways)} gateways")
        return serve_federated(list(zip(self.gateways, workloads)))

    def depth(self) -> int:
        """Shared-mesh backlog every member's admission policy reads."""
        return self.executor.depth()
