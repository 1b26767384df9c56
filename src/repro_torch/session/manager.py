"""Streaming session manager: many camera sessions on one gateway.

Counterpart of ``repro/session/manager.py`` on the port's
:class:`~repro_torch.serve.gateway.MultiTenantGateway`. The edge forward and
the encoder run on the gateway's device (the quantize and histogram kernels
once per encoded frame); each micro-batch of decoded frames is restored at
its padded size (the consolidate kernel once per micro-batch) and its
logits are copied to the host before the compute clock stops.

Drives N concurrent 10-30 fps sessions on the virtual clock through a
:class:`~repro_torch.serve.gateway.MultiTenantGateway`'s machinery — its
plan cache, cloud executor, admission policy, telemetry/tracing sinks —
with the stateful session layer on top:

    frame tick -> QoS ladder decision -> edge forward -> SessionEncoder
    (I/P) -> lossy SimulatedChannel.transmit_frame -> SessionDecoder
    (resync state machine, NACK on failure) -> micro-batch decoded codes ->
    executor restore + cloud forward -> per-frame telemetry

Per-session QoS — degrade before shed
-------------------------------------
Each session walks a shared quality ladder (:class:`QosLevel` tuple, best
first). When the gateway's admission policy rejects a frame, the session
first steps *down* the ladder — a coarser operating point, sparser keyframes
and, at the floor, a frame stride that halves offered load — and the frame
is served degraded rather than dropped; only a session already at the floor
sheds. Every step-down is metered as a
:class:`~repro_torch.serve.telemetry.DegradeRecord` (a third outcome
series, distinct from served and shed).
After ``upgrade_hold`` consecutive clean admissions a session steps back up
one rung, so quality recovers when pressure clears.

Loss recovery
-------------
The manager owns one impaired channel per session (loss/corruption/reorder
per packet, seeded). A frame that arrives damaged raises in the decoder;
the manager schedules a NACK on the simulated downlink and the encoder's
next frame is a forced I-frame. A frame lost outright surfaces as a desync
when its successor fails to chain. Recovery episodes are measured by
:class:`~repro_torch.session.recovery.RecoveryTracker` per session and
every run ends with a bounded settle phase that repairs any still-desynced
session — ``run`` asserts every session ends in sync.

Everything runs on the virtual clock; with a deterministic executor cost
model (``LinearCostModel``) a re-run over the same inputs is bit-identical
(:meth:`StreamReport.signature`).
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.codec.rans import CorruptStream
from repro_torch.pipeline import DecodedBatch, OperatingPoint
from repro_torch.serve.batcher import (DecodedRequest, MicroBatch,
                                       MicroBatcher)
from repro_torch.serve.channel import ChannelConfig, SimulatedChannel
from repro_torch.serve.rate_control import session_bits_per_frame
from repro_torch.serve.telemetry import (DegradeRecord, RequestRecord,
                                         ShedRecord, Telemetry)
from repro_torch.session.codec import (SessionConfig, SessionDecoder,
                                       SessionEncoder, SessionError)
from repro_torch.session.recovery import RecoveryConfig, RecoveryTracker

SETTLE_ROUNDS_MAX = 64       # repair attempts before declaring a run broken


@dataclass(frozen=True)
class QosLevel:
    """One rung of the quality ladder (index 0 = best quality).

    keyframe_interval : periodic I-frame cadence at this rung (0 = none —
        P-frames until a NACK forces refresh)
    frame_stride : send every Nth frame only; >1 makes sense at the floor
        rung, where it genuinely halves/quarters offered executor load
        instead of just shaving wire bits
    """
    op: OperatingPoint
    keyframe_interval: int = 0
    frame_stride: int = 1

    def __post_init__(self):
        if self.keyframe_interval < 0:
            raise ValueError("keyframe_interval must be >= 0")
        if self.frame_stride < 1:
            raise ValueError("frame_stride must be >= 1")


@dataclass(frozen=True)
class SessionSpec:
    """One camera session. ``name`` must be a tenant of the gateway — the
    session inherits that tenant's priority (executor scheduling) and
    admission identity."""
    name: str
    fps: float = 15.0
    start_s: float = 0.0

    def __post_init__(self):
        if self.fps <= 0:
            raise ValueError("fps must be > 0")
        if self.start_s < 0:
            raise ValueError("start_s must be >= 0")


@dataclass(frozen=True)
class FrameLog:
    """One frame's outcome on the virtual clock."""
    seq: int                     # encoder sequence (== -1 for skipped/shed:
                                 # those frames never reached the encoder)
    t: float                     # frame tick time
    outcome: str                 # served | lost | corrupt | desync |
                                 # skipped | shed
    intra: bool = False
    level: int = 0
    wire_bits: int = 0


@dataclass
class _SessionState:
    spec: SessionSpec
    encoder: SessionEncoder
    decoder: SessionDecoder
    tracker: RecoveryTracker
    channel: SimulatedChannel
    priority: int
    level: int = 0               # current QoS rung
    healthy: int = 0             # consecutive clean admissions
    nack_inflight: bool = False
    frames: list = field(default_factory=list)        # FrameLog, tick order
    last_z: object = None        # latest split activation (settle repairs)
    frame_idx: int = 0


@dataclass
class StreamReport:
    """Everything a streaming run produced, keyed by session name."""
    frames: dict                 # name -> [FrameLog]
    telemetry: Telemetry
    recovery: dict               # name -> RecoveryTracker
    nacks: dict                  # name -> NACKs delivered
    final_levels: dict           # name -> QoS rung at end of run
    settle_frames: int           # repair I-frames spent ending in sync

    def counts(self, name: str) -> dict:
        out: dict[str, int] = {}
        for f in self.frames[name]:
            out[f.outcome] = out.get(f.outcome, 0) + 1
        return out

    def wire_bits(self, name: str) -> int:
        return sum(f.wire_bits for f in self.frames[name])

    def signature(self) -> tuple:
        """Virtual-clock quantities only — two runs of the same seeded
        workload under a deterministic cost model compare equal."""
        per_session = []
        for name in sorted(self.frames):
            logs = self.frames[name]
            tr = self.recovery[name]
            per_session.append((
                name,
                tuple((f.seq, round(f.t, 9), f.outcome, f.intra, f.level,
                       f.wire_bits) for f in logs),
                self.nacks.get(name, 0),
                tr.episodes,
                tuple(round(x, 9) for x in tr.recovery_times),
                self.final_levels[name],
            ))
        return (tuple(per_session), self.settle_frames,
                len(self.telemetry), len(self.telemetry.shed),
                len(self.telemetry.degraded))


class SessionManager:
    """Runs streaming sessions against a multi-tenant gateway.

    Parameters
    ----------
    gateway : MultiTenantGateway — supplies plans, model params, executor,
        admission policy, tenant specs (priority), tracer/metrics sinks
    sessions : SessionSpec list; every name must be a gateway tenant
    ladder : QosLevel tuple, best rung first; shared by all sessions
    channel_cfg : per-session impaired channel template (seeded per session
        from ``seed``); must be unmetered — budgets belong to the uplink
        scheduler, not here
    channels : pre-built {name: SimulatedChannel} (overrides channel_cfg)
    recovery : RecoveryConfig — NACK latency etc.
    upgrade_hold : clean admissions before stepping back up one rung
    batch_window_s : micro-batch window on the decoded-request path
    rd_table : RD table whose points carry the measured ``p_over_i`` ratio
        (serve.rate_control.RDPoint) — enables P-frame-aware pricing of the
        ladder rungs; None (default) keeps the legacy behaviour
    frame_budget_bits : per-frame wire-bit budget sessions should start
        within. With ``rd_table``, every session's *initial* rung is the
        best (first) rung whose expected per-frame session cost —
        ``session_bits_per_frame`` over the rung's keyframe interval and
        stride — fits this budget (floor rung if none fits). RD tables
        price I-frames only; without the P/I ratio a temporal rung's wire
        cost is overestimated and ladders start lower than they need to.
        None (default) starts at rung 0, the legacy behaviour.
    """

    def __init__(self, gateway, sessions, *, ladder,
                 channel_cfg: ChannelConfig | None = None,
                 channels: dict | None = None,
                 recovery: RecoveryConfig | None = None,
                 upgrade_hold: int = 16, batch_window_s: float | None = 0.02,
                 seed: int = 0, rd_table=None,
                 frame_budget_bits: float | None = None):
        ladder = tuple(ladder)
        if not ladder:
            raise ValueError("need at least one QoS rung")
        sessions = list(sessions)
        if not sessions:
            raise ValueError("need at least one session")
        names = [s.name for s in sessions]
        if len(set(names)) != len(names):
            raise ValueError("duplicate session names")
        missing = [n for n in names if n not in gateway.specs]
        if missing:
            raise ValueError(f"sessions {missing} are not gateway tenants")
        self.gateway = gateway
        self.sessions = sessions
        self.ladder = ladder
        self.recovery = recovery if recovery is not None else RecoveryConfig()
        self.upgrade_hold = upgrade_hold
        self.batch_window_s = batch_window_s
        self.seed = seed
        if channels is None:
            cfg = channel_cfg if channel_cfg is not None else ChannelConfig()
            channels = {s.name: SimulatedChannel(cfg, seed=seed + i)
                        for i, s in enumerate(sessions)}
        metered = [n for n, ch in channels.items()
                   if ch.cfg.budget_bits_per_tick is not None]
        if metered:
            raise ValueError(f"session channels must be unmetered: "
                             f"{sorted(metered)}")
        missing_ch = set(names) - set(channels)
        if missing_ch:
            raise ValueError(f"no channel for sessions {sorted(missing_ch)}")
        self.channels = channels
        # every session shares the gateway's negotiated capabilities: a
        # gateway that never negotiated the session profile streams I-only
        self._levels = tuple(gateway._fit_op(l.op) for l in ladder)
        self._initial_level = 0
        if rd_table is not None and frame_budget_bits is not None:
            self._initial_level = self._priced_initial_level(
                rd_table, float(frame_budget_bits))

    def _priced_initial_level(self, rd_table, frame_budget_bits: float) -> int:
        """Best (first) rung whose expected per-frame session wire cost fits
        the budget; the floor rung when none does.

        Each rung is priced through its *negotiated* operating point's RD
        entry via
        :func:`repro_torch.serve.rate_control.session_bits_per_frame`,
        so P-frame savings (the point's measured ``p_over_i``) count —
        I-only pricing would overshoot temporal rungs and start sessions
        lower than the budget warrants. A rung with no table entry is
        skipped (never guessed at).
        """
        by_op = {p.op.resolve(): p for p in rd_table}
        for i, rung in enumerate(self.ladder):
            point = by_op.get(self._levels[i].resolve())
            if point is None:
                continue
            cost = session_bits_per_frame(
                point, keyframe_interval=rung.keyframe_interval,
                frame_stride=rung.frame_stride)
            if cost <= frame_budget_bits:
                return i
        return len(self.ladder) - 1

    # -- executor run_fn (decoded-request currency) -------------------------
    def _make_run_fn(self, op: OperatingPoint):
        gw = self.gateway
        plan = gw.plan_for(op)

        def run(batch: MicroBatch):
            # the batcher stacked the decoded frames at the padded bucket
            # size: one restore (one consolidate launch) per micro-batch.
            # The clock stops after the logits' copy to the host, which
            # waits for the card, so it measures the card's work too
            # repro_torch: allow[RA01] -- warm-timing helper: measures real
            # compute wall for the cost model, never replayed state
            t0 = time.perf_counter()
            decoded = DecodedBatch(codes=batch.codes, mins=batch.mins,
                                   maxs=batch.maxs)
            z_tilde = plan.restore(decoded)
            logits = gw._cloud_fn(z_tilde).cpu().numpy()
            # repro_torch: allow[RA01] -- warm-timing helper (see t0 above)
            return logits, time.perf_counter() - t0
        return run

    # -- the run ------------------------------------------------------------
    def run(self, frames: dict) -> tuple[dict, StreamReport]:
        """Stream ``frames`` (name -> (N, H, W, 3) array) through the stack.

        Returns (responses, report): ``responses[name]`` maps served frame
        seq -> logits row; the report carries per-frame outcome logs,
        recovery stats, and merged telemetry. Every session is guaranteed
        in sync when this returns (bounded settle phase; raises if a
        pathological channel defeats SETTLE_ROUNDS_MAX repairs).
        """
        gw = self.gateway
        for name in frames:
            if name not in {s.name for s in self.sessions}:
                raise KeyError(f"frames for unknown session {name!r}")
        # fresh per-run state: replays are bit-identical
        gw.executor.reset()
        if gw.admission is not None:
            gw.admission.reset()
        for ch in self.channels.values():
            ch.reset()
        states: dict[str, _SessionState] = {}
        for i, spec in enumerate(self.sessions):
            cfg = SessionConfig(session_id=i, levels=self._levels)
            states[spec.name] = _SessionState(
                spec=spec,
                encoder=SessionEncoder(cfg, gw.plan_for,
                                       capabilities=gw.capabilities),
                decoder=SessionDecoder(cfg, gw.plan_for),
                tracker=RecoveryTracker(),
                channel=self.channels[spec.name],
                priority=gw.specs[spec.name].priority,
                level=self._initial_level)
        telemetry = Telemetry(registry=gw.metrics)
        batcher = MicroBatcher(max_batch=gw.max_batch,
                               window_s=self.batch_window_s)
        key_ops: dict = {}            # bucket key -> restore operating point
        responses: dict[str, dict] = {s.name: {} for s in self.sessions}
        nacks: dict[str, int] = {s.name: 0 for s in self.sessions}
        settle_frames = 0
        settle_rounds = 0
        tracer = gw.tracer

        events: list = []
        eseq = itertools.count()

        def push(t: float, kind: str, payload) -> None:
            heapq.heappush(events, (float(t), next(eseq), kind, payload))

        def meter(metric: str, **labels) -> None:
            if gw.metrics is not None:
                gw.metrics.counter(metric, **labels).inc()

        def send_frame(st: _SessionState, z, t: float, *,
                       settle: bool = False) -> None:
            """Encode at the session's current rung and push the delivery."""
            rung = self.ladder[st.level]
            blob, meta = st.encoder.encode(
                z, level=st.level, keyframe_interval=rung.keyframe_interval)
            delivery = st.channel.transmit_frame(blob, t)
            meter("session_frames_total",
                  kind="I" if meta.intra else "P", tenant=st.spec.name)
            if delivery.lost:
                st.frames.append(FrameLog(
                    seq=meta.seq, t=t, outcome="lost", intra=meta.intra,
                    level=meta.level, wire_bits=meta.wire_bits))
                meter("session_frames_lost_total", tenant=st.spec.name)
                if tracer is not None:
                    tracer.instant("session.frame_lost", t,
                                   track=f"tenant:{st.spec.name}",
                                   seq=meta.seq, intra=meta.intra)
                # an I-frame lost in flight leaves nothing for the decoder
                # to chain from — without feedback yet, the encoder keeps
                # the new reference and the NEXT frame's failure triggers
                # the NACK path
                return
            st.frames.append(FrameLog(
                seq=meta.seq, t=t, outcome="pending", intra=meta.intra,
                level=meta.level, wire_bits=meta.wire_bits))
            push(delivery.tx.t_arrive, "arrive",
                 (st.spec.name, delivery, meta, len(st.frames) - 1, settle))

        def resolve(st: _SessionState, log_idx: int, outcome: str) -> None:
            f = st.frames[log_idx]
            st.frames[log_idx] = FrameLog(seq=f.seq, t=f.t, outcome=outcome,
                                          intra=f.intra, level=f.level,
                                          wire_bits=f.wire_bits)

        def schedule_nack(st: _SessionState, t: float) -> None:
            if not self.recovery.nack or st.nack_inflight:
                return
            st.nack_inflight = True
            push(t + self.recovery.nack_latency_s, "nack", st.spec.name)

        def flush_deadline(key) -> None:
            deadline = batcher.deadline(key)
            if deadline is not None:
                due, gen = deadline
                push(due, "flush", (key, gen))

        def dispatch(batch: MicroBatch, t_ready: float) -> None:
            op = key_ops[batch.key]
            ticket = gw.executor.submit(batch, t_ready,
                                        run_fn=self._make_run_fn(op))
            push(ticket.t_start, "exec_start", ticket)
            push(ticket.t_done, "exec_done", ticket)

        for spec in self.sessions:
            n = len(frames.get(spec.name, ()))
            for idx in range(n):
                push(spec.start_s + idx / spec.fps, "frame",
                     (spec.name, idx))

        while events:
            t, _, kind, payload = heapq.heappop(events)

            if kind == "frame":
                name, idx = payload
                st = states[name]
                st.frame_idx = idx
                img = np.asarray(frames[name][idx])[None]
                rung = self.ladder[st.level]
                if rung.frame_stride > 1 and idx % rung.frame_stride != 0:
                    st.frames.append(FrameLog(seq=-1, t=t, outcome="skipped",
                                              level=st.level))
                    meter("session_frames_skipped_total", tenant=name)
                    continue
                if gw.admission is not None:
                    decision = gw.admission.admit(
                        tenant=name, priority=st.priority, t=t,
                        executor=gw.executor)
                    if not decision.admitted:
                        if st.level < len(self.ladder) - 1:
                            # degrade BEFORE shed: step one rung down and
                            # serve the frame anyway at reduced quality
                            telemetry.record_degrade(DegradeRecord(
                                tenant=name, t=t, frame_seq=idx,
                                from_level=st.level, to_level=st.level + 1,
                                reason=decision.reason))
                            st.level += 1
                            st.healthy = 0
                            if tracer is not None:
                                tracer.instant(
                                    "session.degrade", t,
                                    track=f"tenant:{name}",
                                    to_level=st.level,
                                    reason=decision.reason)
                        else:
                            st.frames.append(FrameLog(
                                seq=-1, t=t, outcome="shed",
                                level=st.level))
                            telemetry.record_shed(ShedRecord(
                                req_id=idx, tenant=name, t_submit=t,
                                reason=decision.reason,
                                priority=st.priority))
                            st.healthy = 0
                            continue
                    else:
                        st.healthy += 1
                        if (st.healthy >= self.upgrade_hold
                                and st.level > 0):
                            st.level -= 1       # pressure cleared: step up
                            st.healthy = 0
                z = gw._edge_fn(gw._to_device(img))
                st.last_z = z
                send_frame(st, z, t)

            elif kind == "arrive":
                name, delivery, meta, log_idx, settle = payload
                st = states[name]
                try:
                    decoded, frame = st.decoder.decode(delivery.data)
                except (CorruptStream, SessionError) as e:
                    outcome = ("corrupt" if isinstance(e, CorruptStream)
                               else "desync")
                    resolve(st, log_idx, outcome)
                    meter("session_frames_%s_total" % outcome, tenant=name)
                    if st.tracker.on_desync(t) and tracer is not None:
                        tracer.instant("session.desync", t,
                                       track=f"tenant:{name}",
                                       seq=meta.seq, reason=str(e))
                    schedule_nack(st, t)
                    continue
                if frame.intra:
                    st.tracker.on_resync(t)
                resolve(st, log_idx, "served")
                op = meta.op
                req = DecodedRequest(
                    req_id=meta.seq, codes=decoded.codes, mins=decoded.mins,
                    maxs=decoded.maxs, c=op.c, bits=op.bits, t_arrive=t,
                    meta=(op, meta, delivery.tx), tenant=name,
                    priority=st.priority)
                key_ops.setdefault(req.key, op)
                fulls = batcher.add(req, now=t)
                for full in fulls:
                    dispatch(full, t)
                if not fulls:
                    flush_deadline(req.key)

            elif kind == "nack":
                name = payload
                st = states[name]
                st.nack_inflight = False
                nacks[name] += 1
                st.encoder.nack()
                meter("session_nacks_total", tenant=name)
                if tracer is not None:
                    tracer.instant("session.nack", t, track=f"tenant:{name}")

            elif kind == "flush":
                key, gen = payload
                batch = batcher.take(key, gen)
                if batch is not None:
                    dispatch(batch, t)

            elif kind == "exec_start":
                gw.executor.on_start(payload)

            elif kind == "exec_done":
                ticket = payload
                batch = ticket.batch
                for row, req in enumerate(batch.requests):
                    op, meta, tx = req.meta
                    responses[req.tenant][req.req_id] = ticket.logits[row]
                    telemetry.record(RequestRecord(
                        req_id=req.req_id, c=op.c, bits=op.bits,
                        bits_on_wire=meta.wire_bits,
                        wire_latency_s=tx.t_arrive - tx.t_submit,
                        queue_wait_s=ticket.t_start - req.t_arrive,
                        compute_s=ticket.service_s,
                        batch_size=len(batch.requests),
                        padded_size=batch.padded_size,
                        tenant=req.tenant,
                        exec_queue=ticket.queue))
                    if tracer is not None:
                        track = f"tenant:{req.tenant}"
                        root = tracer.span(
                            "session.frame", tx.t_submit, ticket.t_done,
                            track=track, tenant=req.tenant, seq=req.req_id,
                            intra=meta.intra, level=meta.level,
                            wire_bits=meta.wire_bits)
                        tracer.span("channel.transmit", tx.t_submit,
                                    tx.t_arrive, track=track, parent=root,
                                    wire_bits=meta.wire_bits)
                        tracer.span("exec.queue", req.t_arrive,
                                    ticket.t_start, track=track, parent=root,
                                    exec_queue=ticket.queue)
                        tracer.span("cloud.compute", ticket.t_start,
                                    ticket.t_done, track=track, parent=root,
                                    exec_queue=ticket.queue,
                                    batch_size=len(batch.requests))
                gw.executor.complete(ticket)

            if not events:
                # ticks exhausted: first sweep leftover buckets, then run
                # the settle phase — repair I-frames until every session is
                # back in sync (a run must never end desynced). One round
                # per drain, so each repair's arrival is processed before
                # the next round decides who is still broken; only a repair
                # frame lost outright retries inside the inner loop.
                for rest in batcher.flush():
                    dispatch(rest, max(r.t_arrive for r in rest.requests))
                t_settle = t
                while not events and settle_rounds < SETTLE_ROUNDS_MAX:
                    broken = [st for st in states.values()
                              if (st.tracker.in_desync
                                  or not st.decoder.synced)
                              and st.last_z is not None]
                    if not broken:
                        break
                    settle_rounds += 1
                    for st in broken:
                        t_settle += 1.0 / st.spec.fps
                        st.encoder.nack()          # force intra refresh
                        send_frame(st, st.last_z, t_settle, settle=True)
                        settle_frames += 1

        still_broken = [n for n, st in states.items()
                        if (st.tracker.in_desync or not st.decoder.synced)
                        and st.last_z is not None]
        if still_broken:
            raise RuntimeError(
                f"sessions failed to resync after {SETTLE_ROUNDS_MAX} "
                f"repair rounds: {sorted(still_broken)}")

        report = StreamReport(
            frames={n: st.frames for n, st in states.items()},
            telemetry=telemetry,
            recovery={n: st.tracker for n, st in states.items()},
            nacks=nacks,
            final_levels={n: st.level for n, st in states.items()},
            settle_frames=settle_frames)
        if gw.metrics is not None:
            gw.executor.export_metrics(gw.metrics)
        return responses, report
