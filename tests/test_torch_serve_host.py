"""The port's host-side serving modules against the JAX package's.

Channel, DRR scheduler, micro-batcher, telemetry, cloud executors and
admission, virtual-clock traces and bench records carry no model: the same
inputs must give the same records, tickets and grants (compared field by
field), byte-identical trace JSON, metrics text and bench files, and the
same exceptions with the same messages.
"""
import dataclasses
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

import repro.obs as jobs
import repro.serve as jserve
import repro_torch.obs as tobs
import repro_torch.serve as tserve
from repro import pipeline as jpipe
from repro_torch import pipeline as tpipe

PKGS = (SimpleNamespace(S=jserve, O=jobs, P=jpipe),
        SimpleNamespace(S=tserve, O=tobs, P=tpipe))


def plain(x):
    """Package-free view of a result: dataclasses as (class name, fields),
    numpy arrays as (dtype, shape, bytes); floats compared exactly."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, SimpleNamespace):
        return plain(vars(x))
    return x


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` with each package; the results must be
    equal. Returns the port's."""
    want, got = (scenario(pkg, *args) for pkg in PKGS)
    assert got == want
    return got


def raised(fn):
    """(exception class name, message) of what ``fn()`` raises."""
    try:
        fn()
    except Exception as e:              # the type itself is compared
        return type(e).__name__, str(e)
    return None


def both_raise(make):
    """``make(pkg)`` returns a thunk; both thunks raise alike."""
    got = [raised(make(pkg)) for pkg in PKGS]
    assert got[0] is not None and got[0] == got[1], got
    return got[1]


# ---------------------------------------------------------------------------
# Channel
# ---------------------------------------------------------------------------

CHANNELS = {
    "jitter": dict(bandwidth_bps=5000, base_latency_s=0.01, jitter_s=0.02),
    "budget": dict(bandwidth_bps=1e9, base_latency_s=0.0, tick_s=1.0,
                   budget_bits_per_tick=1000),
    "impaired": dict(bandwidth_bps=1e5, jitter_s=0.001, loss_p=0.2,
                     corrupt_p=0.3, reorder_p=0.25, reorder_delay_s=0.01,
                     mtu_bytes=64),
}


def _channel_run(pkg, cfg):
    ch = pkg.S.SimulatedChannel(pkg.S.ChannelConfig(**cfg), seed=3)
    reg = pkg.O.MetricsRegistry()
    ch.bind_metrics(reg, tenant="t")
    rng = np.random.default_rng(1)
    out = []
    for i in range(24):
        if i % 3 == 0:
            out.append(ch.transmit(int(rng.integers(100, 3000)),
                                   t_submit=0.01 * i))
        elif i % 3 == 1:
            out.append(ch.transmit_bytes(rng.bytes(int(rng.integers(1, 300)))))
        else:
            out.append(ch.transmit_frame(rng.bytes(int(rng.integers(1, 500))),
                                         t_submit=0.02 * i))
        out.append((ch.now, ch.budget_remaining(),
                    ch.budget_remaining(at=0.5)))
        if i == 11:
            ch.advance(0.5)
    ch.reset()
    out.append(ch.transmit(500))
    return plain(out), reg.to_prometheus_text()


@pytest.mark.parametrize("name", sorted(CHANNELS))
def test_channel_matches_jax(name):
    out, text = both(_channel_run, CHANNELS[name])
    assert "channel_wire_bits_total" in text
    assert len(out) == 49


@pytest.mark.parametrize("case", [
    lambda S: S.ChannelConfig(loss_p=1.5),
    lambda S: S.ChannelConfig(reorder_delay_s=-1.0),
    lambda S: S.ChannelConfig(mtu_bytes=0),
    lambda S: S.SimulatedChannel(S.ChannelConfig()).transmit(0),
    lambda S: S.SimulatedChannel(S.ChannelConfig()).transmit_bytes(b""),
    lambda S: S.SimulatedChannel(S.ChannelConfig()).transmit_frame(b""),
    lambda S: S.SimulatedChannel(S.ChannelConfig()).advance(-1.0),
])
def test_channel_refuses_alike(case):
    both_raise(lambda pkg: lambda: case(pkg.S))


# ---------------------------------------------------------------------------
# DRR scheduler
# ---------------------------------------------------------------------------

def _sched_run(pkg, budget, quantum):
    S = pkg.S
    specs = [S.TenantSpec("a", weight=3.0), S.TenantSpec("b"),
             S.TenantSpec("c", weight=0.5, priority=1, tasks=["classify"])]
    sch = S.DeficitRoundRobinScheduler(specs, budget_bits_per_tick=budget,
                                       tick_s=0.1, quantum_bits=quantum)
    reg = pkg.O.MetricsRegistry()
    sch.bind_metrics(reg)
    rng = np.random.default_rng(2)
    hi = 2000 if budget is None else int(1.6 * budget)
    for i in range(30):
        sch.enqueue(S.UplinkJob(tenant="abc"[int(rng.integers(3))], req_id=i,
                                bits=int(rng.integers(100, hi)),
                                t_enqueue=0.01 * i))
    out, t = [], 0.0
    while sch.pending() and t < 100.0:
        out.append(([(j.tenant, j.req_id, j.bits) for j in sch.drain(t)],
                    sch.budget_remaining(t), sch.next_tick_time(t)))
        t = sch.next_tick_time(t)
    return (out, sch.tick_grants, sch.grant_shares(), sch.quantum_bits,
            plain(specs), reg.to_prometheus_text())


@pytest.mark.parametrize("budget,quantum", [(None, None), (5000, None),
                                            (5000, 700), (1500, None)])
def test_drr_scheduler_matches_jax(budget, quantum):
    out = both(_sched_run, budget, quantum)
    assert sum(len(g) for g, _, _ in out[0]) == 30
    if budget is not None:
        assert all(v <= budget for v in out[1].values())


@pytest.mark.parametrize("case", [
    lambda S: S.DeficitRoundRobinScheduler([]),
    lambda S: S.DeficitRoundRobinScheduler([S.TenantSpec("a"),
                                            S.TenantSpec("a")]),
    lambda S: S.DeficitRoundRobinScheduler([S.TenantSpec("a")], tick_s=0),
    lambda S: S.TenantSpec("a", weight=0.0),
    lambda S: S.TenantSpec("a", tasks=("",)),
    lambda S: S.DeficitRoundRobinScheduler([S.TenantSpec("a")]).enqueue(
        S.UplinkJob(tenant="z", req_id=0, bits=8, t_enqueue=0.0)),
    lambda S: S.DeficitRoundRobinScheduler([S.TenantSpec("a")]).enqueue(
        S.UplinkJob(tenant="a", req_id=0, bits=0, t_enqueue=0.0)),
])
def test_scheduler_refuses_alike(case):
    both_raise(lambda pkg: lambda: case(pkg.S))


# ---------------------------------------------------------------------------
# Micro-batcher
# ---------------------------------------------------------------------------

def _batch_view(b):
    key = b.key
    return ((key.c, key.bits, key.h, key.w), [r.req_id for r in b.requests],
            [r.tenant for r in b.requests], b.pad, b.target, b.padded_size,
            b.priority, b.encoded,
            None if b.codes is None else plain([b.codes, b.mins, b.maxs]))


def _batcher_run(pkg, adaptive, decoded):
    S = pkg.S
    b = S.MicroBatcher(max_batch=4, window_s=0.05, adaptive=adaptive,
                       min_window_s=0.005)
    ops = [pkg.P.OperatingPoint(c=4, bits=8, backend="rans"),
           pkg.P.OperatingPoint(c=8, bits=4)]
    rng = np.random.default_rng(5)
    out, t = [], 0.0
    for i in range(23):
        t += float(rng.exponential(0.01))
        k = int(rng.integers(2))
        c = ops[k].c
        if decoded:
            req = S.DecodedRequest(
                req_id=i, codes=rng.integers(0, 255, (1, 4, 4, c), np.uint8),
                mins=rng.normal(size=(1, 1, 1, c)).astype(np.float16),
                maxs=rng.normal(size=(1, 1, 1, c)).astype(np.float16),
                c=c, bits=ops[k].bits, t_arrive=t, tenant="xy"[i % 2],
                priority=i % 3)
        else:
            blob = SimpleNamespace(op=ops[k], shape=(1, 4, 4, c))
            req = S.EncodedRequest(req_id=i, blob=blob, t_arrive=t,
                                   tenant="xy"[i % 2], priority=i % 3)
        out.append([_batch_view(x) for x in b.add(req)])
        dl = b.deadline(req.key)
        out.append((dl, b.arrival_gap_ewma(req.key), len(b)))
        if i % 7 == 6 and dl is not None:
            taken = b.take(req.key, dl[1] + 1)          # a stale generation
            out.append(taken)
            out.append(_batch_view(b.take(req.key, dl[1])))
    out.append([_batch_view(x) for x in b.flush()])
    return out


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("decoded", [False, True])
def test_micro_batcher_matches_jax(adaptive, decoded):
    both(_batcher_run, adaptive, decoded)


def test_bucket_sizes_match_jax():
    sizes = both(lambda pkg: [pkg.S.bucket_sizes(n) for n in range(1, 20)])
    assert sizes[7] == (1, 2, 4, 8)
    assert sizes[5] == (1, 2, 4, 6)


@pytest.mark.parametrize("kw", [dict(max_batch=0), dict(window_s=-1.0),
                                dict(adaptive=True),
                                dict(window_s=0.1, min_window_s=-1.0)])
def test_micro_batcher_refuses_alike(kw):
    both_raise(lambda pkg: lambda: pkg.S.MicroBatcher(**kw))


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------

def _records(S, n=40, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(S.RequestRecord(
            req_id=i, c=int(rng.choice([4, 8, 16])),
            bits=int(rng.choice([4, 8])),
            bits_on_wire=int(rng.integers(500, 20000)),
            wire_latency_s=float(rng.uniform(0.001, 0.05)),
            queue_wait_s=float(rng.uniform(-1e-6, 0.02)),
            compute_s=float(rng.uniform(0.002, 0.01)),
            batch_size=int(rng.integers(1, 5)), padded_size=4,
            tenant=["gold", "silver", "bronze"][i % 3],
            sched_wait_s=float(rng.uniform(0.0, 0.01)),
            exec_queue=i % 2))
    return out


def _telemetry_run(pkg, max_records, with_shed):
    S = pkg.S
    tel = S.Telemetry(max_records=max_records)
    for rec in _records(S):
        tel.record(rec)
    if with_shed:
        for i in range(5):
            tel.record_shed(S.ShedRecord(req_id=100 + i, tenant="bronze",
                                         t_submit=0.1 * i, reason="full",
                                         priority=0))
        tel.record_shed(S.ShedRecord(req_id=0, tenant="lost", t_submit=0.0,
                                     reason="token-bucket"))
        tel.record_degrade(S.DegradeRecord(tenant="gold", t=0.2, frame_seq=3,
                                           from_level=0, to_level=1,
                                           reason="queue-depth"))
    pct = [tel.percentile(f, p, tenant=t)
           for f in ("total_latency_s", "compute_s", "queue_wait_s")
           for p in (0, 50, 99) for t in (None, "gold")]
    return (len(tel), tel.truncated, tel.tenants(), tel.per_tenant(),
            tel.summary(wall_s=2.0), tel.format_summary(wall_s=2.0), pct,
            tel.fairness(), tel.shed_rate(), tel.shed_by_tenant(),
            tel.degrade_by_tenant(), tel.metrics.to_prometheus_text())


@pytest.mark.parametrize("max_records", [None, 5])
@pytest.mark.parametrize("with_shed", [False, True])
def test_telemetry_matches_jax(max_records, with_shed):
    out = both(_telemetry_run, max_records, with_shed)
    assert out[0] == 40


def test_telemetry_empty_and_fairness_match_jax():
    def run(pkg):
        S = pkg.S
        tel = S.Telemetry()
        empty = (tel.summary(), tel.format_summary(), tel.per_tenant())
        tel.record_shed(S.ShedRecord(req_id=0, tenant="a", t_submit=0.0,
                                     reason="r"))
        return (empty, tel.summary(), tel.format_summary(),
                raised(lambda: tel.percentile("total_latency_s", 50)),
                [S.jain_fairness(v) for v in ([], [0, 0], [1, 1, 1],
                                              [5, 1, 0], [3.5])])
    both(run)


@pytest.mark.parametrize("case", [
    lambda S: S.Telemetry(max_records=0),
    lambda S: S.Telemetry().percentile("compute_s", 50, tenant="x"),
])
def test_telemetry_refuses_alike(case):
    both_raise(lambda pkg: lambda: case(pkg.S))


def test_truncated_telemetry_refuses_alike():
    def make(pkg):
        tel = pkg.S.Telemetry(max_records=2)
        for rec in _records(pkg.S, n=4):
            tel.record(rec)
        return lambda: (tel.fairness("compute_s"),)
    both_raise(make)
    both_raise(lambda pkg: _truncated_percentile(pkg))


def _truncated_percentile(pkg):
    tel = pkg.S.Telemetry(max_records=2)
    for rec in _records(pkg.S, n=4):
        tel.record(rec)
    return lambda: tel.percentile("bits_on_wire", 50)


# ---------------------------------------------------------------------------
# Executors, cost models and admission
# ---------------------------------------------------------------------------

def _mbatch(S, n, key, priority, target):
    reqs = [SimpleNamespace(priority=priority) for _ in range(n)]
    return S.MicroBatch(key=key, requests=reqs, target=target)


def _ticket(t):
    return {f.name: getattr(t, f.name) for f in dataclasses.fields(t)
            if f.name not in ("batch", "logits")}


def _executor_run(pkg, kind):
    S = pkg.S
    if kind == "linear":
        cost = S.LinearCostModel(base_s=0.002, per_item_s=0.001)
    elif kind == "calibrated":
        cost = S.CalibratedCostModel(seed_base_s=0.001, seed_per_item_s=0.0)
    else:
        cost = S.MeasuredCost()
    ex = S.MultiQueueExecutor(3, rates=[1.0, 0.5, 2.0], cost=cost)
    ex.metrics = pkg.O.MetricsRegistry()
    ex.run_fn = lambda b: (b.padded_size, 0.0005 + 0.001 * b.padded_size)
    rng = np.random.default_rng(9)
    out, t = [], 0.0
    for i in range(30):
        t += float(rng.exponential(0.003))
        n = int(rng.integers(1, 5))
        batch = _mbatch(S, n, "kxy"[int(rng.integers(3))],
                        int(rng.integers(3)), n + int(rng.integers(2)))
        ticket = ex.submit(batch, t)
        out.append((_ticket(ticket), ticket.logits, ex.depth(),
                    ex.queue_depths(), ex.busy_until()))
        ex.on_start(ticket)
        for done in ex.poll(t):
            out.append(("done", done.seq))
            ex.complete(done)
        if kind == "calibrated" and i == 14:
            out.append((cost.fit(), cost.fit_rel_err()))
            cost.freeze()
    for done in ex.drain():
        ex.complete(done)
    out.append([_ticket(x) for x in ex.history])
    out.append((ex.capacity, ex.max_depth_seen, ex.utilization(0.5)))
    out.append(ex.export_metrics().to_prometheus_text())
    ex.reset()
    out.append((ex.depth(), ex.history, ex.queue_depths()))
    return out


@pytest.mark.parametrize("kind", ["linear", "calibrated", "measured"])
def test_executor_matches_jax(kind):
    both(_executor_run, kind)


def test_serial_executor_and_calibration_match_jax():
    def run(pkg):
        S = pkg.S
        ex = S.SerialExecutor(cost=S.LinearCostModel())
        ex.run_fn = lambda b: (None, 0.0)
        tickets = [_ticket(ex.submit(_mbatch(S, 2, None, 0, 2), 0.001 * i))
                   for i in range(5)]
        cal = S.CalibratedCostModel(seed_base_s=0.003, seed_per_item_s=0.002)
        fits = [cal.fit()]
        cal.observe(4, 0.01)
        fits.append(cal.fit())                   # one size: seed slope kept
        for n, y in ((1, 0.004), (2, 0.0061), (8, 0.0178), (8, 0.018)):
            cal.observe(n, y)
        fits += [cal.fit(), cal.fit_rel_err(), cal.freeze().predict(6)]
        return tickets, fits
    both(run)


class _Depth:
    def __init__(self):
        self.d = 0

    def depth(self):
        return self.d


def _admission_run(pkg):
    S = pkg.S
    policies = [
        S.AlwaysAdmit(),
        S.TokenBucketAdmission(20.0, 2.0, per_tenant={"gold": (50.0, 4.0)}),
        S.QueueDepthAdmission(2, per_priority=S.priority_depth_limits(
            2, [0, 1, 2], headroom=2)),
        S.CompositeAdmission([
            S.TokenBucketAdmission(30.0, 3.0),
            S.QueueDepthAdmission(3, per_priority={2: 6})]),
    ]
    fake = _Depth()
    out = []
    for pol in policies:
        pol.reset()
        rng = np.random.default_rng(11)
        t = 0.0
        for i in range(40):
            t += float(rng.exponential(0.02))
            fake.d = int(rng.integers(0, 8))
            tenant = ["gold", "silver", "bronze"][i % 3]
            out.append(plain(pol.admit(tenant=tenant, priority=2 - i % 3,
                                       t=t, executor=fake)))
    out.append(S.priority_depth_limits(3, [0, 1, 4]))
    out.append(S.QueueDepthAdmission(4, per_priority={1: 9}).limit_for(1))
    return out


def test_admission_policies_match_jax():
    out = both(_admission_run)
    assert sum(d[1]["admitted"] for d in out[:160] if isinstance(d, tuple)) \
        < 160


@pytest.mark.parametrize("case", [
    lambda S: S.MultiQueueExecutor(0),
    lambda S: S.MultiQueueExecutor(2, rates=[1.0]),
    lambda S: S.MultiQueueExecutor(2, rates=[1.0, 0.0]),
    lambda S: S.CalibratedCostModel(seed_base_s=-1.0),
    lambda S: S.CalibratedCostModel().freeze().observe(1, 0.1),
    lambda S: S.SerialExecutor().submit(_mbatch(S, 1, None, 0, 1), 0.0),
    lambda S: S.SerialExecutor().export_metrics(),
    lambda S: S.TokenBucketAdmission(0.0, 1.0),
    lambda S: S.TokenBucketAdmission(1.0, 1.0, per_tenant={"a": (1.0, 0.0)}),
    lambda S: S.QueueDepthAdmission(0),
    lambda S: S.QueueDepthAdmission(2, per_priority={1: 0}),
    lambda S: S.CompositeAdmission([]),
    lambda S: S.priority_depth_limits(0, [0]),
    lambda S: S.priority_depth_limits(1, [0], headroom=-1),
    lambda S: S.AdmissionPolicy().admit(tenant="a", priority=0, t=0.0,
                                        executor=None),
    lambda S: S.CostModel().duration_s(None, 0.0),
])
def test_executor_refuses_alike(case):
    both_raise(lambda pkg: lambda: case(pkg.S))


def test_ticket_completed_twice_refused_alike():
    def make(pkg):
        ex = pkg.S.SerialExecutor(cost=pkg.S.LinearCostModel())
        ex.run_fn = lambda b: (None, 0.0)
        t = ex.submit(_mbatch(pkg.S, 1, None, 0, 1), 0.0)
        ex.complete(t)
        return lambda: ex.complete(t)
    assert both_raise(make)[0] == "RuntimeError"


def test_request_shed_matches_jax():
    both(lambda pkg: (plain(pkg.S.RequestShed(req_id=1, tenant="a",
                                              t_submit=0.5, reason="r")),
                      pkg.S.RequestShed(1, "a", 0.5, "r").shed))


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------

def _tracer_run(pkg):
    O = pkg.O
    tr = O.Tracer(process_name="gw")
    rng = np.random.default_rng(13)
    t = 0.0
    for i in range(12):
        t += float(rng.uniform(0.001, 0.01))
        track = f"tenant:{'ab'[i % 2]}"
        tr.instant("submit", t, track=track, req_id=i)
        root = tr.span("request", t, t + 0.03, track=track, tenant="ab"[i % 2],
                       req_id=i, op="OperatingPoint(c=8)")
        tr.span("sched.wait", t, t + 0.01, track=track, parent=root)
        tr.span("channel.transmit", t + 0.01, t + 0.02, track=track,
                parent=root, wire_bits=1234)
        tr.span("cloud.compute", t + 0.02, t + 0.03, track=track,
                parent=root)
        tr.span("exec.batch", t + 0.02, t + 0.03, track=f"exec-q{i % 2}",
                seq=i)
    tr.validate()
    roots = [s.span_id for s in tr.roots("request")]
    kids = [[s.name for s in tr.children(r)] for r in roots]
    return (tr.to_json(), len(tr), roots, kids,
            O.validate_chrome_trace(tr.to_chrome()))


def test_tracer_json_is_byte_identical_to_jax(tmp_path):
    out = both(_tracer_run)
    json.loads(out[0])
    paths = []
    for k, pkg in enumerate(PKGS):
        tr = pkg.O.Tracer()
        tr.span("x", 0.0, 1.0, a=1)
        paths.append(tmp_path / f"t{k}.json")
        tr.save(paths[-1])
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_reconcile_trace_matches_jax():
    def run(pkg):
        S, O = pkg.S, pkg.O
        tel = S.Telemetry()
        tr = O.Tracer()
        for rec in _records(S, n=9):
            tel.record(rec)
            t0 = 1.0 + rec.req_id
            root = tr.span("request", t0, t0 + rec.total_latency_s,
                           tenant=rec.tenant, req_id=rec.req_id)
            t = t0
            for d in (rec.sched_wait_s, rec.wire_latency_s,
                      rec.queue_wait_s, rec.compute_s):
                tr.span("part", t, t + d, parent=root)
                t += d
        return O.reconcile_trace(tr, tel)
    assert both(run) < 1e-9


@pytest.mark.parametrize("obj", [
    [], {"x": 1}, {"traceEvents": {}}, {"traceEvents": [1]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1}]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1}]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0,
                      "dur": -1}]},
    {"traceEvents": [{"ph": "i", "name": "a", "pid": 1, "tid": 1}]},
    {"traceEvents": [{"ph": "B", "name": "a", "pid": 1, "tid": 1}]},
])
def test_chrome_trace_validation_refuses_alike(obj):
    both_raise(lambda pkg: lambda: pkg.O.validate_chrome_trace(obj))


@pytest.mark.parametrize("spans", [
    [("a", 1.0, 0.0, None)],
    [("a", 0.0, 1.0, 5)],
    [("a", 0.0, 1.0, None), ("b", 0.5, 2.0, 0)],
])
def test_span_tree_validation_refuses_alike(spans):
    def make(pkg):
        tr = pkg.O.Tracer()
        for name, t0, t1, parent in spans:
            tr.spans.append(pkg.O.Span(span_id=len(tr.spans), name=name,
                                       t0=t0, t1=t1, track="g",
                                       parent=parent))
        return tr.validate
    both_raise(make)


def test_reconcile_trace_refuses_alike():
    def make(pkg):
        tel = pkg.S.Telemetry()
        tel.record(_records(pkg.S, n=1)[0])
        return lambda: pkg.O.reconcile_trace(pkg.O.Tracer(), tel)
    both_raise(make)

    def childless(pkg):
        tr = pkg.O.Tracer()
        tr.span("request", 0.0, 1.0, tenant="", req_id=0)
        return lambda: pkg.O.reconcile_trace(tr, pkg.S.Telemetry())
    both_raise(childless)


# ---------------------------------------------------------------------------
# Bench records
# ---------------------------------------------------------------------------

def _bench_pair(O, base_metrics, cur_metrics, *, name="codec",
                cur_name=None, cur_config=None):
    base = O.bench_record(name, config={"n": 4}, metrics=base_metrics)
    cur = O.bench_record(cur_name or name, config=cur_config or {"n": 4},
                         metrics=cur_metrics, raw={"rows": [1, 2]})
    return base, cur


BENCH_CASES = {
    "ok": ({"a": (1.0, "lower", 0.1)}, {"a": (1.05, "lower", 0.1)}, {}),
    "regressed": ({"a": (1.0, "lower", 0.1), "b": (10.0, "higher", 0.05)},
                  {"a": (1.2, "lower", 0.1), "b": (9.0, "higher", 0.05)}, {}),
    "improved": ({"a": (1.0, "lower", 0.1)}, {"a": (0.5, "lower", 0.1)}, {}),
    "zero_base": ({"a": (0.0, "lower", 0.01), "b": (0.0, "higher", 0.01)},
                  {"a": (0.02, "lower", 0.01), "b": (0.02, "higher", 0.01)},
                  {}),
    "missing_and_new": ({"a": (1.0, "lower", 0.1), "i": (3.0, "lower", None)},
                        {"n": (2.0, "lower", None)}, {}),
    "name": ({"a": (1.0, "lower", 0.1)}, {"a": (1.0, "lower", 0.1)},
             {"cur_name": "other"}),
    "config": ({"a": (1.0, "lower", 0.1)}, {"a": (1.0, "lower", 0.1)},
               {"cur_config": {"n": 8}}),
}


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
@pytest.mark.parametrize("allow", [False, True])
def test_bench_compare_matches_jax(case, allow):
    base_m, cur_m, kw = BENCH_CASES[case]

    def run(pkg):
        O = pkg.O

        def ms(d):
            return {k: O.metric(v, better=b, tolerance=t)
                    for k, (v, b, t) in d.items()}
        base, cur = _bench_pair(O, ms(base_m), ms(cur_m), **kw)
        ok, deltas = O.compare(cur, base, allow_config_drift=allow)
        return (base, cur, ok, plain(deltas),
                O.format_report(deltas), O.format_report(deltas,
                                                         verbose=False))
    both(run)


def test_bench_files_are_byte_identical(tmp_path):
    paths = []
    for k, pkg in enumerate(PKGS):
        rps = pkg.O.metric(12.5, better="higher")
        rec = pkg.O.bench_record("gw", config={"seed": 0},
                                 metrics={"rps": rps})
        paths.append(tmp_path / f"BENCH_{k}.json")
        pkg.O.write_bench(paths[-1], rec)
        assert pkg.O.load_bench(paths[-1]) == rec
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION


@pytest.mark.parametrize("rec", [
    [], {"schema": "x"}, {"schema": "repro-bench/1", "name": ""},
    {"schema": "repro-bench/1", "name": "a", "config": []},
    {"schema": "repro-bench/1", "name": "a", "config": {}, "metrics": []},
    {"schema": "repro-bench/1", "name": "a", "config": {},
     "metrics": {"m": {}}},
    {"schema": "repro-bench/1", "name": "a", "config": {},
     "metrics": {"m": {"value": "1"}}},
    {"schema": "repro-bench/1", "name": "a", "config": {},
     "metrics": {"m": {"value": 1, "better": "up"}}},
    {"schema": "repro-bench/1", "name": "a", "config": {},
     "metrics": {"m": {"value": 1, "tolerance": -1}}},
])
def test_bench_validation_refuses_alike(rec):
    both_raise(lambda pkg: lambda: pkg.O.compare(rec, rec))


@pytest.mark.parametrize("kw", [dict(better="up"), dict(tolerance=-0.5)])
def test_bench_metric_refuses_alike(kw):
    both_raise(lambda pkg: lambda: pkg.O.metric(1.0, **kw))


def test_metric_nan_tolerance_free_values_match():
    both(lambda pkg: [pkg.O.metric(v) for v in (0.0, 1e-300, 7, math.pi)])
