"""The port's serving gateway, rate control and fidelity metrics against the
JAX package's, at smoke scale (32x32 images, a bank of BaF predictors for
C in {4, 8}).

Weights are drawn by the JAX initialisers (BN statistics and PReLU slopes
randomised from numpy) and bridged into the port. Both packages get the same
split activation z: the port's edge function is pinned to the JAX edge's
output, since a last-bit difference in z moves a code. The cost model is
``LinearCostModel`` wherever two runs are compared, so the virtual clocks
depend on the workload alone. Then records, shed records, scheduler grants,
wire bytes and trace JSON must be identical; logits agree at 1e-4, PSNR at
1e-3 dB and KL at 1e-4.
"""
import dataclasses
import filecmp
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.serve as jserve
import repro.serve.rate_control as jrc
import repro_torch.obs as tobs
import repro_torch.serve as tserve
import repro_torch.serve.rate_control as trc
from repro import pipeline as jpipe
from repro.configs.yolo_baf import smoke_config as jax_smoke_config
from repro.core.baf import BaFConvConfig as JBaFConfig
from repro.core.baf import init_baf_conv
from repro.core.split import activation_stats as jax_activation_stats
from repro.core.split import fidelity_metrics as jax_fidelity
from repro.models.cnn import cnn_edge, init_cnn
from repro_torch import pipeline as tpipe
from repro_torch.bridge import baf_from_jax, cnn_from_jax
from repro_torch.configs.yolo_baf import smoke_config
from repro_torch.core.baf import BaFConvConfig
from repro_torch.core.split import SplitInferenceEngine, activation_stats
from repro_torch.core.split import fidelity_metrics

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
BANK_C = (4, 8)
N_IMGS = 8


def _randomize(tree, rng):
    """Random BN statistics and PReLU slopes, as numpy leaves."""
    def walk(t):
        if isinstance(t, dict):
            if set(t) == {"scale", "bias", "mean", "var"}:
                n = t["scale"].shape
                return {"scale": rng.uniform(0.5, 1.5, n), "bias":
                        rng.normal(size=n) * 0.1, "mean":
                        rng.normal(size=n) * 0.1, "var":
                        rng.uniform(0.5, 2.0, n)}
            if set(t) == {"alpha"}:
                return {"alpha": rng.uniform(0.0, 0.5, t["alpha"].shape)}
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return np.asarray(t)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), walk(tree))


_jax_edge = jax.jit(lambda p, i: cnn_edge(p, i)[1])


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(0)
    jcfg = jax_smoke_config()._replace(input_size=32)
    tcfg = smoke_config()._replace(input_size=32)
    params = _randomize(init_cnn(jax.random.PRNGKey(0), jcfg), rng)
    model = cnn_from_jax(params, tcfg, device="cpu")
    order = rng.permutation(tcfg.split_p)
    jbank, tbank = {}, {}
    for k, c in enumerate(BANK_C):
        baf = _randomize(init_baf_conv(jax.random.PRNGKey(1 + k), JBaFConfig(
            c=c, q=jcfg.split_q, hidden=8)), rng)
        jbank[c] = (jax.tree.map(jnp.asarray, baf), order[:c])
        tbank[c] = (baf_from_jax(baf, BaFConvConfig(c=c, q=tcfg.split_q,
                                                    hidden=8), device="cpu"),
                    order[:c])
    jparams = jax.tree.map(jnp.asarray, params)
    imgs = rng.normal(size=(N_IMGS, 32, 32, 3)).astype(np.float32)
    zs = {}

    def jax_z(img: np.ndarray) -> np.ndarray:
        """The JAX edge's z for a (1, H, W, 3) or (B, H, W, 3) image."""
        key = img.tobytes()
        if key not in zs:
            zs[key] = np.asarray(_jax_edge(jparams, jnp.asarray(img)))
        return zs[key]
    return dict(jparams=jparams, model=model, jbank=jbank, tbank=tbank,
                imgs=imgs, jax_z=jax_z)


def _pin(gw, s):
    """Feed the port's gateway the JAX edge's z for each image."""
    gw._edge_fn = lambda img: torch.from_numpy(
        np.array(s["jax_z"](img.numpy())))
    return gw


def _table(pkg_rc, backend):
    """The committed RD cache's table, parsed by one package."""
    path = ROOT / "benchmarks" / f"rd_cache_{backend}_seed0.json"
    import json
    return pkg_rc.rd_table_from_json(json.loads(path.read_text())["points"])


def _plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)
                                   if f.name != "logits"})
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _watch(executor):
    """Record each submitted batch's wire bytes and padded logits."""
    seen = []
    submit = executor.submit

    def watched(batch, t_ready, *, run_fn=None):
        ticket = submit(batch, t_ready, run_fn=run_fn)
        seen.append(([r.blob.data for r in batch.requests],
                     batch.padded_size, np.asarray(ticket.logits)))
        return ticket
    executor.submit = watched
    return seen


def _same_batches(jseen, tseen):
    assert len(jseen) == len(tseen) > 0
    for (jd, jn, jl), (td, tn, tl) in zip(jseen, tseen):
        assert td == jd                          # wire bytes, request order
        assert tn == jn and tl.shape == jl.shape == (tn, tl.shape[1])
        np.testing.assert_allclose(tl, jl, **TOL)


def _same_responses(jresp, tresp):
    assert _plain(tresp) == _plain(jresp)
    flat_j = jresp if isinstance(jresp, list) else \
        [r for t in sorted(jresp) for r in jresp[t]]
    flat_t = tresp if isinstance(tresp, list) else \
        [r for t in sorted(tresp) for r in tresp[t]]
    for j, t in zip(flat_j, flat_t):
        if not j.shed:
            np.testing.assert_allclose(np.asarray(t.logits),
                                       np.asarray(j.logits), **TOL)


def _same_telemetry(jtel, ttel):
    assert _plain(ttel.records) == _plain(jtel.records)
    assert _plain(ttel.shed) == _plain(jtel.shed)
    assert _plain(ttel.degraded) == _plain(jtel.degraded)
    assert ttel.summary(wall_s=1.0) == jtel.summary(wall_s=1.0)
    assert ttel.format_summary() == jtel.format_summary()


# ---------------------------------------------------------------------------
# core/split: activation stats and fidelity metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", BANK_C)
def test_activation_stats_equal_on_the_same_z(system, c):
    s = system
    z = s["jax_z"](s["imgs"][:3])
    sel = s["tbank"][c][1]
    want = jax_activation_stats(z, sel)
    assert dataclasses.asdict(activation_stats(z, sel)) == \
        dataclasses.asdict(want)
    assert dataclasses.asdict(activation_stats(torch.tensor(z), sel)) == \
        dataclasses.asdict(want)


@pytest.mark.parametrize("c", BANK_C)
@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("consolidation", [True, False])
def test_fidelity_metrics_match_jax(system, c, bits, consolidation):
    s = system
    imgs = s["imgs"][:4]
    z = s["jax_z"](imgs)
    (jbaf, sel), (tbaf, _) = s["jbank"][c], s["tbank"][c]
    jpsnr, jkl = jax_fidelity(s["jparams"], jbaf, sel, jnp.asarray(imgs),
                              bits=bits, consolidation=consolidation,
                              z=jnp.asarray(z))
    tpsnr, tkl = fidelity_metrics(s["model"], tbaf, sel, imgs, bits=bits,
                                  consolidation=consolidation, z=z,
                                  device="cpu")
    assert abs(tpsnr - jpsnr) <= 1e-3
    assert abs(tkl - jkl) <= 1e-4
    # without z: the port's own edge, whose z is within 1e-4 of JAX's
    epsnr, _ = fidelity_metrics(s["model"], tbaf, sel, imgs, bits=bits,
                                consolidation=consolidation, device="cpu")
    assert np.isfinite(epsnr)


def test_engine_fidelity_is_fidelity_metrics(system):
    s = system
    tbaf, sel = s["tbank"][8]
    eng = SplitInferenceEngine(s["model"], tbaf, sel, bits=6, device="cpu")
    assert eng.fidelity(s["imgs"][:2]) == fidelity_metrics(
        s["model"], tbaf, sel, s["imgs"][:2], bits=6, device="cpu")


# ---------------------------------------------------------------------------
# rate control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["rans", "zlib"])
def test_build_rd_table_matches_jax(system, monkeypatch, backend):
    s = system
    calib = s["imgs"][:3]
    jtable = jserve.build_rd_table(s["jparams"], s["jbank"], calib,
                                   bits_sweep=(4, 8), backend=backend)
    _, cloud = trc.cnn_fns(s["model"])
    monkeypatch.setattr(trc, "cnn_fns", lambda m: (
        lambda img: torch.from_numpy(np.array(s["jax_z"](img.numpy()))),
        cloud))
    ttable = tserve.build_rd_table(s["model"], s["tbank"], calib,
                                   bits_sweep=(4, 8), backend=backend,
                                   device="cpu")
    assert len(ttable) == len(jtable) == 4
    for j, t in zip(jtable, ttable):
        assert dataclasses.asdict(t.op) == dataclasses.asdict(j.op)
        assert t.bits_per_example == j.bits_per_example
        assert abs(t.psnr_db - j.psnr_db) <= 1e-3
        assert abs(t.kl - j.kl) <= 1e-4
        assert (t.calib_peak, t.calib_range) == (j.calib_peak, j.calib_range)


def test_build_rd_table_refuses_a_c_outside_the_bank(system):
    s = system
    ops = [tpipe.OperatingPoint(c=16, bits=4)]
    with pytest.raises(ValueError, match="bank holds"):
        tserve.build_rd_table(s["model"], s["tbank"], s["imgs"][:1], ops=ops,
                              device="cpu")


def test_codec_revision_is_the_reference_string():
    assert trc.codec_revision() == jrc.codec_revision() == "BaF2/rtc1/wp2"


@pytest.mark.parametrize("backend", ["rans", "zlib"])
def test_committed_rd_caches_load_identically(system, tmp_path, backend):
    """The committed caches hit in both packages (no build), give the same
    table, and come out byte-identical; they are read from copies."""
    s = system
    src = ROOT / "benchmarks" / f"rd_cache_{backend}_seed0.json"
    before = src.read_bytes()
    key = {"seed": 0, "calib": 4, "input": 32}

    def build():
        raise AssertionError("the committed cache missed")
    tables = []
    for k, (rc, bank) in enumerate(((jrc, s["jbank"]), (trc, s["tbank"]))):
        path = tmp_path / f"{k}.json"
        shutil.copy(src, path)
        ops = rc.rd_grid(bank, (4, 8), backend)
        tables.append(rc.rd_table_to_json(
            rc.load_or_build_rd_table(path, key, build, ops=ops)))
        assert filecmp.cmp(path, src, shallow=False)
    assert tables[0] == tables[1]
    assert src.read_bytes() == before


def test_rd_cache_misses_rebuild_alike(system, tmp_path):
    """A stale key rebuilds and writes the same file in both packages."""
    s = system
    table = _table(jrc, "rans")
    paths = []
    for k, rc in enumerate((jrc, trc)):
        tbl = rc.rd_table_from_json(jrc.rd_table_to_json(table))
        paths.append(tmp_path / f"{k}.json")
        shutil.copy(ROOT / "benchmarks" / "rd_cache_rans_seed0.json",
                    paths[-1])
        ops = rc.rd_grid({4: None, 8: None}, (4, 8), "rans")
        got = rc.load_or_build_rd_table(paths[-1], {"seed": 1},
                                        lambda t=tbl: t, ops=ops)
        assert rc.rd_table_to_json(got) == jrc.rd_table_to_json(table)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    with pytest.raises(TypeError):
        trc.load_or_build_rd_table(paths[1], {})
    assert s is not None


@pytest.mark.parametrize("backend", ["rans", "zlib"])
def test_controllers_pick_identical_points(system, backend):
    s = system
    jt, tt = _table(jrc, backend), _table(trc, backend)
    bits = sorted(p.bits_per_example for p in jt)
    budgets = [None, 0.0, bits[0], bits[1] - 1, bits[2] + 1, bits[-1] * 2]
    floors = [0.0, float(np.median([p.psnr_db for p in jt])), 99.0]
    z = s["jax_z"](s["imgs"][:1])
    stats = [None] + [{c: f(z, sel) for c, (_, sel) in s["tbank"].items()}
                      for f in (jax_activation_stats, activation_stats)][1:]
    jstats = {c: jax_activation_stats(z, sel)
              for c, (_, sel) in s["jbank"].items()}
    for floor in floors:
        jrc_, trc_ = (jrc.RateController(jt, quality_floor_db=floor),
                      trc.RateController(tt, quality_floor_db=floor))
        assert _plain(trc_.cheapest_meeting_floor()) == \
            _plain(jrc_.cheapest_meeting_floor())
        jck = jrc.ContentKeyedController(jt, quality_floor_db=floor)
        tck = trc.ContentKeyedController(tt, quality_floor_db=floor)
        for budget in budgets:
            assert _plain(trc_.select(budget)) == _plain(jrc_.select(budget))
            for js, ts in ((None, None), (jstats, stats[1]),
                           (jstats[8], stats[1][8])):
                for f in (None, 10.0):
                    assert _plain(tck.select_for(budget, ts, f)) == \
                        _plain(jck.select_for(budget, js, f))
            for p_j, p_t in zip(jck.table, tck.table):
                assert tck.estimate_psnr_db(p_t, stats[1]) == \
                    jck.estimate_psnr_db(p_j, jstats)
    for k in (0, 1, 4):
        for stride in (1, 3):
            pj = jrc.RDPoint(jt[0].op, 1000.0, 20.0, p_over_i=0.25)
            pt = trc.RDPoint(tt[0].op, 1000.0, 20.0, p_over_i=0.25)
            assert trc.session_bits_per_frame(
                pt, keyframe_interval=k, frame_stride=stride) == \
                jrc.session_bits_per_frame(pj, keyframe_interval=k,
                                           frame_stride=stride)
    with pytest.raises(ValueError, match="empty"):
        trc.RateController([], quality_floor_db=0.0)


# ---------------------------------------------------------------------------
# ServingGateway
# ---------------------------------------------------------------------------

def _single(pkg_serve, rc, params, bank, backend, fused, device=None):
    table = _table(rc, backend)
    budget = int(sorted(p.bits_per_example for p in table)[2])
    ch = pkg_serve.SimulatedChannel(pkg_serve.ChannelConfig(
        bandwidth_bps=2e6, base_latency_s=0.01, jitter_s=0.001, tick_s=0.004,
        budget_bits_per_tick=budget), seed=5)
    kw = {} if device is None else {"device": device}
    return pkg_serve.ServingGateway(
        params, bank, channel=ch, max_batch=8, fused=fused,
        controller=pkg_serve.RateController(table, quality_floor_db=15.0),
        executor=pkg_serve.SerialExecutor(cost=pkg_serve.LinearCostModel()),
        tracer=(jobs if pkg_serve is jserve else tobs).Tracer(),
        metrics=(jobs if pkg_serve is jserve else tobs).MetricsRegistry(),
        **kw)


@pytest.mark.parametrize("backend", ["rans", "zlib"])
@pytest.mark.parametrize("fused", [True, False])
def test_serving_gateway_matches_jax(system, backend, fused):
    s = system
    jgw = _single(jserve, jrc, s["jparams"], s["jbank"], backend, fused)
    tgw = _pin(_single(tserve, trc, s["model"], s["tbank"], backend, fused,
                       "cpu"), s)
    times = [0.0, 0.001, 0.001, 0.003, 0.02, 0.0205, 0.021]
    jseen, tseen = _watch(jgw.executor), _watch(tgw.executor)
    jresp, jtel = jgw.serve(s["imgs"][:7], submit_times=times)
    tresp, ttel = tgw.serve(s["imgs"][:7], submit_times=times)
    _same_batches(jseen, tseen)
    _same_responses(jresp, tresp)
    _same_telemetry(jtel, ttel)
    assert len({(r.c, r.bits) for r in ttel.records}) > 1   # rate control
    assert any(r.padded_size > r.batch_size for r in ttel.records)
    assert tgw.tracer.to_json() == jgw.tracer.to_json()
    assert tgw.metrics.to_prometheus_text() == \
        jgw.metrics.to_prometheus_text()


def test_serving_gateway_replays_and_refuses_alike(system):
    s = system
    tgw = _pin(_single(tserve, trc, s["model"], s["tbank"], "rans", True,
                       "cpu"), s)
    first = tgw.serve(s["imgs"][:3])[1].records
    tgw.channel.reset()
    assert tgw.serve(s["imgs"][:3])[1].records == first

    def errors(S, params, bank, kw):
        ex = S.SerialExecutor()
        S.ServingGateway(params, bank, executor=ex, **kw)
        cases = [
            lambda: S.ServingGateway(params, {}, **kw),
            lambda: S.ServingGateway(params, bank, executor=ex, **kw),
            lambda: S.ServingGateway(params, bank, shared_executor=True,
                                     **kw),
            lambda: S.ServingGateway(params, bank, default_op=S.OperatingPoint(
                c=16, bits=8), **kw),
        ]
        out = []
        for case in cases:
            with pytest.raises(ValueError) as e:
                case()
            out.append(str(e.value))
        return out
    assert errors(tserve, s["model"], s["tbank"], {"device": "cpu"}) == \
        errors(jserve, s["jparams"], s["jbank"], {})


def test_gateway_needs_its_models_on_its_device(system):
    s = system
    with pytest.raises(ValueError, match="lives on"):
        tserve.ServingGateway(s["model"], s["tbank"], device="meta")


@pytest.mark.parametrize("caps,want", [
    (dict(backends=("zlib",)), ("zlib", 8)),
    (dict(max_bits=4), ("rans", 4)),
    (dict(backends=("zlib",), downgrade=False), "NegotiationError"),
    (dict(profiles=(1,)), "NegotiationError"),
    (dict(max_bits=4, downgrade=False), "NegotiationError"),
])
def test_negotiation_downgrades_and_refuses_as_jax(system, caps, want):
    s = system
    got = []
    for S, params, bank, kw, pin in (
            (jserve, s["jparams"], s["jbank"], {}, False),
            (tserve, s["model"], s["tbank"], {"device": "cpu"}, True)):
        op = S.OperatingPoint(c=8, bits=8, backend="rans")
        try:
            gw = S.ServingGateway(params, bank, default_op=op, max_batch=4,
                                  capabilities=S.Capabilities(**caps),
                                  executor=S.SerialExecutor(
                                      cost=S.LinearCostModel()), **kw)
        except S.NegotiationError as e:
            got.append(("NegotiationError", str(e)))
            continue
        if pin:
            _pin(gw, s)
        resp, tel = gw.serve(s["imgs"][:2])
        got.append(((resp[0].op.wire_backend, resp[0].op.bits),
                    _plain([r.op for r in resp]), _plain(tel.records)))
    assert got[0] == got[1]
    assert got[1][0] == want


# ---------------------------------------------------------------------------
# MultiTenantGateway, federation
# ---------------------------------------------------------------------------

def _scenario(name, S, rc, params, bank, device):
    kw = {} if device is None else {"device": device}
    O = jobs if S is jserve else tobs
    cost = S.LinearCostModel(base_s=0.004, per_item_s=0.001)
    common = dict(tracer=O.Tracer(), metrics=O.MetricsRegistry(), **kw)
    table = _table(rc, "rans")
    floor = float(np.median([p.psnr_db for p in table]))
    if name == "drr":
        gw = S.MultiTenantGateway(
            params, bank, tenants=[S.TenantSpec("a", weight=3.0),
                                   S.TenantSpec("b"),
                                   S.TenantSpec("c", weight=0.5)],
            controller=S.RateController(table, quality_floor_db=floor),
            channel_cfg=S.ChannelConfig(bandwidth_bps=2e6,
                                        base_latency_s=0.01),
            budget_bits_per_tick=6000, tick_s=0.01, max_batch=4,
            batch_window_s=0.02, executor=S.SerialExecutor(cost=cost),
            **common)
        tenants, spacing = "abcab", 0.002
    elif name == "content":
        gw = S.MultiTenantGateway(
            params, bank, tenants=[
                S.TenantSpec("premium", weight=3.0, quality_floor_db=floor),
                S.TenantSpec("besteffort", quality_floor_db=0.0)],
            controller=S.ContentKeyedController(table, quality_floor_db=floor),
            channel_cfg=S.ChannelConfig(bandwidth_bps=2e6,
                                        base_latency_s=0.01, jitter_s=0.002),
            budget_bits_per_tick=5000, tick_s=0.05, max_batch=4,
            batch_window_s=0.02, adaptive_window=True, min_window_s=0.002,
            executor=S.SerialExecutor(cost=cost), seed=3, **common)
        tenants, spacing = ["premium", "besteffort"], 0.004
    else:                                       # overload, demo part 7
        gw = S.MultiTenantGateway(
            params, bank, tenants=[S.TenantSpec("gold", weight=2.0,
                                                priority=2),
                                   S.TenantSpec("silver", priority=1),
                                   S.TenantSpec("bronze", priority=0)],
            channel_cfg=S.ChannelConfig(bandwidth_bps=50e6,
                                        base_latency_s=0.001),
            default_op=S.OperatingPoint(c=8, bits=8, backend="rans"),
            max_batch=4, batch_window_s=0.002,
            executor=S.MultiQueueExecutor(2, cost=cost),
            admission=S.CompositeAdmission([
                S.TokenBucketAdmission(4000.0, 6.0),
                S.QueueDepthAdmission(2, per_priority=S.priority_depth_limits(
                    2, [0, 1, 2], headroom=2))]),
            **common)
        tenants, spacing = ["gold", "silver", "bronze"], 1 / 3000.0
    n = 24 if name == "overload" else 12
    return gw, [(tenants[i % len(tenants)], i % N_IMGS, spacing * i)
                for i in range(n)]


def _work(S, spec, imgs):
    return [S.TenantRequest(t, imgs[k], t_submit=ts) for t, k, ts in spec]


@pytest.mark.parametrize("name", ["drr", "content", "overload"])
def test_multi_tenant_gateway_matches_jax(system, name):
    s = system
    jgw, spec = _scenario(name, jserve, jrc, s["jparams"], s["jbank"], None)
    tgw, _ = _scenario(name, tserve, trc, s["model"], s["tbank"], "cpu")
    _pin(tgw, s)
    jseen, tseen = _watch(jgw.executor), _watch(tgw.executor)
    jresp, jtel = jgw.serve_tenants(_work(jserve, spec, s["imgs"]))
    tresp, ttel = tgw.serve_tenants(_work(tserve, spec, s["imgs"]))
    _same_batches(jseen, tseen)
    _same_responses(jresp, tresp)
    _same_telemetry(jtel, ttel)
    assert tgw.last_scheduler.tick_grants == jgw.last_scheduler.tick_grants
    assert tgw.last_scheduler.grant_shares() == \
        jgw.last_scheduler.grant_shares()
    assert tgw.tracer.to_json() == jgw.tracer.to_json()
    assert tgw.metrics.to_prometheus_text() == \
        jgw.metrics.to_prometheus_text()
    assert tobs.reconcile_trace(tgw.tracer, ttel) < 1e-9
    n = len(spec)
    assert len(ttel) + len(ttel.shed) == n
    if name == "overload":
        assert ttel.shed and len(ttel) > 0
    if name == "content":
        assert len({(r.c, r.bits) for r in ttel.records}) > 1


def test_multi_tenant_gateway_replays_bit_identically(system):
    s = system
    tgw, spec = _scenario("overload", tserve, trc, s["model"], s["tbank"],
                          "cpu")
    _pin(tgw, s)
    work = _work(tserve, spec, s["imgs"])
    first = tgw.serve_tenants(work)[1]
    tgw.tracer = tobs.Tracer()
    again = tgw.serve_tenants(work)[1]
    assert again.records == first.records and again.shed == first.shed


def test_multi_tenant_gateway_refuses_alike(system):
    s = system

    def errors(S, params, bank, kw):
        t = [S.TenantSpec("a")]
        metered = S.ChannelConfig(budget_bits_per_tick=100)
        gw = S.MultiTenantGateway(params, bank, tenants=t, **kw)
        cases = [
            lambda: S.MultiTenantGateway(params, bank, tenants=[], **kw),
            lambda: S.MultiTenantGateway(params, bank, tenants=t,
                                         channel_cfg=metered, **kw),
            lambda: S.MultiTenantGateway(
                params, bank, tenants=t,
                channels={"a": S.SimulatedChannel(metered)}, **kw),
            lambda: S.MultiTenantGateway(params, bank, tenants=t,
                                         channels={}, **kw),
            lambda: gw.serve_tenants([S.TenantRequest("zz", None)]),
            lambda: S.serve_federated([]),
            lambda: S.serve_federated([(gw, []), (gw, [])]),
            lambda: S.serve_federated([(gw, []), (S.MultiTenantGateway(
                params, bank, tenants=t, **kw), [])]),
            lambda: S.GatewayFederation([]),
            lambda: S.GatewayFederation([gw, S.MultiTenantGateway(
                params, bank, tenants=t, **kw)]),
            lambda: S.GatewayFederation([gw]).serve([[], []]),
        ]
        ex = S.MultiQueueExecutor(2)
        fa = S.MultiTenantGateway(params, bank, tenants=t, executor=ex,
                                  shared_executor=True, **kw)
        fb = S.MultiTenantGateway(params, bank, tenants=t, executor=ex, **kw)
        cases.append(lambda: S.GatewayFederation([fa, fb]))
        return [raised(c) for c in cases]
    got = errors(tserve, s["model"], s["tbank"], {"device": "cpu"})
    assert got == errors(jserve, s["jparams"], s["jbank"], {})
    assert all(g is not None for g in got)


def raised(fn):
    """(exception class name, message) of what ``fn()`` raises."""
    try:
        fn()
    except Exception as e:              # the type itself is compared
        return type(e).__name__, str(e)
    return None


def _federation(S, rc, params, bank, device):
    kw = {} if device is None else {"device": device}
    ex = S.MultiQueueExecutor(2, cost=S.LinearCostModel(base_s=0.01,
                                                        per_item_s=0.002))
    gws = []
    for k in range(2):
        gws.append(S.MultiTenantGateway(
            params, bank, tenants=[S.TenantSpec(f"t{k}a", priority=1),
                                   S.TenantSpec(f"t{k}b")],
            channel_cfg=S.ChannelConfig(bandwidth_bps=20e6,
                                        base_latency_s=0.002),
            default_op=S.OperatingPoint(c=4 * (k + 1), bits=6,
                                        backend="rans"),
            max_batch=4, batch_window_s=0.003, executor=ex,
            shared_executor=True,
            admission=S.QueueDepthAdmission(1, per_priority={1: 2}),
            seed=10 * k, **kw))
    return gws


@pytest.mark.parametrize("via", ["federation", "serve_federated"])
def test_federation_matches_jax(system, via):
    s = system
    out = []
    for S, rc, params, bank, dev in (
            (jserve, jrc, s["jparams"], s["jbank"], None),
            (tserve, trc, s["model"], s["tbank"], "cpu")):
        gws = _federation(S, rc, params, bank, dev)
        if S is tserve:
            for gw in gws:
                _pin(gw, s)
        works = [[S.TenantRequest(f"t{k}{'ab'[i % 2]}", s["imgs"][i % N_IMGS],
                                  t_submit=0.0005 * i) for i in range(10)]
                 for k in range(2)]
        if via == "federation":
            fed = S.GatewayFederation(gws)
            res = fed.serve(works)
            depth = fed.depth()
        else:
            res = S.serve_federated(list(zip(gws, works)))
            depth = gws[0].executor.depth()
        out.append((res, depth))
    (jres, jdepth), (tres, tdepth) = out
    assert tdepth == jdepth == 0
    for (jr, jt), (tr, tt) in zip(jres, tres):
        _same_responses(jr, tr)
        _same_telemetry(jt, tt)
    assert sum(len(t.shed) for _, t in tres) > 0


def test_gateway_demo_runs_on_the_cpu(capsys):
    """``python -m repro_torch.launch.gateway_demo --fast --device cpu``:
    all seven parts and their checks, to the last OK line."""
    from repro_torch.launch import gateway_demo
    assert gateway_demo.main(["--fast", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    oks = [ln for ln in out.splitlines() if ln.startswith("OK:")]
    assert len(oks) == 4 and oks[-1].startswith("OK: 3x burst")
    for part in range(1, 8):
        assert f"== {part}." in out
