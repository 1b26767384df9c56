"""The port's multi-task layer against the JAX package's, at smoke scale.

Bit allocation, task negotiation, the head registry and the cache key are
compared field by field (the same decisions, exceptions and messages). The
heads run on weights bridged from the JAX bank (``bridge.heads_from_jax``)
over the same z: each within 1e-5 in float32, the detect head through the
port's flash wrapper (its plain version on the CPU) against JAX's
``attention_apply``. The task RD sweep and ``MultiTaskGateway`` run with the
port's edge pinned to the JAX edge's z: wire bits, records, counters and
trace JSON identical, divergences within 1e-6 relative, outputs within 1e-4.
The committed task cache is read from a copy, never written.
"""
import copy
import dataclasses
import filecmp
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.serve as jserve
import repro.tasks as jtasks
import repro_torch.obs as tobs
import repro_torch.serve as tserve
import repro_torch.tasks as ttasks
import repro_torch.tasks.distortion as tdist
from repro import pipeline as jpipe
from repro.configs.yolo_baf import smoke_config as jax_smoke_config
from repro.core.baf import BaFConvConfig as JBaFConfig
from repro.core.baf import init_baf_conv
from repro.models import attention as JA
from repro.models.cnn import cnn_edge, init_cnn
from repro_torch import pipeline as tpipe
from repro_torch.bridge import baf_from_jax, cnn_from_jax, heads_from_jax
from repro_torch.configs.yolo_baf import smoke_config
from repro_torch.core.baf import BaFConvConfig
from repro_torch.kernels import flash_attention as tflash

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
HEAD_TOL = dict(atol=1e-5, rtol=1e-5)
J = (jpipe, jtasks, jserve, jobs)
T = (tpipe, ttasks, tserve, tobs)


def plain(x):
    """Package-free view: dataclasses as (class name, fields), numpy arrays
    as (dtype, shape, bytes); floats compared exactly."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)
                                   if f.name not in ("outputs", "logits")})
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def raised(fn):
    """(exception class name, message) of what ``fn()`` raises."""
    try:
        fn()
    except Exception as e:              # the type itself is compared
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# Bit allocation on hand-written tables
# ---------------------------------------------------------------------------

_QUAL = {"a": (10.0, 20.0, 30.0, 40.0), "b": (5.0, 12.0, 25.0, 35.0),
         "c": (2.0, 8.0, 15.0, 30.0)}
_POINTS = ((4, 2, 1000.0), (4, 4, 2000.0), (8, 4, 4000.0), (8, 8, 8000.0))


def _tables(S, tasks=("a", "b", "c")):
    return {t: [S.RDPoint(S.OperatingPoint(c=c, bits=b, backend="rans"),
                          bits_per_example=bits, psnr_db=q)
                for (c, b, bits), q in zip(_POINTS, _QUAL[t])]
            for t in tasks}


ALLOC_CASES = [
    dict(floors={"a": 18.0, "b": 10.0}),
    dict(),
    dict(floors={"a": 35.0, "b": 30.0, "c": 28.0}),
    dict(floors={"a": 45.0, "b": 40.0}, weights={"a": 2.0, "b": 0.5}),
    dict(floors={"a": 15.0}, weights={"c": 3.0}, default_floor_db=9.0),
]


@pytest.mark.parametrize("case", range(len(ALLOC_CASES)))
@pytest.mark.parametrize("declared", [("a",), ("b", "a"), ("a", "b", "c"),
                                      ("c", "c")])
def test_allocation_decisions_match_jax(case, declared):
    budgets = [None, 500.0, 1000.0, 2500.0, 4000.0, 7999.0, 1e9]

    def run(S, T):
        ctl = T.BitAllocationController(_tables(S), **ALLOC_CASES[case])
        return [(plain(ctl.select(declared, b)),
                 ctl.independent_bits(declared, b)) for b in budgets]
    assert run(tserve, ttasks) == run(jserve, jtasks)


@pytest.mark.parametrize("case", [
    lambda S, T: T.BitAllocationController({}),
    lambda S, T: T.BitAllocationController({"a": []}),
    lambda S, T: T.BitAllocationController(_tables(S), weights={"a": 0.0}),
    lambda S, T: T.BitAllocationController(_tables(S)).select(()),
    lambda S, T: T.BitAllocationController(_tables(S)).select(("zz",)),
    lambda S, T: T.BitAllocationController(
        {"a": _tables(S)["a"][:1],
         "b": _tables(S)["b"][1:2]}).select(("a", "b")),
])
def test_allocation_refuses_alike(case):
    assert raised(lambda: case(tserve, ttasks)) == \
        raised(lambda: case(jserve, jtasks))


@pytest.mark.parametrize("caps", [
    None, dict(), dict(task_heads=("classify", "embed")),
    dict(task_heads=("classify", "embed"), downgrade=False),
    dict(task_heads=("x",)), dict(task_heads=())])
@pytest.mark.parametrize("declared", [("classify",), ("embed", "classify",
                                                      "embed"),
                                      ("detect", "classify"), ()])
def test_negotiate_tasks_matches_jax(caps, declared):
    def run(P):
        c = None if caps is None else P.Capabilities(**caps)
        return P.negotiate_tasks(declared, c)
    assert raised(lambda: run(tpipe)) == raised(lambda: run(jpipe))
    if raised(lambda: run(jpipe)) is None:
        assert run(tpipe) == run(jpipe)
    c = tpipe.Capabilities(**(caps or {}))
    jc = jpipe.Capabilities(**(caps or {}))
    assert [c.serves_task(t) for t in ("classify", "detect")] == \
        [jc.serves_task(t) for t in ("classify", "detect")]


# ---------------------------------------------------------------------------
# Registry, divergences and cache keys
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    assert ttasks.available_heads() == jtasks.available_heads() == \
        ("classify", "detect", "embed")
    assert raised(lambda: ttasks.get_head("nope")) == \
        raised(lambda: jtasks.get_head("nope"))
    assert raised(lambda: ttasks.register_head(ttasks.TaskHead(
        name="classify", init=None, forward=None, divergence=None))) == \
        raised(lambda: jtasks.register_head(jtasks.TaskHead(
            name="classify", init=None, forward=None, divergence=None)))
    assert raised(lambda: ttasks.HeadConfig(split_p=64, d_model=30,
                                            n_heads=4).head_dim) == \
        raised(lambda: jtasks.HeadConfig(split_p=64, d_model=30,
                                         n_heads=4).head_dim)
    assert ttasks.HeadConfig(split_p=64) == tuple(jtasks.HeadConfig(
        split_p=64))


@pytest.mark.parametrize("task", ["classify", "detect", "embed"])
def test_divergences_match_jax(task):
    rng = np.random.default_rng(5)
    ref = rng.normal(size=(3, 4, 13)).astype(np.float32)
    out = ref + 0.05 * rng.normal(size=ref.shape).astype(np.float32)
    j, t = jtasks.get_head(task), ttasks.get_head(task)
    assert t.divergence(ref, out) == j.divergence(ref, out)
    assert t.divergence(ref, ref) == j.divergence(ref, ref)
    assert ttasks.task_divergences({task: ref, "x": ref}, {task: out}) == \
        jtasks.task_divergences({task: ref, "x": ref}, {task: out})


@pytest.mark.parametrize("d", [0.0, 1e-30, 1e-6, 0.1, 2.5])
def test_divergence_to_db_matches_jax(d):
    assert ttasks.divergence_to_db(d) == jtasks.divergence_to_db(d)


@pytest.mark.parametrize("names,weights", [
    (("classify", "detect", "embed"), {"detect": 3.0, "embed": 0.5}),
    (("embed", "classify"), None), (("a",), {"a": 2})])
def test_task_set_key_matches_jax(names, weights):
    assert ttasks.task_set_key(names, weights) == \
        jtasks.task_set_key(names, weights)


def test_task_cache_misses_write_the_same_bytes(tmp_path):
    """A miss (no file, a stale key, a corrupt file) rebuilds and writes the
    same JSON in both packages; a hit returns the same table."""
    out = []
    for k, (S, T) in enumerate(((jserve, jtasks), (tserve, ttasks))):
        path = tmp_path / f"{k}.json"
        tables = _tables(S, ("a", "b"))
        ops = [p.op for p in tables["a"]]
        calls = []

        def build(t=tables):
            calls.append(1)
            return t
        key = T.task_set_key(("a", "b"), {"a": 2.0})
        T.load_or_build_task_tables(path, {"seed": 1}, build, ops=ops,
                                    tasks=key)
        first = path.read_bytes()
        hit = T.load_or_build_task_tables(path, {"seed": 1}, build, ops=ops,
                                          tasks=key)
        T.load_or_build_task_tables(path, {"seed": 1}, build, ops=ops,
                                    tasks=T.task_set_key(("a",)))
        path.write_text("{not json")
        T.load_or_build_task_tables(path, {"seed": 1}, build, ops=ops,
                                    tasks=key)
        out.append((first, path.read_bytes(), len(calls),
                    {t: S.rd_table_to_json(v) for t, v in hit.items()},
                    raised(lambda: T.load_or_build_task_tables(
                        path, {}, ops=ops, tasks=key))))
    assert out[1] == out[0]
    assert out[1][2] == 3


def test_committed_task_cache_hits_in_the_port(tmp_path):
    """``benchmarks/rd_cache_tasks_seed5.json`` (written by the JAX
    benchmark) hits under the port's key: no build, the same tables as the
    JAX package reads, and the copy is left byte-identical."""
    src = ROOT / "benchmarks" / "rd_cache_tasks_seed5.json"
    before = src.read_bytes()

    def build():
        raise AssertionError("the committed task cache missed")
    tables = []
    for k, (P, S, T) in enumerate(((jpipe, jserve, jtasks),
                                   (tpipe, tserve, ttasks))):
        path = tmp_path / f"{k}.json"
        shutil.copy(src, path)
        ops = [P.OperatingPoint(c=c, bits=b, backend="rans")
               for c in (4, 8) for b in (2, 4, 6, 8)]
        key = {"seed": 5, "image_size": 32, "n_calib": 4, "head_seed": 99,
               "anchor": repr(P.OperatingPoint(c=8, bits=6,
                                               backend="rans"))}
        got = T.load_or_build_task_tables(
            path, key, build, ops=ops,
            tasks=T.task_set_key(("classify", "detect", "embed"),
                                 {"classify": 1.0, "detect": 3.0,
                                  "embed": 0.5}))
        tables.append(json.dumps({t: S.rd_table_to_json(v)
                                  for t, v in sorted(got.items())}))
        assert filecmp.cmp(path, src, shallow=False)
    assert tables[1] == tables[0]
    assert src.read_bytes() == before


# ---------------------------------------------------------------------------
# Heads, the sweep and the gateway on bridged weights
# ---------------------------------------------------------------------------

_jax_edge = jax.jit(lambda p, i: cnn_edge(p, i)[1])


def _randomize(tree, rng):
    """Random BN statistics, PReLU slopes and LayerNorm affine terms and
    non-zero biases, as numpy leaves: zero biases and unit scales would
    hide a mistake in the bridge."""
    def walk(t, key=""):
        if isinstance(t, dict):
            if set(t) == {"scale", "bias", "mean", "var"}:
                n = t["scale"].shape
                return {"scale": rng.uniform(0.5, 1.5, n), "bias":
                        rng.normal(size=n) * 0.1, "mean":
                        rng.normal(size=n) * 0.1, "var":
                        rng.uniform(0.5, 2.0, n)}
            if set(t) == {"alpha"}:
                return {"alpha": rng.uniform(0.0, 0.5, t["alpha"].shape)}
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        a = np.asarray(t)
        if key == "scale":
            return rng.uniform(0.5, 1.5, a.shape)
        if key in ("b", "bias", "bq", "bk", "bv"):
            return rng.normal(size=a.shape) * 0.1
        return a
    return jax.tree.map(lambda a: np.asarray(a, np.float32), walk(tree))


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(0)
    jcfg = jax_smoke_config()._replace(input_size=32)
    tcfg = smoke_config()._replace(input_size=32)
    params = _randomize(init_cnn(jax.random.PRNGKey(0), jcfg), rng)
    model = cnn_from_jax(params, tcfg, device="cpu")
    order = rng.permutation(tcfg.split_p)
    jbank, tbank = {}, {}
    for k, c in enumerate((4, 8)):
        baf = _randomize(init_baf_conv(jax.random.PRNGKey(1 + k), JBaFConfig(
            c=c, q=jcfg.split_q, hidden=8)), rng)
        jbank[c] = (jax.tree.map(jnp.asarray, baf), order[:c])
        tbank[c] = (baf_from_jax(baf, BaFConvConfig(c=c, q=tcfg.split_q,
                                                    hidden=8), device="cpu"),
                    order[:c])
    jhc = jtasks.HeadConfig(split_p=jcfg.split_p, num_classes=jcfg.num_classes)
    thc = ttasks.HeadConfig(*jhc)
    heads = _randomize(jtasks.init_head_bank(jax.random.PRNGKey(99), jhc),
                       rng)
    jparams = jax.tree.map(jnp.asarray, params)
    imgs = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    zs = {}

    def jax_z(img: np.ndarray) -> np.ndarray:
        key = img.tobytes()
        if key not in zs:
            zs[key] = np.asarray(_jax_edge(jparams, jnp.asarray(img)))
        return zs[key]
    return dict(jparams=jparams, model=model, jbank=jbank, tbank=tbank,
                jhc=jhc, thc=thc,
                jheads=jax.tree.map(jnp.asarray, heads),
                theads=heads_from_jax(heads, thc, device="cpu"),
                imgs=imgs, jax_z=jax_z)


@pytest.mark.parametrize("task", ["classify", "detect", "embed"])
@pytest.mark.parametrize("hw", [4, 8])
def test_each_head_matches_jax(system, task, hw):
    s = system
    z = np.random.default_rng(hw).normal(
        size=(3, hw, hw, s["thc"].split_p)).astype(np.float32)
    want = jtasks.run_heads(s["jparams"], s["jheads"], jnp.asarray(z),
                            (task,), s["jhc"])[task]
    got = ttasks.run_heads(s["model"], s["theads"], torch.from_numpy(z),
                           (task,), s["thc"])[task]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **HEAD_TOL)


def test_detect_head_runs_the_flash_wrapper(system, monkeypatch):
    """The detect head's attention is the flash wrapper's (on the CPU its
    plain version), non-causal, one call per forward; the JAX side's
    attention at the same weights agrees."""
    s = system
    calls = []
    inner = tflash.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), q.dtype, kw))
        return inner(q, k, v, **kw)
    import repro_torch.models.attention as TA
    monkeypatch.setattr(TA, "flash_attention", spy)
    z = np.array(s["jax_z"](s["imgs"][:2]))
    ttasks.run_heads(s["model"], s["theads"], torch.from_numpy(z),
                     ("detect", "classify"), s["thc"])
    hd = s["thc"].head_dim
    assert calls == [((2, z.shape[1] * z.shape[2], s["thc"].n_heads, hd),
                      torch.float32, dict(causal=False, window=None))]
    assert JA._backend() == "jnp"


def test_head_bank_draws_from_a_generator():
    cfg = ttasks.HeadConfig(split_p=16)
    a = ttasks.init_head_bank(torch.Generator().manual_seed(3), cfg,
                              device="cpu")
    b = ttasks.init_head_bank(torch.Generator().manual_seed(3), cfg,
                              device="cpu")
    assert sorted(a) == ["classify", "detect", "embed"]
    for name in a:
        for x, y in zip(a[name].parameters(), b[name].parameters()):
            assert torch.equal(x, y)
    only = ttasks.init_head_bank(torch.Generator().manual_seed(3), cfg,
                                 heads=("embed",), device="cpu")
    assert list(only) == ["embed"]


def _pin_sweep(monkeypatch, s):
    _, cloud = tdist.cnn_fns(s["model"])
    monkeypatch.setattr(tdist, "cnn_fns", lambda m: (
        lambda img: torch.from_numpy(np.array(s["jax_z"](img.numpy()))),
        cloud))


def test_task_rd_tables_match_jax(system, monkeypatch):
    """Same z: per-request wire bits identical at every point and task,
    divergences within 1e-6 relative."""
    s = system
    calib = s["imgs"][:4]
    ops = [(c, b) for c in (4, 8) for b in (2, 6)]
    jt = jtasks.build_task_rd_tables(
        s["jparams"], s["jbank"], calib, head_bank=s["jheads"],
        head_cfg=s["jhc"],
        ops=[jserve.OperatingPoint(c=c, bits=b, backend="rans")
             for c, b in ops])
    _pin_sweep(monkeypatch, s)
    tt = ttasks.build_task_rd_tables(
        s["model"], s["tbank"], calib, head_bank=s["theads"],
        head_cfg=s["thc"],
        ops=[tserve.OperatingPoint(c=c, bits=b, backend="rans")
             for c, b in ops], device="cpu")
    assert sorted(tt) == sorted(jt) == ["classify", "detect", "embed"]
    for task in jt:
        assert len(tt[task]) == len(jt[task]) == len(ops)
        for j, t in zip(jt[task], tt[task]):
            assert dataclasses.asdict(t.op) == dataclasses.asdict(j.op)
            assert t.bits_per_example == j.bits_per_example
            np.testing.assert_allclose(t.kl, j.kl, rtol=1e-6, atol=0)
            assert abs(t.psnr_db - j.psnr_db) <= 1e-5


def test_task_rd_tables_refuse_a_c_outside_the_bank(system):
    s = system
    args = dict(head_bank=s["theads"], head_cfg=s["thc"])
    assert raised(lambda: ttasks.build_task_rd_tables(
        s["model"], s["tbank"], s["imgs"][:1],
        ops=[tserve.OperatingPoint(c=16, bits=4, backend="rans")],
        device="cpu", **args)) == raised(lambda: jtasks.build_task_rd_tables(
            s["jparams"], s["jbank"], s["imgs"][:1], head_bank=s["jheads"],
            head_cfg=s["jhc"],
            ops=[jserve.OperatingPoint(c=16, bits=4, backend="rans")]))


# the gateway: hand-written tables over real operating points, as in the
# reference's tests (classify alone is happy at the cheap point, detect's
# floor forces the expensive one)
_GW_POINTS = ((4, 2, 1000.0), (8, 6, 4000.0))
_GW_QUAL = {"classify": (20.0, 30.0), "detect": (8.0, 25.0),
            "embed": (15.0, 28.0)}
GW_FLOORS = {"classify": 15.0, "detect": 20.0, "embed": 10.0}


def _gw_tables(S):
    return {t: [S.RDPoint(S.OperatingPoint(c=c, bits=b, backend="rans"),
                          bits, q) for (c, b, bits), q in zip(_GW_POINTS, qs)]
            for t, qs in _GW_QUAL.items()}


def _gateway(pkgs, s, *, tenants, allocator="default", **kw):
    P, T, S, O = pkgs
    port = T is ttasks
    if allocator == "default":
        allocator = T.BitAllocationController(_gw_tables(S), floors=GW_FLOORS)
    kw.setdefault("executor", S.SerialExecutor(
        cost=S.LinearCostModel(0.004, 0.001)))
    kw.setdefault("max_batch", 4)
    kw.setdefault("batch_window_s", 0.01)
    if "default_op" in kw:
        c, b = kw["default_op"]
        kw["default_op"] = S.OperatingPoint(c=c, bits=b, backend="rans")
    if "capabilities" in kw:
        kw["capabilities"] = P.Capabilities(**kw["capabilities"])
    gw = T.MultiTaskGateway(
        s["model"] if port else s["jparams"],
        s["tbank"] if port else s["jbank"],
        tenants=[S.TenantSpec(n, tasks=t) for n, t in tenants],
        head_bank=s["theads"] if port else s["jheads"],
        head_cfg=s["thc"] if port else s["jhc"], allocator=allocator,
        tracer=O.Tracer(), metrics=O.MetricsRegistry(),
        **({"device": "cpu"} if port else {}), **kw)
    if port:
        gw._edge_fn = lambda img: torch.from_numpy(
            np.array(s["jax_z"](img.numpy())))
    return gw


def _same_outputs(jresp, tresp):
    flat_j = jresp if isinstance(jresp, list) else \
        [r for t in sorted(jresp) for r in jresp[t]]
    flat_t = tresp if isinstance(tresp, list) else \
        [r for t in sorted(tresp) for r in tresp[t]]
    assert len(flat_t) == len(flat_j) > 0
    for j, t in zip(flat_j, flat_t):
        if j.shed:
            continue
        assert sorted(t.outputs) == sorted(j.outputs)
        for task in j.outputs:
            np.testing.assert_allclose(t.outputs[task],
                                       np.asarray(j.outputs[task]), **TOL)
        np.testing.assert_allclose(t.logits, np.asarray(j.logits), **TOL)


MIXED = [("full", ()), ("lite", ("classify",))]


@pytest.mark.parametrize("workload", ["mixed", "embed_detect", "overload"])
def test_multi_task_gateway_matches_jax(system, workload):
    s = system
    tenants = {"mixed": MIXED,
               "embed_detect": [("a", ("embed", "detect")),
                                ("b", ("classify", "embed"))],
               "overload": MIXED}[workload]
    n = 12 if workload == "overload" else 8
    spacing = 0.0002 if workload == "overload" else 0.001
    runs = []
    for pkgs in (J, T):
        S = pkgs[2]
        kw = {}
        if workload == "overload":
            kw = dict(admission=S.TokenBucketAdmission(1000.0, 2.0),
                      executor=S.MultiQueueExecutor(
                          2, cost=S.LinearCostModel(0.004, 0.001)))
        gw = _gateway(pkgs, s, tenants=tenants, **kw)
        work = [S.TenantRequest(tenants[i % 2][0], s["imgs"][i % 8],
                                t_submit=spacing * i) for i in range(n)]
        resp, tel = gw.serve_tenants(work)
        runs.append((gw, resp, tel))
    (jgw, jresp, jtel), (tgw, tresp, ttel) = runs
    assert plain(tresp) == plain(jresp)
    assert plain(ttel.records) == plain(jtel.records)
    assert plain(ttel.shed) == plain(jtel.shed)
    assert ttel.format_summary() == jtel.format_summary()
    assert (tgw.decode_calls, tgw.head_calls, tgw.task_sets) == \
        (jgw.decode_calls, jgw.head_calls, jgw.task_sets)
    assert tgw.tracer.to_json() == jgw.tracer.to_json()
    assert tgw.metrics.to_prometheus_text() == \
        jgw.metrics.to_prometheus_text()
    _same_outputs(jresp, tresp)
    assert all(1 <= c <= tgw.decode_calls for c in tgw.head_calls.values())
    if workload == "overload":
        assert len(ttel.shed) > 0
    if workload == "mixed":
        per = ttel.per_tenant()
        assert per["lite"]["bits_on_wire"] < per["full"]["bits_on_wire"]
        assert tgw.head_calls["classify"] == tgw.decode_calls


def test_multi_task_gateway_replays_identically(system):
    s = system
    gw = _gateway(T, s, tenants=MIXED)
    work = [tserve.TenantRequest(MIXED[i % 2][0], s["imgs"][i],
                                 t_submit=0.001 * i) for i in range(6)]
    r1, t1 = gw.serve_tenants(work)
    r2, t2 = gw.serve_tenants(work)
    assert plain(t1.records) == plain(t2.records)
    for tenant in r1:
        for a, b in zip(r1[tenant], r2[tenant]):
            for task in a.outputs:
                assert np.array_equal(a.outputs[task], b.outputs[task])


@pytest.mark.parametrize("case", ["single", "no_allocator"])
def test_multi_task_gateway_variants_match_jax(system, case):
    s = system
    runs = []
    for pkgs in (J, T):
        S = pkgs[2]
        if case == "single":
            gw = _gateway(pkgs, s, tenants=[("t", ())], default_op=(8, 6))
            resp, tel = gw.serve(s["imgs"][:4])
        else:
            gw = _gateway(pkgs, s, tenants=[("lite", ("classify",))],
                          allocator=None, default_op=(4, 2))
            resp, tel = gw.serve_tenants([S.TenantRequest(
                "lite", s["imgs"][0])])
        runs.append((resp, tel, gw.decode_calls, gw.head_calls))
    (jresp, jtel, jd, jh), (tresp, ttel, td, th) = runs
    assert plain(tresp) == plain(jresp)
    assert plain(ttel.records) == plain(jtel.records)
    assert (td, th) == (jd, jh)
    _same_outputs(jresp, tresp)


@pytest.mark.parametrize("case", [
    dict(capabilities=dict(task_heads=("classify", "embed"), downgrade=True),
         tenants=[("t", ("classify", "detect"))]),
    dict(capabilities=dict(task_heads=("classify",), downgrade=False),
         tenants=[("t", ("classify", "detect"))]),
    dict(tenants=[("t", ("nope",))]),
    dict(tenants=[("t", ())], allocator="partial"),
])
def test_multi_task_gateway_negotiates_and_refuses_as_jax(system, case):
    s = system
    out = []
    for pkgs in (J, T):
        kw = dict(case)
        if kw.get("allocator") == "partial":
            S = pkgs[2]
            kw["allocator"] = pkgs[1].BitAllocationController(
                {t: v for t, v in _gw_tables(S).items() if t != "embed"})
        box = []
        err = raised(lambda: box.append(_gateway(pkgs, s, **kw)))
        out.append(err if err else box[0].task_sets)
    assert out[1] == out[0]


def test_multi_task_gateway_refuses_heads_on_another_device(system):
    s = system
    with pytest.raises(ValueError, match="lives on"):
        ttasks.MultiTaskGateway(
            s["model"], s["tbank"], tenants=[tserve.TenantSpec("t")],
            head_bank={"detect": copy.deepcopy(s["theads"]["detect"])
                       .to("meta")},
            head_cfg=s["thc"], device="cpu")
