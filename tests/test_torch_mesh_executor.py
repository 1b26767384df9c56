"""The port's sharded cloud tier (``serve/mesh_executor.py``,
``launch/mesh.py``) and the gateway's mesh path against the JAX package's.

The system is the reference test's smoke system (32x32 images, C=8, 8
bits, hidden 8) with the weights drawn by the JAX initialisers and bridged
into the port. The JAX ``MeshExecutor`` runs on meshes built with
``axis_types=(AxisType.Auto,) * 2`` (the default Explicit axes fail in its
``shard_map``): (1, 1) in this process, (4, 1) over 8 fake CPU devices in a
subprocess. Both packages restore the same decoded codes. The port at
data=1 is bit-identical to its serial path (``plan.restore`` + ``cloud``
at the padded size), at data=4 each shard is bit-identical to the serial
path at its row count, and both agree with the JAX executor at 1e-4.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro.launch.mesh as jmesh
import repro.serve as jserve
import repro_torch.launch.mesh as tmesh
import repro_torch.serve as tserve
import repro_torch.tasks as ttasks
from repro.configs.yolo_baf import smoke_config as jax_smoke_config
from repro.core.baf import BaFConvConfig as JBaFConfig
from repro.core.baf import init_baf_conv
from repro.models.cnn import cnn_edge, init_cnn
from repro_torch.bridge import baf_from_jax, cnn_from_jax
from repro_torch.configs.yolo_baf import smoke_config
from repro_torch.core.baf import BaFConvConfig
from repro_torch.distributed.sharding import axis_sizes
from repro_torch.pipeline.plan import DecodedBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 8
TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")


def _auto_mesh(n):
    return jax.make_mesh((n, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])


def _cpu_mesh(n=1):
    return tmesh.make_dev_mesh(n, prefer="data", device="cpu")


def raised(fn):
    """(exception class name, message) of what ``fn()`` raises."""
    try:
        fn()
    except Exception as e:              # the type itself is compared
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
def test_cpu_meshes_keep_the_reference_preferences(n):
    data = tmesh.make_dev_mesh(n, prefer="data", device="cpu")
    assert dict(data.shape) == {"data": n, "model": 1}
    assert data.devices == (CPU,) * n
    assert data.devices_along("data") == [CPU] * n
    model = tmesh.make_dev_mesh(n, device="cpu")
    m = next(f for f in (4, 2, 1) if n % f == 0)
    assert dict(model.shape) == {"data": n // m, "model": m}
    assert model.devices_along("model") == [CPU] * m


@pytest.mark.parametrize("prefer", ["data", "model"])
def test_one_device_mesh_is_the_references(prefer):
    assert dict(tmesh.make_dev_mesh(prefer=prefer, device="cpu").shape) == \
        dict(jmesh.make_dev_mesh(prefer=prefer).shape)


def test_make_dev_mesh_rejects_unknown_preference():
    got = raised(lambda: tmesh.make_dev_mesh(prefer="pod", device="cpu"))
    assert got == raised(lambda: jmesh.make_dev_mesh(prefer="pod"))
    assert got[0] == "ValueError" and "prefer" in got[1]


def test_production_meshes_name_the_references_shapes():
    one, multi = tmesh.make_production_mesh(), \
        tmesh.make_production_mesh(multi_pod=True)
    assert axis_sizes(one.shape) == {"data": 16, "model": 16}
    assert axis_sizes(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert one.devices == () and multi.devices == ()
    with pytest.raises(ValueError, match="holds no devices"):
        one.devices_along("data")


def test_local_mesh_lays_devices_out_row_major():
    devs = tuple(torch.device("cuda", i) for i in range(8))
    mesh = tmesh.LocalMesh({"data": 4, "model": 2}, devs)
    assert mesh.devices_along("data") == [devs[0], devs[2], devs[4], devs[6]]
    assert mesh.devices_along("model") == [devs[0], devs[1]]
    with pytest.raises(ValueError, match="do not fill"):
        tmesh.LocalMesh({"data": 4, "model": 2}, devs[:4])


def test_hardware_constants_are_the_h100_data_sheets():
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.PEAK_FLOPS_F32, tmesh.HBM_BW) == \
        (989e12, 67e12, 3.35e12)
    assert tmesh.NVLINK_BW > 0


# ---------------------------------------------------------------------------
# MeshExecutor: construction and the per-shard virtual clock
# ---------------------------------------------------------------------------

def _b(n):
    return SimpleNamespace(padded_size=n, key=None)


def test_mesh_executor_refusals_match_jax():
    jmesh_dd = jax.make_mesh((1, 1), ("pod", "model"),
                             axis_types=(AxisType.Auto,) * 2)
    tmesh_dd = tmesh.LocalMesh({"pod": 1, "model": 1}, (CPU,))
    plan = SimpleNamespace(spec=SimpleNamespace(params=None,
                                                baf_params=None))
    cases = [
        lambda S, m: S.MeshExecutor(m, cost=S.CalibratedCostModel()),
        lambda S, m: S.MeshExecutor(m["no_data"]),
        lambda S, m: S.MeshExecutor(
            m["one"], cost=S.LinearCostModel()).run_sharded(plan, None, 4),
    ]
    jm = {"no_data": jmesh_dd, "one": _auto_mesh(1)}
    tm = {"no_data": tmesh_dd, "one": _cpu_mesh()}
    got = [raised(lambda: c(tserve, tm)) for c in cases]
    assert got == [raised(lambda: c(jserve, jm)) for c in cases]
    assert [g[0] for g in got] == ["ValueError"] * 3
    assert "frozen" in got[0][1] and "'data'" in got[1][1] and \
        "weights" in got[2][1]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_plan_duration_is_per_shard(n):
    cal = tserve.CalibratedCostModel(seed_base_s=0.005, seed_per_item_s=0.001)
    ex = tserve.MeshExecutor(_cpu_mesh(n), cost=cal.freeze(),
                             overhead_s=0.002)
    assert ex.n_data == n
    assert ex.shard_rows(1) == 1
    assert ex.shard_rows(64) == math.ceil(64 / n)
    want = 0.002 + 0.005 + 0.001 * math.ceil(64 / n)
    assert ex._plan_duration(_b(64), 999.0) == pytest.approx(want)
    if n == 1:
        jcal = jserve.CalibratedCostModel(seed_base_s=0.005,
                                          seed_per_item_s=0.001).freeze()
        jex = jserve.MeshExecutor(_auto_mesh(1), cost=jcal, overhead_s=0.002)
        assert ex._plan_duration(_b(64), 999.0) == \
            jex._plan_duration(_b(64), 999.0)


# ---------------------------------------------------------------------------
# run_sharded on the reference's smoke system
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def system():
    jcfg = jax_smoke_config()._replace(input_size=32)
    tcfg = smoke_config()._replace(input_size=32)
    params = jax.tree.map(np.asarray, init_cnn(jax.random.PRNGKey(0), jcfg))
    baf = jax.tree.map(np.asarray, init_baf_conv(
        jax.random.PRNGKey(1), JBaFConfig(c=C, q=jcfg.split_q, hidden=8)))
    model = cnn_from_jax(params, tcfg, device="cpu")
    tbaf = baf_from_jax(baf, BaFConvConfig(c=C, q=tcfg.split_q, hidden=8),
                        device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    imgs = np.random.default_rng(123).normal(
        size=(16, 32, 32, 3)).astype(np.float32)
    edge = jax.jit(lambda p, i: cnn_edge(p, i)[1])
    zs = {}

    def jax_z(img):
        key = img.tobytes()
        if key not in zs:
            zs[key] = np.asarray(edge(jparams, jnp.asarray(img)))
        return zs[key]
    return dict(params=params, baf=baf, jparams=jparams,
                jbank={C: (jax.tree.map(jnp.asarray, baf), np.arange(C))},
                model=model, tbank={C: (tbaf, np.arange(C))}, imgs=imgs,
                jax_z=jax_z)


def _pin(gw, s):
    """Feed the port's gateway the JAX edge's z for each image."""
    gw._edge_fn = lambda img: torch.from_numpy(
        np.array(s["jax_z"](img.numpy())))
    return gw


@pytest.fixture(scope="module")
def decoded(system):
    """8 requests encoded and decoded by the JAX gateway's plan; the same
    codes and side info as the port's DecodedBatch."""
    s = system
    op = jserve.OperatingPoint(c=C, bits=8)
    jgw = jserve.ServingGateway(s["jparams"], s["jbank"], default_op=op,
                                max_batch=64)
    tgw = tserve.ServingGateway(s["model"], s["tbank"], default_op=op.resolve(),
                                max_batch=64, device="cpu")
    jplan = jgw.plan_for(jgw.default_op)
    blobs = [jgw.encode_request(s["imgs"][i][None])[1] for i in range(8)]
    jdec = jplan.decode_batch(blobs)
    tdec = DecodedBatch(codes=np.asarray(jdec.codes),
                        mins=np.asarray(jdec.mins), maxs=np.asarray(jdec.maxs))
    return dict(jgw=jgw, tgw=tgw, jplan=jplan, tplan=tgw.plan_for(
        tgw.default_op), jdec=jdec, tdec=tdec)


def _first(dec, n):
    return DecodedBatch(codes=dec.codes[:n], mins=dec.mins[:n],
                        maxs=dec.maxs[:n])


def _serial(tgw, plan, dec, rows):
    """The port's serial path at ``rows`` padded rows."""
    return tgw._cloud_fn(plan.restore(dec.pad_to(rows))).numpy()


@pytest.mark.parametrize("target", [4, 64])
def test_run_sharded_data1_bit_identical_and_matches_jax(decoded, target):
    d = decoded
    tdec = _first(d["tdec"], min(target, 8))
    ex = tserve.MeshExecutor(_cpu_mesh(), cost=tserve.LinearCostModel())
    got = ex.run_sharded(d["tplan"], tdec, target)
    serial = _serial(d["tgw"], d["tplan"], tdec, target)
    assert got.shape == (target,) + serial.shape[1:]
    assert np.array_equal(got, serial[:target])
    jex = jserve.MeshExecutor(_auto_mesh(1), cost=jserve.LinearCostModel())
    want = jex.run_sharded(d["jplan"], _jax_first(d["jdec"], min(target, 8)),
                           target)
    np.testing.assert_allclose(got, want, **TOL)
    # one entry per (plan, padded shape), as the reference's program cache
    assert len(ex._fns) == 1
    ex.run_sharded(d["tplan"], tdec, target)
    assert len(ex._fns) == 1
    assert ex._replicas == {}          # the plan's own device: no copies


def _jax_first(jdec, n):
    return dataclasses.replace(jdec, codes=jdec.codes[:n],
                               mins=jdec.mins[:n], maxs=jdec.maxs[:n])


JAX_MESH4 = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
import repro.serve as S
from repro.pipeline.plan import DecodedBatch
with open(sys.argv[1], "rb") as f:
    d = pickle.load(f)
tree = lambda t: jax.tree.map(jnp.asarray, t)
gw = S.ServingGateway(tree(d["params"]), {8: (tree(d["baf"]), np.arange(8))},
                      default_op=S.OperatingPoint(c=8, bits=8), max_batch=64)
plan = gw.plan_for(gw.default_op)
mesh = jax.make_mesh((4, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
ex = S.MeshExecutor(mesh, cost=S.LinearCostModel())
out = {}
for target in (4, 64):
    n = min(target, 8)
    dec = DecodedBatch(codes=d["codes"][:n], mins=d["mins"][:n],
                       maxs=d["maxs"][:n])
    out[f"t{target}"] = ex.run_sharded(plan, dec, target)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_mesh4(system, decoded, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh4")
    d = decoded["tdec"]
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(dict(params=system["params"], baf=system["baf"],
                         codes=d.codes, mins=d.mins, maxs=d.maxs), f)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    out = subprocess.run([sys.executable, "-c", JAX_MESH4,
                          str(tmp / "in.pkl"), str(tmp / "out.npz")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("target", [4, 64])
def test_run_sharded_data4_shards_bit_identical_and_match_jax(
        decoded, jax_mesh4, target):
    d = decoded
    tdec = _first(d["tdec"], min(target, 8))
    ex = tserve.MeshExecutor(_cpu_mesh(4), cost=tserve.LinearCostModel())
    got = ex.run_sharded(d["tplan"], tdec, target)
    rows = ex.shard_rows(target)
    padded = tdec.pad_to(rows * 4)
    for i in range(4):
        shard = DecodedBatch(codes=padded.codes[i * rows:(i + 1) * rows],
                             mins=padded.mins[i * rows:(i + 1) * rows],
                             maxs=padded.maxs[i * rows:(i + 1) * rows])
        want = _serial(d["tgw"], d["tplan"], shard, rows)
        assert np.array_equal(got[i * rows:(i + 1) * rows],
                              want[:max(0, min(rows, target - i * rows))])
    np.testing.assert_allclose(got, jax_mesh4[f"t{target}"], **TOL)
    assert len(ex._fns) == 1


def test_replicas_are_built_once_per_plan_and_device(decoded):
    """A mesh entry on another device than the plan's gets a replica plan
    (its own modules, selection and channel table) once; the plan's own
    device serves with the plan itself. ``meta`` stands in for another
    card: building the replica moves no numbers."""
    d = decoded
    ex = tserve.MeshExecutor(tmesh.LocalMesh(
        {"data": 2, "model": 1}, (CPU, torch.device("meta"))))
    plan = d["tplan"]
    assert ex._shard_plan(plan, CPU) is plan
    rep = ex._shard_plan(plan, torch.device("meta"))
    assert ex._shard_plan(plan, torch.device("meta")) is rep
    assert rep.device == torch.device("meta") and rep.op == plan.op
    assert rep._sel.device.type == "meta" and rep._order.device.type == "meta"
    assert next(rep.spec.params.parameters()).device.type == "meta"
    assert next(plan.spec.params.parameters()).device == CPU
    assert len(ex._replicas) == 1


# ---------------------------------------------------------------------------
# the gateway's mesh path
# ---------------------------------------------------------------------------

def test_gateway_routes_through_the_mesh_exactly_with_run_sharded(system):
    s = system
    op = tserve.OperatingPoint(c=C, bits=8)
    mesh = tserve.ServingGateway(s["model"], s["tbank"], default_op=op,
                                 executor=tserve.MeshExecutor(_cpu_mesh()),
                                 device="cpu")
    assert mesh._run_fn == mesh._run_batch_mesh
    assert mesh.executor.run_fn == mesh._run_batch_mesh
    serial = tserve.ServingGateway(s["model"], s["tbank"], default_op=op,
                                   device="cpu")
    assert serial._run_fn == serial._run_batch
    duck = tserve.SerialExecutor()
    duck.run_sharded = "not callable"
    gw = tserve.ServingGateway(s["model"], s["tbank"], default_op=op,
                               executor=duck, device="cpu")
    assert gw._run_fn == gw._run_batch
    imgs = s["imgs"][:6]
    want = serial.serve(imgs)[0]
    got = mesh.serve(imgs)[0]
    for a, b in zip(want, got):
        assert np.array_equal(a.logits, b.logits)


def test_multi_task_gateway_refuses_a_mesh_executor(system):
    s = system
    hc = ttasks.HeadConfig(split_p=smoke_config().split_p)
    heads = ttasks.init_head_bank(torch.Generator().manual_seed(0), hc,
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="run_sharded") as err:
        ttasks.MultiTaskGateway(
            s["model"], s["tbank"], tenants=[tserve.TenantSpec("t")],
            head_bank=heads, head_cfg=hc,
            executor=tserve.MeshExecutor(_cpu_mesh()), device="cpu")
    import repro.tasks as jtasks
    jhc = jtasks.HeadConfig(split_p=hc.split_p)
    jheads = jtasks.init_head_bank(jax.random.PRNGKey(0), jhc)
    want = raised(lambda: jtasks.MultiTaskGateway(
        s["jparams"], s["jbank"], tenants=[jserve.TenantSpec("t")],
        head_bank=jheads, head_cfg=jhc,
        executor=jserve.MeshExecutor(_auto_mesh(1))))
    assert want == ("NotImplementedError", str(err.value))


# ---------------------------------------------------------------------------
# gateway federation on one shared mesh executor
# ---------------------------------------------------------------------------

def _mk_gateway(S, params, bank, executor, *, seed, n_tenants=4,
                admission=None, max_batch=16, kw=None):
    tenants = [S.TenantSpec(name=f"g{seed}t{i}") for i in range(n_tenants)]
    return S.MultiTenantGateway(params, bank, tenants=tenants,
                                default_op=S.OperatingPoint(c=C, bits=8),
                                max_batch=max_batch, batch_window_s=None,
                                executor=executor, shared_executor=True,
                                seed=seed, admission=admission, **(kw or {}))


def _workload(S, gw, imgs, per_tenant, *, dt=1e-4):
    reqs = []
    names = sorted(gw.specs)
    for r in range(per_tenant):
        for i, name in enumerate(names):
            k = r * len(names) + i
            reqs.append(S.TenantRequest(tenant=name,
                                        img=imgs[k % len(imgs)][None],
                                        t_submit=k * dt))
    return reqs


def _frozen_cal(S):
    return S.CalibratedCostModel(seed_base_s=2e-3,
                                 seed_per_item_s=1e-4).freeze()


def _logit_rows(outcomes):
    return {t: [np.asarray(r.logits) for r in rs]
            for t, rs in outcomes.items()}


def _records(tel):
    return [dataclasses.asdict(r) for r in tel.records]


def _federate(S, s, executor, pin):
    params, bank, kw = (s["model"], s["tbank"], {"device": "cpu"}) \
        if S is tserve else (s["jparams"], s["jbank"], {})
    gws = [_mk_gateway(S, params, bank, executor, seed=g, kw=kw)
           for g in range(2)]
    if pin:
        for gw in gws:
            _pin(gw, s)
    wls = [_workload(S, gw, s["imgs"], 4) for gw in gws]
    fed = S.GatewayFederation(gws)
    return fed, wls


def test_federated_mesh_replays_and_matches_serial_and_jax(system):
    """Two federated gateways (4 tenants each, one full 16-bucket per
    gateway) on one shared MeshExecutor under a frozen calibrated model:
    a replay is identical (records and logits), the logits equal the
    serial federation's bit for bit, and the records equal the JAX
    federation's on a SerialExecutor with the same bridged weights."""
    s = system
    mesh_ex = tserve.MeshExecutor(_cpu_mesh(), cost=_frozen_cal(tserve))
    fed_m, wls = _federate(tserve, s, mesh_ex, pin=True)
    got_m = fed_m.serve(wls)
    got_m2 = fed_m.serve(wls)
    fed_s, wls_s = _federate(
        tserve, s, tserve.SerialExecutor(cost=_frozen_cal(tserve)), pin=True)
    got_s = fed_s.serve(wls_s)
    fed_j, wls_j = _federate(
        jserve, s, jserve.SerialExecutor(cost=_frozen_cal(jserve)), pin=False)
    got_j = fed_j.serve(wls_j)
    for (out_m, tel_m), (out_2, tel_2), (out_s, tel_s), (_, tel_j) in zip(
            got_m, got_m2, got_s, got_j):
        assert not tel_m.shed and len(tel_m.records) == 16
        assert tel_m.records == tel_2.records
        assert _records(tel_m) == _records(tel_j)
        assert tel_m.records == tel_s.records
        rows_m, rows_2, rows_s = (_logit_rows(o) for o in (out_m, out_2,
                                                           out_s))
        assert rows_m.keys() == rows_s.keys()
        for t in rows_m:
            assert len(rows_m[t]) == 4
            for a, b, c in zip(rows_m[t], rows_2[t], rows_s[t]):
                assert np.array_equal(a, b) and np.array_equal(a, c)
    for tk in mesh_ex.history:
        assert (tk.t_done - tk.t_start) == pytest.approx(
            _frozen_cal(tserve).predict(16))
    assert fed_m.depth() == 0


def test_federation_guards_hold_on_mesh_executors(system):
    """Disjoint executors, a duplicate gateway, the shared-executor flag
    and an executor bound twice are refused as the reference refuses
    them, with mesh executors."""
    s = system

    def errors(S, params, bank, mesh, kw):
        def mk():
            return S.MeshExecutor(mesh, cost=S.LinearCostModel())
        gw1 = _mk_gateway(S, params, bank, mk(), seed=0, kw=kw)
        gw2 = _mk_gateway(S, params, bank, mk(), seed=1, kw=kw)
        ex = mk()
        shared = _mk_gateway(S, params, bank, ex, seed=2, kw=kw)
        solo = S.MultiTenantGateway(params, bank,
                                    tenants=[S.TenantSpec(name="solo")],
                                    default_op=S.OperatingPoint(c=C, bits=8),
                                    executor=ex, **kw)
        bound = mk()
        S.MultiTenantGateway(params, bank, tenants=[S.TenantSpec(name="a")],
                             default_op=S.OperatingPoint(c=C, bits=8),
                             executor=bound, **kw)
        return [
            raised(lambda: S.serve_federated([(gw1, []), (gw2, [])])),
            raised(lambda: S.serve_federated([(gw1, []), (gw1, [])])),
            raised(lambda: S.GatewayFederation([shared, solo])),
            raised(lambda: S.MultiTenantGateway(
                params, bank, tenants=[S.TenantSpec(name="b")],
                default_op=S.OperatingPoint(c=C, bits=8), executor=bound,
                **kw)),
        ]
    got = errors(tserve, s["model"], s["tbank"], _cpu_mesh(),
                 {"device": "cpu"})
    assert got == errors(jserve, s["jparams"], s["jbank"], _auto_mesh(1), {})
    assert [g[0] for g in got] == ["ValueError"] * 4
    assert "share one executor" in got[0][1]
    assert "once per federation" in got[1][1]
    assert "shared_executor=True" in got[2][1]
    assert "already bound" in got[3][1]


def test_shared_mesh_depth_sheds_across_gateways(system):
    """One gateway's burst fills the shared mesh executor; the other
    gateway's queue-depth admission reads that backlog and sheds."""
    s = system
    ex = tserve.MeshExecutor(_cpu_mesh(), cost=tserve.LinearCostModel(
        base_s=0.5, per_item_s=0.01))
    kw = {"device": "cpu"}
    gw_burst = _mk_gateway(tserve, s["model"], s["tbank"], ex, seed=0,
                           n_tenants=1, max_batch=1, kw=kw)
    gw_meek = _mk_gateway(tserve, s["model"], s["tbank"], ex, seed=1,
                          n_tenants=1, max_batch=1, kw=kw,
                          admission=tserve.QueueDepthAdmission(1))
    imgs = s["imgs"]
    wl_burst = [tserve.TenantRequest(tenant="g0t0", img=imgs[i][None],
                                     t_submit=0.001 * i) for i in range(4)]
    wl_meek = [tserve.TenantRequest(tenant="g1t0", img=imgs[i][None],
                                    t_submit=0.25 + 0.001 * i)
               for i in range(2)]
    (out_b, tel_b), (out_m, tel_m) = tserve.GatewayFederation(
        [gw_burst, gw_meek]).serve([wl_burst, wl_meek])
    assert not tel_b.shed
    assert len(tel_m.shed) == 2
    assert all(isinstance(r, tserve.RequestShed) for r in out_m["g1t0"])
    assert all("queue-depth" in r.reason for r in out_m["g1t0"])
    assert len(out_b["g0t0"]) == 4
    assert all(not r.shed for r in out_b["g0t0"])
