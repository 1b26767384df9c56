"""The port's streaming sessions against the JAX package's, at smoke scale.

The host modules (frame format, recovery, negotiation) are compared field by
field, with the same exceptions and messages. The session codec gets the
same split activations z in both packages: SSF1 frames must be
byte-identical and every decoded code tensor (I-frames and P-chains, 4 and
12 bits, the latter through the uint16 delta) bit-identical. The session
manager runs on both packages' gateways at 32x32 with the port's edge pinned
to the JAX edge's z and ``LinearCostModel``: frame logs, stream signatures,
telemetry records and trace JSON identical, logits at 1e-4.
"""
import dataclasses
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.serve as jserve
import repro.session as jsess
import repro.session.codec as jcodec
import repro_torch.obs as tobs
import repro_torch.serve as tserve
import repro_torch.session as tsess
import repro_torch.session.codec as tcodec
from repro import pipeline as jpipe
from repro.codec.rans import CorruptStream as JCorrupt
from repro.configs.yolo_baf import smoke_config as jax_smoke_config
from repro.core.baf import BaFConvConfig as JBaFConfig
from repro.core.baf import init_baf_conv
from repro.data.synthetic import correlated_frames
from repro.models.cnn import cnn_edge, init_cnn
from repro_torch import pipeline as tpipe
from repro_torch.bridge import baf_from_jax, cnn_from_jax
from repro_torch.codec.rans import CorruptStream as TCorrupt
from repro_torch.configs.yolo_baf import smoke_config
from repro_torch.core.baf import BaFConvConfig

TOL = dict(atol=1e-4, rtol=1e-4)
J = (jpipe, jsess, jserve, jobs)
T = (tpipe, tsess, tserve, tobs)


def plain(x):
    """Package-free view: dataclasses as (class name, fields), numpy arrays
    as (dtype, shape, bytes); floats compared exactly."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
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


def _plan_for(P):
    """A cached, model-free plan per operating point (encode/decode only,
    the first C channels), on the CPU for the port."""
    kw = {"device": "cpu"} if P is tpipe else {}
    cache = {}

    def get(op):
        op = op.resolve()
        if op not in cache:
            cache[op] = P.compile(op, P.ModelSpec(sel_idx=np.arange(op.c)),
                                  **kw)
        return cache[op]
    return get


def _z_stream(n, *, shape=(1, 8, 8, 8), drift=0.01, seed=0):
    """Temporally correlated split activations (frame t ~ frame t-1)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=shape).astype(np.float32)
    out = [z]
    for _ in range(n - 1):
        z = z + drift * rng.normal(size=shape).astype(np.float32)
        out.append(z)
    return out


def _op(P, bits, c=8):
    return P.OperatingPoint(c=c, bits=bits, backend="rans")


# ---------------------------------------------------------------------------
# Frame format, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("payload", [b"", b"\x00\x01BaF2 payload" * 9])
def test_session_frame_packs_and_parses_as_jax(intra, payload):
    kw = dict(session_id=7, seq=41, ref_seq=41 if intra else 40,
              intra=intra, level=3, payload=payload)
    jblob = jcodec.SessionFrame(**kw).pack()
    tblob = tcodec.SessionFrame(**kw).pack()
    assert tblob == jblob
    assert plain(tcodec.SessionFrame.parse(tblob)) == \
        plain(jcodec.SessionFrame.parse(jblob))
    assert (tcodec.HEADER_BYTES, tcodec.FRAME_OVERHEAD_BYTES,
            tcodec.SESSION_MAGIC, tpipe.SESSION_WIRE_VERSION) == \
        (jcodec.HEADER_BYTES, jcodec.FRAME_OVERHEAD_BYTES,
         jcodec.SESSION_MAGIC, jpipe.SESSION_WIRE_VERSION)


def _rewrite(blob, offset, value):
    """Overwrite one header byte and re-seal the header CRC."""
    bad = bytearray(blob)
    bad[offset] = value
    bad[24:28] = struct.pack("<I", zlib.crc32(bytes(bad[:24])))
    return bytes(bad)


MUTATIONS = {
    "empty": lambda b: b[:0],
    "truncated_header": lambda b: b[:20],
    "bad_magic": lambda b: bytes([b[0] ^ 0xFF]) + b[1:],
    "bad_version": lambda b: b[:4] + b"\x7f" + b[5:],
    "header_crc": lambda b: b[:9] + bytes([b[9] ^ 0x01]) + b[10:],
    "truncated_payload": lambda b: b[:len(b) // 2],
    "trailing_garbage": lambda b: b + b"\x00",
    "payload_crc": lambda b: b[:30] + bytes([b[30] ^ 0x10]) + b[31:],
    "unknown_type": lambda b: _rewrite(b, 5, 7),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_every_corruption_error_matches_jax(name):
    """Each damage raises CorruptStream with the JAX package's message,
    from ``SessionFrame.parse`` and from a decoder."""
    z = _z_stream(1)[0]
    out = []
    for P, S, C in ((jpipe, jsess, JCorrupt), (tpipe, tsess, TCorrupt)):
        plan_for = _plan_for(P)
        cfg = S.SessionConfig(session_id=1, levels=(_op(P, 6),))
        blob = S.SessionEncoder(cfg, plan_for).encode(z)[0]
        bad = MUTATIONS[name](blob)
        with pytest.raises(C):
            S.SessionFrame.parse(bad)
        out.append((raised(lambda: S.SessionFrame.parse(bad)),
                    raised(lambda: S.SessionDecoder(cfg, plan_for)
                           .decode(bad))))
    assert out[1] == out[0]


def test_every_truncation_is_detected():
    plan_for = _plan_for(tpipe)
    cfg = tsess.SessionConfig(session_id=5, levels=(_op(tpipe, 6),))
    blob = tsess.SessionEncoder(cfg, plan_for).encode(_z_stream(1)[0])[0]
    for cut in range(len(blob)):
        with pytest.raises(TCorrupt):
            tsess.SessionDecoder(cfg, plan_for).decode(blob[:cut])


def test_foreign_session_and_ladder_overflow_refused_as_jax():
    z = _z_stream(1)[0]
    out = []
    for P, S in ((jpipe, jsess), (tpipe, tsess)):
        plan_for = _plan_for(P)
        cfg = S.SessionConfig(session_id=1, levels=(_op(P, 6),))
        blob = S.SessionEncoder(cfg, plan_for).encode(z)[0]
        other = S.SessionDecoder(S.SessionConfig(session_id=99,
                                                 levels=(_op(P, 6),)),
                                 plan_for)
        out.append((raised(lambda: other.decode(blob)),
                    raised(lambda: S.SessionDecoder(cfg, plan_for)
                           .decode(_rewrite(blob, 6, 200)))))
    assert out[1] == out[0]
    assert out[1][0][0] == "CorruptStream"


@pytest.mark.parametrize("kw", [dict(levels=()), dict(levels="many"),
                                dict(keyframe_interval=-1)])
def test_session_config_refuses_alike(kw):
    def make(P, S):
        levels = kw.get("levels", (_op(P, 6),))
        if levels == "many":
            levels = (_op(P, 6),) * 257
        return S.SessionConfig(session_id=0, levels=levels,
                               keyframe_interval=kw.get("keyframe_interval",
                                                        0))
    assert raised(lambda: make(tpipe, tsess)) == \
        raised(lambda: make(jpipe, jsess))


# ---------------------------------------------------------------------------
# Recovery and negotiation
# ---------------------------------------------------------------------------

EVENTS = [("desync", 1.0), ("desync", 1.1), ("resync", 1.5), ("resync", 2.0),
          ("desync", 2.25), ("resync", 2.3125), ("desync", 3.0),
          ("desync", 3.5), ("resync", 4.75)]


def test_recovery_tracker_matches_jax():
    trackers = []
    for S in (jsess, tsess):
        tr = S.RecoveryTracker()
        opened = [tr.on_desync(t) if kind == "desync" else tr.on_resync(t)
                  for kind, t in EVENTS]
        trackers.append((opened, plain(tr), tr.max_recovery_s,
                         tr.mean_recovery_s))
    assert trackers[1] == trackers[0]
    assert trackers[1][1][1]["episodes"] == 3


@pytest.mark.parametrize("fps", [10.0, 20.0, 30.0])
@pytest.mark.parametrize("margin", [0, 2])
def test_recovery_bound_matches_jax(fps, margin):
    kw = dict(fps=fps, uplink_latency_s=0.0125, nack_latency_s=0.02,
              margin_frames=margin)
    assert tsess.recovery_bound_s(**kw) == jsess.recovery_bound_s(**kw)


@pytest.mark.parametrize("kw", [dict(), dict(nack=False, keyframe_interval=8),
                                dict(nack=False, keyframe_interval=0),
                                dict(nack_latency_s=-1.0),
                                dict(keyframe_interval=-2)])
def test_recovery_config_matches_jax(kw):
    def make(S):
        return plain(S.RecoveryConfig(**kw))
    assert raised(lambda: make(tsess)) == raised(lambda: make(jsess))
    if raised(lambda: make(jsess)) is None:
        assert make(tsess) == make(jsess)
    assert raised(lambda: tsess.recovery_bound_s(
        fps=0, uplink_latency_s=0, nack_latency_s=0)) == \
        raised(lambda: jsess.recovery_bound_s(fps=0, uplink_latency_s=0,
                                              nack_latency_s=0))


@pytest.mark.parametrize("caps", [None, dict(), dict(session_profiles=()),
                                  dict(session_profiles=(), downgrade=False),
                                  dict(session_profiles=(1, 2))])
@pytest.mark.parametrize("profile", [1, 2])
def test_negotiate_session_matches_jax(caps, profile):
    def run(P):
        c = None if caps is None else P.Capabilities(**caps)
        return P.negotiate_session(c, profile=profile)
    assert raised(lambda: run(tpipe)) == raised(lambda: run(jpipe))
    if raised(lambda: run(jpipe)) is None:
        assert run(tpipe) == run(jpipe)


# ---------------------------------------------------------------------------
# The codec with the same z in both packages
# ---------------------------------------------------------------------------

def _drive(P, S, zs, bits, *, keyframe_interval=0, nack_at=(), lose=(),
           level_at=None):
    """Encode a clip through one package's session codec, decode what is not
    lost; return frames, metas, decode outcomes and the plan's codes."""
    plan_for = _plan_for(P)
    levels = (_op(P, bits), _op(P, 4, c=4))
    cfg = S.SessionConfig(session_id=3, levels=levels,
                          keyframe_interval=keyframe_interval)
    enc, dec = S.SessionEncoder(cfg, plan_for), S.SessionDecoder(cfg,
                                                                 plan_for)
    frames, metas, decoded = [], [], []
    for i, z in enumerate(zs):
        if i in nack_at:
            enc.nack()
        level = 1 if level_at is not None and i >= level_at else 0
        blob, meta = enc.encode(z, level=level)
        frames.append(blob)
        metas.append(plain(meta))
        if i in lose:
            continue
        try:
            d, f = dec.decode(blob)
        except S.SessionDesync as e:
            decoded.append(("desync", str(e)))
            continue
        want = plan_for(levels[level]).quantize(z)[0]
        assert np.array_equal(d.codes, np.asarray(want)), i
        decoded.append((plain(f), plain(d)))
    return frames, metas, decoded


@pytest.mark.parametrize("bits", [4, 12])
@pytest.mark.parametrize("scenario", ["p_chain", "keyframes", "recovery",
                                      "ladder"])
def test_session_clip_matches_jax(bits, scenario):
    """20 frames: SSF1 frames byte-identical, frame metadata identical, and
    every decoded code tensor bit-identical to the other package's and to
    the plan's own quantizer (4-bit codes are uint8, 12-bit uint16)."""
    kw = {"p_chain": {}, "keyframes": dict(keyframe_interval=6),
          "recovery": dict(lose=(5, 11), nack_at=(7, 14)),
          "ladder": dict(level_at=9)}[scenario]
    zs = _z_stream(20, seed=bits)
    jf, jm, jd = _drive(jpipe, jsess, zs, bits, **kw)
    tf, tm, td = _drive(tpipe, tsess, zs, bits, **kw)
    assert tf == jf
    assert tm == jm
    assert td == jd
    assert sum(not m[1]["intra"] for m in tm) >= 10


def test_p_frames_code_below_i_frames():
    enc = tsess.SessionEncoder(tsess.SessionConfig(
        session_id=1, levels=(_op(tpipe, 6),)), _plan_for(tpipe))
    i_bits, p_bits = [], []
    for z in _z_stream(16):
        _, meta = enc.encode(z)
        (i_bits if meta.intra else p_bits).append(meta.wire_bits)
    assert len(i_bits) == 1 and len(p_bits) == 15
    assert np.mean(p_bits) <= 0.7 * np.mean(i_bits)


@pytest.mark.parametrize("bits", [3, 8, 9, 16])
def test_delta_mod_is_numpy_wraparound(bits):
    rng = np.random.default_rng(bits)
    dt = np.uint8 if bits <= 8 else np.uint16
    a = rng.integers(0, 1 << bits, (4, 33), dtype=dt)
    b = rng.integers(0, 1 << bits, (4, 33), dtype=dt)
    got = tcodec._delta_mod(torch.from_numpy(a), torch.from_numpy(b), bits)
    assert got.dtype == torch.from_numpy(a).dtype
    mask = np.array((1 << bits) - 1, dtype=dt)
    assert np.array_equal(got.numpy(), (a - b) & mask)


def test_i_only_without_the_session_profile_as_jax():
    zs = _z_stream(4)
    out = []
    for P, S in ((jpipe, jsess), (tpipe, tsess)):
        cfg = S.SessionConfig(session_id=3, levels=(_op(P, 6),))
        enc = S.SessionEncoder(cfg, _plan_for(P), capabilities=P.Capabilities(
            session_profiles=(), downgrade=True))
        out.append((enc.temporal, [enc.encode(z)[0] for z in zs],
                    raised(lambda: S.SessionEncoder(
                        cfg, _plan_for(P), capabilities=P.Capabilities(
                            session_profiles=(), downgrade=False)))))
    assert out[1] == out[0]
    assert out[1][0] is False


def test_encoder_refuses_a_level_outside_the_ladder_as_jax():
    z = _z_stream(1)[0]
    assert raised(lambda: tsess.SessionEncoder(tsess.SessionConfig(
        session_id=0, levels=(_op(tpipe, 6),)), _plan_for(tpipe)).encode(
            z, level=1)) == \
        raised(lambda: jsess.SessionEncoder(jsess.SessionConfig(
            session_id=0, levels=(_op(jpipe, 6),)), _plan_for(jpipe)).encode(
                z, level=1))


# ---------------------------------------------------------------------------
# The session manager on both packages' gateways
# ---------------------------------------------------------------------------

_jax_edge = jax.jit(lambda p, i: cnn_edge(p, i)[1])


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
    jparams = jax.tree.map(jnp.asarray, params)
    zs = {}

    def jax_z(img: np.ndarray) -> np.ndarray:
        key = img.tobytes()
        if key not in zs:
            zs[key] = np.asarray(_jax_edge(jparams, jnp.asarray(img)))
        return zs[key]
    return dict(jparams=jparams, model=model, jbank=jbank, tbank=tbank,
                jax_z=jax_z)


def _pin(gw, s):
    """Feed the port's gateway the JAX edge's z for each image."""
    gw._edge_fn = lambda img: torch.from_numpy(
        np.array(s["jax_z"](img.numpy())))
    return gw


def _ladder(P, S):
    return (S.QosLevel(_op(P, 6)),
            S.QosLevel(_op(P, 4), keyframe_interval=8),
            S.QosLevel(_op(P, 4, c=4), keyframe_interval=8, frame_stride=2))


class _RefuseAll:
    def reset(self):
        pass

    def admit(self, *, tenant, priority, t, executor):
        return self.decision(False, reason="saturated")


def _manager(pkgs, s, *, loss=0.0, corrupt=0.0, admission=None, **kw):
    P, S, G, O = pkgs
    port = S is tsess
    params = s["model"] if port else s["jparams"]
    bank = s["tbank"] if port else s["jbank"]
    if admission is not None:
        admission = admission()
        admission.decision = G.AdmissionDecision
    gw = G.MultiTenantGateway(
        params, bank,
        tenants=[G.TenantSpec(name=f"cam{i}", priority=i % 2)
                 for i in range(3)],
        executor=G.MultiQueueExecutor(2, cost=G.LinearCostModel(0.002,
                                                                0.0005)),
        admission=admission, max_batch=4, batch_window_s=0.01,
        tracer=O.Tracer(), metrics=O.MetricsRegistry(),
        **({"device": "cpu"} if port else {}))
    if port:
        _pin(gw, s)
    sessions = [S.SessionSpec(name=f"cam{i}", fps=20.0, start_s=0.002 * i)
                for i in range(3)]
    cfg = G.ChannelConfig(bandwidth_bps=20e6, base_latency_s=0.005,
                          loss_p=loss, corrupt_p=corrupt, mtu_bytes=256)
    return S.SessionManager(gw, sessions, ladder=_ladder(P, S),
                            channel_cfg=cfg,
                            recovery=S.RecoveryConfig(nack_latency_s=0.01),
                            seed=3, **kw)


def _frames(n):
    return {f"cam{i}": correlated_frames(n, image_size=32, seed=10 + i)
            for i in range(3)}


def _same_runs(jmgr, tmgr, frames):
    jresp, jrep = jmgr.run(frames)
    tresp, trep = tmgr.run(frames)
    assert trep.signature() == jrep.signature()
    assert plain(trep.frames) == plain(jrep.frames)
    assert plain(trep.telemetry.records) == plain(jrep.telemetry.records)
    assert plain(trep.telemetry.shed) == plain(jrep.telemetry.shed)
    assert plain(trep.telemetry.degraded) == plain(jrep.telemetry.degraded)
    assert trep.telemetry.format_summary() == jrep.telemetry.format_summary()
    assert trep.nacks == jrep.nacks and \
        trep.settle_frames == jrep.settle_frames
    assert tmgr.gateway.tracer.to_json() == jmgr.gateway.tracer.to_json()
    assert tmgr.gateway.metrics.to_prometheus_text() == \
        jmgr.gateway.metrics.to_prometheus_text()
    assert {n: sorted(r) for n, r in tresp.items()} == \
        {n: sorted(r) for n, r in jresp.items()}
    for name in jresp:
        for seq, logits in jresp[name].items():
            np.testing.assert_allclose(tresp[name][seq], np.asarray(logits),
                                       **TOL)
    return trep


def test_clean_stream_matches_jax(system):
    rep = _same_runs(_manager(J, system), _manager(T, system), _frames(12))
    for name in rep.frames:
        assert rep.counts(name) == {"served": 12}
        assert sum(f.intra for f in rep.frames[name]) == 1


def test_lossy_stream_matches_jax_recovers_and_replays(system):
    """5% loss and 2% corruption: the same frame logs, NACKs, recovery
    episodes and telemetry in both packages; every session ends in sync
    within twice the single-cycle bound, and a replay is identical."""
    tmgr = _manager(T, system, loss=0.05, corrupt=0.02)
    frames = _frames(16)
    rep = _same_runs(_manager(J, system, loss=0.05, corrupt=0.02), tmgr,
                     frames)
    assert sum(n for name in frames for o, n in rep.counts(name).items()
               if o in ("lost", "corrupt", "desync")) > 0
    assert sum(rep.nacks.values()) > 0
    bound = tsess.recovery_bound_s(fps=20.0, uplink_latency_s=0.02,
                                   nack_latency_s=0.01, margin_frames=2)
    for name in frames:
        assert not rep.recovery[name].in_desync
        assert rep.recovery[name].max_recovery_s <= 2 * bound
    assert tmgr.run(frames)[1].signature() == rep.signature()


def test_overload_degrades_before_shedding_as_jax(system):
    rep = _same_runs(_manager(J, system, admission=_RefuseAll),
                     _manager(T, system, admission=_RefuseAll), _frames(10))
    assert len(rep.telemetry.degraded) == 6
    for name in rep.frames:
        assert rep.final_levels[name] == 2
        assert rep.counts(name).get("shed", 0) > 0


def _priced_table(G, P):
    lad = _ladder(P, tsess if P is tpipe else jsess)
    return [G.RDPoint(lad[0].op, 10_000.0, 30.0, p_over_i=0.5),
            G.RDPoint(lad[1].op, 8_000.0, 26.0, p_over_i=0.25),
            G.RDPoint(lad[2].op, 6_000.0, 22.0, p_over_i=0.25)]


@pytest.mark.parametrize("budget,level", [(3_000.0, 1), (1e9, 0), (10.0, 2)])
def test_priced_initial_level_matches_jax(system, budget, level):
    mgrs = [_manager(pk, system, rd_table=_priced_table(pk[2], pk[0]),
                     frame_budget_bits=budget) for pk in (J, T)]
    assert mgrs[1]._initial_level == mgrs[0]._initial_level == level
    if level == 1:
        rep = _same_runs(*mgrs, _frames(6))
        assert all(rep.frames[n][0].level == 1 for n in rep.frames)


def test_manager_refuses_alike(system):
    def cases(pkgs):
        P, S, G, _ = pkgs
        mgr = _manager(pkgs, system)
        gw, lad = mgr.gateway, _ladder(P, S)
        metered = G.ChannelConfig(budget_bits_per_tick=1000)
        return [raised(fn) for fn in (
            lambda: S.SessionManager(gw, [S.SessionSpec("cam0")], ladder=()),
            lambda: S.SessionManager(gw, [], ladder=lad),
            lambda: S.SessionManager(gw, [S.SessionSpec("cam0")] * 2,
                                     ladder=lad),
            lambda: S.SessionManager(gw, [S.SessionSpec("nope")],
                                     ladder=lad),
            lambda: S.SessionManager(gw, [S.SessionSpec("cam0")],
                                     ladder=lad, channel_cfg=metered),
            lambda: S.SessionSpec("x", fps=0),
            lambda: S.QosLevel(_op(P, 6), frame_stride=0),
            lambda: mgr.run({"nope": np.zeros((1, 32, 32, 3))}))]
    got, want = cases(T), cases(J)
    assert got == want
    assert all(g is not None for g in got)

