"""The port's CNN, BaF restore and compression plan against the JAX package.

Weights are drawn once by the JAX initialisers (with BN statistics and
PReLU slopes randomised from numpy so that no layer is an identity) and
bridged into the port. Tolerances: z, restore and logits at 1e-4 (float32
convolutions summed in different orders); codes, wire bytes and decoded
batches exact, given the same numpy z.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipe
from repro.configs.yolo_baf import smoke_config as jax_smoke_config
from repro.core.baf import BaFConvConfig as JBaFConfig
from repro.core.baf import init_baf_conv
from repro.core.split import SplitInferenceEngine as JEngine
from repro.core.split import restore_codes as jax_restore
from repro.core.split import restore_codes_fused as jax_restore_fused
from repro.models.cnn import cnn_cloud, cnn_edge, init_cnn
from repro_torch import pipeline as tpipe
from repro_torch.bridge import baf_from_jax, cnn_from_jax
from repro_torch.configs.yolo_baf import smoke_config
from repro_torch.core.baf import BaFConvConfig
from repro_torch.core.split import SplitInferenceEngine, restore_codes, \
    restore_codes_fused

TOL = dict(atol=1e-4, rtol=1e-4)
C, BITS = 8, 6


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
    out = walk(tree)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(0)
    jcfg = jax_smoke_config()._replace(input_size=32)
    params = _randomize(init_cnn(jax.random.PRNGKey(0), jcfg), rng)
    baf = _randomize(init_baf_conv(jax.random.PRNGKey(1), JBaFConfig(
        c=C, q=jcfg.split_q, hidden=8)), rng)
    tcfg = smoke_config()._replace(input_size=32)
    model = cnn_from_jax(params, tcfg, device="cpu")
    tbaf = baf_from_jax(baf, BaFConvConfig(c=C, q=tcfg.split_q, hidden=8),
                        device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    jbaf = jax.tree.map(jnp.asarray, baf)
    sel = rng.permutation(tcfg.split_p)[:C]
    img = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    return dict(params=jparams, baf=jbaf, model=model, tbaf=tbaf, sel=sel,
                img=img)


def test_edge_and_cloud_match(system):
    s = system
    jx, jz = cnn_edge(s["params"], jnp.asarray(s["img"]))
    tx, tz = s["model"].edge(torch.from_numpy(s["img"]))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    assert tz.shape == (2, 4, 4, 64)
    np.testing.assert_allclose(
        s["model"].cloud(torch.from_numpy(np.array(jz))).numpy(),
        np.asarray(cnn_cloud(s["params"], jz)), **TOL)


def test_restore_fused_and_plain_match_jax(system):
    s = system
    _, jz = cnn_edge(s["params"], jnp.asarray(s["img"]))
    jplan = jpipe.compile(jpipe.OperatingPoint(c=C, bits=BITS, backend="raw"),
                          jpipe.ModelSpec(sel_idx=s["sel"]))
    codes, mins, maxs = (np.array(a) for a in jplan.quantize(jz))
    sel_j = jnp.asarray(s["sel"], jnp.int32)
    sel_t = torch.as_tensor(s["sel"].astype(np.int32))
    args_j = (s["baf"], s["params"]["split"], sel_j, jnp.asarray(codes),
              jnp.asarray(mins), jnp.asarray(maxs))
    args_t = (s["tbaf"], s["model"].split, sel_t, torch.from_numpy(codes),
              torch.from_numpy(mins), torch.from_numpy(maxs))
    want = np.asarray(jax_restore_fused(*args_j, bits=BITS))
    got_fused = restore_codes_fused(*args_t, bits=BITS).numpy()
    got_plain = restore_codes(*args_t, bits=BITS).numpy()
    np.testing.assert_allclose(got_fused, want, **TOL)
    np.testing.assert_allclose(got_plain, got_fused, **TOL)
    np.testing.assert_allclose(
        restore_codes(*args_t, bits=BITS, consolidation=False).numpy(),
        np.asarray(jax_restore(*args_j, bits=BITS, consolidation=False)),
        **TOL)


@pytest.mark.parametrize("backend", ["rans", "rans-ctx", "zlib"])
@pytest.mark.parametrize("fused", [True, False])
def test_slice_end_to_end_matches_jax(system, backend, fused):
    """Same numpy z: same wire bytes, same decoded batch, close restore and
    logits."""
    s = system
    _, jz = cnn_edge(s["params"], jnp.asarray(s["img"]))
    z = np.asarray(jz)
    op_j = jpipe.OperatingPoint(c=C, bits=BITS, backend=backend)
    op_t = tpipe.OperatingPoint(c=C, bits=BITS, backend=backend)
    jplan = jpipe.compile(op_j, jpipe.ModelSpec(
        sel_idx=s["sel"], params=s["params"], baf_params=s["baf"]),
        fused=fused)
    tplan = tpipe.compile(op_t, tpipe.ModelSpec(
        sel_idx=s["sel"], params=s["model"], baf_params=s["tbaf"]),
        fused=fused, device="cpu")
    jblobs = [jplan.encode(z[i:i + 1]) for i in range(2)]
    tblobs = [tplan.encode(z[i:i + 1]) for i in range(2)]
    for jb, tb in zip(jblobs, tblobs):
        assert tb.data == jb.data
        assert dataclasses.asdict(tb.stats) == dataclasses.asdict(jb.stats)
    jdec = jplan.decode_batch(jblobs)
    tdec = tplan.decode_batch(tblobs)
    for name in ("codes", "mins", "maxs"):
        np.testing.assert_array_equal(getattr(tdec, name), getattr(jdec, name))
    jrest = jplan.restore(jdec)
    trest = tplan.restore(tdec)
    np.testing.assert_allclose(trest.numpy(), np.asarray(jrest), **TOL)
    np.testing.assert_allclose(
        s["model"].cloud(trest).numpy(),
        np.asarray(cnn_cloud(s["params"], jrest)), **TOL)


@pytest.mark.parametrize("backend,bits", [
    ("rans", 10), ("rans", 12), ("rans-ctx", 10), ("rans-ctx", 12),
    ("zlib", 16), ("raw", 16)])
def test_wide_codes_end_to_end_match_jax(system, backend, bits):
    """9..16-bit codes (uint16): the same wire bytes and decoded batch as
    the JAX plan, and a close restore (the rANS backends go to 12 bits)."""
    s = system
    z = np.asarray(cnn_edge(s["params"], jnp.asarray(s["img"]))[1])
    jplan = jpipe.compile(jpipe.OperatingPoint(c=C, bits=bits,
                                               backend=backend),
                          jpipe.ModelSpec(sel_idx=s["sel"], params=s["params"],
                                          baf_params=s["baf"]))
    tplan = tpipe.compile(tpipe.OperatingPoint(c=C, bits=bits,
                                               backend=backend),
                          tpipe.ModelSpec(sel_idx=s["sel"], params=s["model"],
                                          baf_params=s["tbaf"]), device="cpu")
    jblobs = [jplan.encode(z[i:i + 1]) for i in range(2)]
    tblobs = [tplan.encode(z[i:i + 1]) for i in range(2)]
    for jb, tb in zip(jblobs, tblobs):
        assert tb.data == jb.data
    jdec, tdec = jplan.decode_batch(jblobs), tplan.decode_batch(tblobs)
    assert tdec.codes.dtype == np.uint16
    for name in ("codes", "mins", "maxs"):
        np.testing.assert_array_equal(getattr(tdec, name), getattr(jdec, name))
    np.testing.assert_allclose(tplan.restore(tdec).numpy(),
                               np.asarray(jplan.restore(jdec)), **TOL)


def test_engine_matches_jax_engine(system):
    s = system
    jeng = JEngine(s["params"], s["baf"], s["sel"], bits=BITS, backend="rans")
    teng = SplitInferenceEngine(s["model"], s["tbaf"], s["sel"], bits=BITS,
                                backend="rans", device="cpu")
    jlogits, jstats = jeng(jnp.asarray(s["img"]))
    tlogits, tstats = teng(s["img"])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert tstats.wire_bits > 0 and tstats.raw_bits == jstats.raw_bits


def test_plan_validates_its_inputs(system):
    s = system
    spec = tpipe.ModelSpec(sel_idx=s["sel"], params=s["model"],
                           baf_params=s["tbaf"])
    with pytest.raises(ValueError, match="1..16"):
        tpipe.OperatingPoint(c=C, bits=17, backend="raw")
    z = np.zeros((1, 4, 4, s["model"].cfg.split_p), np.float32)
    with pytest.raises(ValueError, match="1..12 bits"):      # as in JAX
        tpipe.compile(tpipe.OperatingPoint(c=C, bits=16, backend="rans"),
                      spec, device="cpu").encode(z)
    dup = tpipe.ModelSpec(sel_idx=np.zeros(C, np.int64))
    with pytest.raises(ValueError, match="distinct"):
        tpipe.compile(tpipe.OperatingPoint(c=C, bits=BITS), dup, device="cpu")
    wide = tpipe.ModelSpec(sel_idx=np.arange(C) + 60, params=s["model"])
    with pytest.raises(ValueError, match="reaches channel"):
        tpipe.compile(tpipe.OperatingPoint(c=C, bits=BITS), wide,
                      device="cpu")
