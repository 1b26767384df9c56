"""The port's pod pipeline (``repro_torch.distributed.pipeline``) and the
stream BaF predictor (``core/baf.py``) against the reference's.

* ``_quantize_stream`` (the quantize kernel's function at B = 1; its plain
  version on the CPU): codes and fp16 side info bit-identical to the JAX
  function on float32 and bf16 streams, with values past +-65504, signed
  zeros and constant channels, whole and through a channel subset.
* ``compressed_pod_transfer`` and ``subset_pod_transfer`` at 2 gloo ranks:
  against the reference's functions on a (pod 2, data 2, model 2) mesh of
  fake CPU devices with Auto axes (the same x on both pods, in a
  subprocess), and against the reference's pieces composed under
  ``jax.vmap(..., axis_name="pod")`` with a different x on each pod; the
  bytes handed to ``ppermute`` equal ``wire_bytes()``.
* ``BaFStream`` against ``baf_stream_backward``/``baf_stream_predict`` on
  weights bridged from ``init_baf_stream``.
* The launcher ``repro_torch.launch.pod_boundary --device cpu --world 2``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.baf import BaFStreamConfig as JBaFStreamConfig
from repro.core.baf import baf_stream_backward as jax_backward
from repro.core.baf import baf_stream_predict as jax_predict
from repro.core.baf import init_baf_stream
from repro.core.quant import QuantParams as JQuantParams
from repro.distributed import pipeline as jpipe
from repro_torch.bridge import baf_stream_from_jax
from repro_torch.core.baf import (BaFStreamConfig, baf_stream_backward,
                                  baf_stream_predict)
from repro_torch.core.quant import QuantParams
from repro_torch.distributed import pipeline

import torch_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, D, C, HID = 2, 16, 32, 8, 16
SEL = np.array([3, 30, 0, 17, 9, 12, 25, 6], np.int32)


def _stream(seed, shape=(B, S, D)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 3
    x[..., 1] = 1e5 * rng.choice([-1, 1], size=shape[:-1])  # past +-65504
    x[..., 2] = -7e4                                       # saturates
    x[..., 4] = 0.0
    x[..., 5] = -0.0                                       # signed zeros
    x[..., 6] = rng.choice([0.0, -0.0], size=shape[:-1])
    x[..., 7] = 0.25                                       # constant
    return x


def _bits16(h):
    return np.asarray(h).view(np.uint16)


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_stream_bit_identical(dtype, bits, subset):
    x = _stream(bits)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    if subset:
        got = pipeline._quantize_stream(xt, bits, torch.from_numpy(SEL))
        want = jpipe._quantize_stream(xj[..., SEL], bits)
    else:
        got = pipeline._quantize_stream(xt, bits)
        want = jpipe._quantize_stream(xj, bits)
    assert got[0].dtype == torch.uint8
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float16
        assert np.array_equal(_bits16(g.numpy()), _bits16(w))


@pytest.mark.parametrize("bits", [2, 8])
def test_dequantize_stream_and_wire_bytes_match_jax(bits):
    x = _stream(11)
    codes, mn, mx = jpipe._quantize_stream(jnp.asarray(x), bits)
    want = jpipe._dequantize_stream(codes, mn, mx, bits, jnp.float32)
    got = pipeline._dequantize_stream(
        torch.tensor(np.asarray(codes)),
        torch.tensor(np.asarray(mn)), torch.tensor(np.asarray(mx)),
        bits, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert pipeline.wire_bytes(torch.from_numpy(x), bits) == \
        jpipe.wire_bytes(jnp.asarray(x), bits)


@pytest.mark.parametrize("bits", range(1, 9))
def test_pack_codes_round_trip(bits):
    rng = np.random.default_rng(bits)
    codes = torch.from_numpy(
        rng.integers(0, 1 << bits, (3, 7, 5)).astype(np.uint8))
    wire = pipeline.pack_codes(codes, bits)
    assert wire.dtype == torch.uint8
    assert wire.numel() == -(-codes.numel() * bits // 8)
    back = pipeline.unpack_codes(wire, bits, codes.numel())
    assert torch.equal(back.reshape(codes.shape), codes)


def test_stream_bits_above_8_refused():
    with pytest.raises(ValueError, match="1..8 bits"):
        pipeline._quantize_stream(torch.zeros(2, 3), 9)


def _baf_params(seed=1, c=C, d=D, hidden=HID):
    return jax.tree.map(np.asarray, init_baf_stream(
        jax.random.PRNGKey(seed), JBaFStreamConfig(c=c, d_in=d,
                                                   hidden=hidden)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_baf_stream_backward_matches_jax(dtype):
    params = _baf_params()
    baf = baf_stream_from_jax(params, BaFStreamConfig(c=C, d_in=D,
                                                      hidden=HID),
                              device="cpu")
    z = np.random.default_rng(2).normal(size=(B, S, C)).astype(np.float32)
    want = jax_backward(jax.tree.map(jnp.asarray, params), jnp.asarray(z),
                        dtype=getattr(jnp, dtype))
    got = baf_stream_backward(baf, torch.from_numpy(z),
                              dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    tol = (1e-5 if dtype == "float32" else 3e-2) * float(
        np.abs(np.asarray(want, np.float32)).max())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=tol)


def test_baf_stream_predict_consolidates_like_jax():
    params = _baf_params()
    baf = baf_stream_from_jax(params, BaFStreamConfig(c=C, d_in=D,
                                                      hidden=HID),
                              device="cpu")
    x = _stream(5)
    x[..., 1:3] = 0.5                        # keep the bins finite
    codes, mn, mx = jpipe._quantize_stream(jnp.asarray(x[..., SEL]), 8)
    z_hat = jpipe._dequantize_stream(codes, mn, mx, 8, jnp.float32)
    w = np.random.default_rng(3).normal(size=(D, D)).astype(np.float32) * .05
    want = jax_predict(jax.tree.map(jnp.asarray, params),
                       lambda t: t @ jnp.asarray(w), jnp.asarray(SEL), z_hat,
                       codes=codes, qp=JQuantParams(mins=mn, maxs=mx, bits=8))
    wt = torch.from_numpy(w)
    got = baf_stream_predict(
        baf, lambda t: t @ wt, torch.from_numpy(SEL),
        torch.tensor(np.asarray(z_hat)),
        codes=torch.tensor(np.asarray(codes)),
        qp=QuantParams(mins=torch.tensor(np.asarray(mn)),
                       maxs=torch.tensor(np.asarray(mx)), bits=8))
    tol = 1e-5 * float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)
    # the transmitted channels lie in their received bins
    step = (np.asarray(mx, np.float32) - np.asarray(mn, np.float32)) / 255
    lo = np.asarray(mn, np.float32) + (np.asarray(codes) - .5) * step
    hi = np.asarray(mn, np.float32) + (np.asarray(codes) + .5) * step
    sel = got.numpy()[..., SEL]
    assert ((sel >= lo - 1e-5) & (sel <= hi + 1e-5)).all()


# ---------------------------------------------------------------------------
# The transfers at 2 pods
# ---------------------------------------------------------------------------

MESH_RUN = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.distributed.pipeline import (compressed_pod_transfer,
                                        subset_pod_transfer)
d = np.load(sys.argv[1])
baf = {k: {"w": jnp.asarray(d[k + "/w"]), "b": jnp.asarray(d[k + "/b"])}
       for k in ("l1", "l2", "l3", "l4")}
baf.update({k: {"alpha": jnp.asarray(d[k + "/alpha"])}
            for k in ("a1", "a2", "a3")})
w = jnp.asarray(d["w"])
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
out = {}
with set_mesh(mesh):
    xs = jax.device_put(jnp.asarray(d["x"]), NamedSharding(mesh, P()))
    for bits in (8, 4):
        out[f"full{bits}"] = np.asarray(jax.jit(
            lambda t: compressed_pod_transfer(t, mesh, bits=bits,
                                              dtype=jnp.float32))(xs))
    out["subset"] = np.asarray(jax.jit(lambda t: subset_pod_transfer(
        t, mesh, sel_idx=jnp.asarray(d["sel"]), baf_params=baf,
        forward_fn=lambda h: h @ w, bits=8, dtype=jnp.float32))(xs))
np.savez(sys.argv[2], **out)
"""


def _vmap_pods(xs, baf, w, sel):
    """The reference's pieces, one pod a vmap lane, a ring of ppermutes."""
    npod = xs.shape[0]
    perm = [(i, (i + 1) % npod) for i in range(npod)]
    send = lambda t: jax.lax.ppermute(t, "pod", perm)

    def full(x, bits):
        codes, mn, mx = jpipe._quantize_stream(x, bits)
        return jpipe._dequantize_stream(send(codes), send(mn), send(mx),
                                        bits, jnp.float32)

    def subset(x):
        codes, mn, mx = jpipe._quantize_stream(x[..., sel], 8)
        codes, mn, mx = send(codes), send(mn), send(mx)
        z_hat = jpipe._dequantize_stream(codes, mn, mx, 8, jnp.float32)
        return jpipe.baf_restore_stream(
            z_hat, baf_params=baf, forward_fn=lambda h: h @ w, sel_idx=sel,
            codes=codes, qp=JQuantParams(mins=mn, maxs=mx, bits=8),
            dtype=jnp.float32)
    x = jnp.asarray(xs)
    return {**{f"full{b}": np.asarray(jax.vmap(
        lambda t: full(t, b), axis_name="pod")(x)) for b in (8, 4)},
        "subset": np.asarray(jax.vmap(subset, axis_name="pod")(x))}


@pytest.fixture(scope="module")
def transfers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pods")
    params = _baf_params(seed=4)
    w = np.random.default_rng(6).normal(size=(D, D)).astype(np.float32) * .05
    same = np.random.default_rng(7).normal(size=(B, S, D)).astype(np.float32)
    xs_same = np.stack([same, same])
    xs_diff = np.random.default_rng(8).normal(
        size=(2, B, S, D)).astype(np.float32) * np.array([1, 3],
                                                         np.float32)[
        :, None, None, None]
    leaves = {f"{k}/{n}": v for k, sub in params.items()
              for n, v in sub.items()}
    np.savez(tmp / "in.npz", x=same, w=w, sel=SEL, **leaves)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    ref = subprocess.Popen([sys.executable, "-c", MESH_RUN,
                            str(tmp / "in.npz"), str(tmp / "out.npz")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ranks = torch_ranks.spawn(torch_ranks.transfer_rank, 2, (2, 1, 1), tmp,
                              [xs_same, xs_diff], [8, 4], params, w, SEL)
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    mesh = dict(np.load(tmp / "out.npz"))
    vmapped = _vmap_pods(xs_diff, jax.tree.map(jnp.asarray, params),
                         jnp.asarray(w), jnp.asarray(SEL))
    return dict(same=xs_same, diff=xs_diff, mesh=mesh, vmapped=vmapped,
                ranks=ranks)


@pytest.mark.parametrize("kind", ["full8", "full4", "subset"])
def test_transfer_matches_the_fake_mesh(transfers, kind):
    """Both pods hold the same x: each receives what the mesh run returns."""
    want = transfers["mesh"][kind]
    for rank in transfers["ranks"]:
        res = rank[0]
        got = res["subset"] if kind == "subset" else \
            res["full"][int(kind[4:])]
        tol = 1e-5 * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ["full8", "full4", "subset"])
def test_transfer_matches_vmap_of_the_reference(transfers, kind):
    """A different x on each pod: pod p receives pod p - 1's stream."""
    want = transfers["vmapped"][kind]
    for pod, rank in enumerate(transfers["ranks"]):
        res = rank[1]
        got = res["subset"] if kind == "subset" else \
            res["full"][int(kind[4:])]
        tol = 1e-5 * float(np.abs(want[pod]).max())
        np.testing.assert_allclose(got.numpy(), want[pod], rtol=0, atol=tol)
        if kind != "subset":               # within a half step of the sent x
            sent = transfers["diff"][1 - pod]
            bits = int(kind[4:])
            span = sent.max((0, 1)) - sent.min((0, 1))
            assert (np.abs(got.numpy() - sent)
                    <= 0.51 * span / ((1 << bits) - 1) + 1e-3).all()


def test_wire_bytes_are_what_ppermute_moves(transfers):
    x = torch.from_numpy(transfers["same"][0])
    want = [pipeline.wire_bytes(x, 8)[0], pipeline.wire_bytes(x, 4)[0],
            pipeline.wire_bytes(x[..., SEL], 8)[0]]
    for rank in transfers["ranks"]:
        for res in rank:
            assert res["sent"] == want


def test_pod_boundary_launcher_on_two_gloo_ranks():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    out = subprocess.run([sys.executable, "-m",
                          "repro_torch.launch.pod_boundary", "--device",
                          "cpu", "--world", "2"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 4, out.stdout
    x = torch.zeros(4, 64, 256)
    for line, bits in zip(lines[:2], (8, 4)):
        comp, raw = pipeline.wire_bytes(x, bits)
        assert line.startswith(f"[full  n={bits}] wire {comp:>8,} B vs bf16 "
                               f"{raw:>8,} B")
        err = float(line.rsplit(" ", 1)[1])
        assert 0 < err < 8.0 / ((1 << bits) - 1)    # a half step of ~N(0, 1)
    comp, _ = pipeline.wire_bytes(x[..., :64], 8)
    assert lines[2].startswith(f"[subset C=64/256 n=8] wire {comp:>8,} B")
    assert "restored (4, 64, 256)" in lines[2]
