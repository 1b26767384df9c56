"""The port's linear scan and linear attention against the JAX package.

On the CPU the scan wrapper runs its plain version, the chunked algorithm
of ``models/linear_attention.py``. It is held to the JAX Pallas scan
(``ops.linear_scan``, interpret mode) and to the JAX chunked engine at
1e-4, and to the recurrent oracle ``reference_scan`` at 1e-3 (the chunked
factorisation rounds differently from the step-by-step recurrence), over
both modes, per-channel and scalar decay, with and without a bonus and an
initial state, at chunk 128 with a per-channel decay too (overflow
included). Inputs are numpy draws from fixed seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models import linear_attention as JL
from repro_torch.kernels.linear_scan import (_SMEM_BYTES, _smem_floats,
                                             linear_scan)
from repro_torch.models import linear_attention as TL


def _inputs(seed, b=2, s=64, h=3, dk=16, dv=8, per_channel=True,
            bonus=True, init=True):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = (rng.normal(size=(b, s, h, dk)) * 0.5).astype(f)
    k = (rng.normal(size=(b, s, h, dk)) * 0.5).astype(f)
    v = rng.normal(size=(b, s, h, dv)).astype(f)
    ld = -np.exp(rng.normal(size=(b, s, h, dk if per_channel else 1)) * 0.7
                 - 1.0).astype(f)
    u = (rng.normal(size=(h, dk)) * 0.3).astype(f) if bonus else None
    s0 = rng.normal(size=(b, h, dk, dv)).astype(f) if init else None
    return q, k, v, ld, u, s0


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("mode", ["rwkv", "ssm"])
def test_plain_scan_matches_jax(mode, per_channel, init):
    q, k, v, ld, u, s0 = _inputs(0, per_channel=per_channel,
                                 bonus=mode == "rwkv", init=init)
    jargs = [_jax(a) for a in (q, k, v, ld)]
    kw = dict(bonus=_jax(u), initial_state=_jax(s0), mode=mode)
    y, st = linear_scan(*[_torch(a) for a in (q, k, v, ld)], bonus=_torch(u),
                        initial_state=_torch(s0), chunk=8, mode=mode)
    assert y.dtype == st.dtype == torch.float32
    want_kernel = ops.linear_scan(*jargs, chunk=8, **kw)
    want_chunked = JL.chunked_linear_attention(*jargs, chunk=8, **kw)
    want_ref = JL.reference_scan(*jargs, **kw)
    for want, tol in ((want_kernel, 1e-4), (want_chunked, 1e-4),
                      (want_ref, 1e-3)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(st.numpy(), np.asarray(want[1]), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("mode", ["rwkv", "ssm"])
def test_reference_scan_and_step_match_jax(mode):
    q, k, v, ld, u, s0 = _inputs(1, s=12, bonus=mode == "rwkv")
    want = JL.reference_scan(*[_jax(a) for a in (q, k, v, ld)], bonus=_jax(u),
                             initial_state=_jax(s0), mode=mode)
    got = TL.reference_scan(*[_torch(a) for a in (q, k, v, ld)],
                            bonus=_torch(u), initial_state=_torch(s0),
                            mode=mode)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    jy, jst = JL.linear_attention_step(
        *[_jax(a[:, 3]) for a in (q, k, v, ld)], _jax(s0), bonus=_jax(u),
        mode=mode)
    ty, tst = TL.linear_attention_step(
        *[_torch(a[:, 3]) for a in (q, k, v, ld)], _torch(s0),
        bonus=_torch(u), mode=mode)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-6)


def test_bf16_inputs_widen_like_jax():
    q, k, v, ld, u, s0 = _inputs(2)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = JL.chunked_linear_attention(*jb, jnp.asarray(ld), bonus=_jax(u),
                                       initial_state=_jax(s0), chunk=8)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = TL.chunked_linear_attention(*tb, _torch(ld), bonus=_torch(u),
                                      initial_state=_torch(s0), chunk=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_long_chunk_overflows_like_the_reference():
    """chunk 32 at the clamp (-4 per step) takes exp(-la) past float32: the
    factorisation is kept, so the port gives the reference's inf/NaN."""
    q, k, v, ld, u, _ = _inputs(3, s=64, init=False)
    ld = np.full_like(ld, -4.0)
    want = JL.chunked_linear_attention(*[_jax(a) for a in (q, k, v, ld)],
                                       bonus=_jax(u), chunk=32)
    got = TL.chunked_linear_attention(*[_torch(a) for a in (q, k, v, ld)],
                                      bonus=_torch(u), chunk=32)
    assert not np.isfinite(np.asarray(want[0])).all()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4, rtol=1e-4, equal_nan=True)
    np.testing.assert_array_equal(np.isnan(got[0].numpy()),
                                  np.isnan(np.asarray(want[0])))


def test_scan_wrapper_validates():
    q, k, v, ld, u, s0 = (_torch(a) for a in _inputs(4, s=16))
    with pytest.raises(ValueError, match="divisible"):
        linear_scan(q, k, v, ld, chunk=5)
    with pytest.raises(ValueError, match="mode"):
        linear_scan(q, k, v, ld, mode="mamba")
    with pytest.raises(ValueError, match="log_decay"):
        linear_scan(q, k, v, ld[..., :3])
    # meta (the dry run): empty float32 outputs of the right shapes
    y, st = linear_scan(q.to("meta"), k.to("meta"), v.to("meta"),
                        ld.to("meta"))
    assert y.device.type == "meta" and y.shape == v.shape \
        and y.dtype == torch.float32
    assert st.shape == (q.shape[0], q.shape[2], q.shape[3], v.shape[3])


@pytest.mark.parametrize("mode", ["rwkv", "ssm"])
def test_per_channel_decay_at_chunk_128_matches_jax(mode):
    """A per-channel decay at zamba2's chunk of 128, which the kernel takes
    since its tensor-core pass A: the plain version against the JAX Pallas
    scan (interpret mode) at 1e-4, rwkv with a bonus, an initial state."""
    q, k, v, ld, u, s0 = _inputs(5, b=1, s=256, h=2, dk=16, dv=8,
                                 bonus=mode == "rwkv")
    y, st = linear_scan(*[_torch(a) for a in (q, k, v, ld)], bonus=_torch(u),
                        initial_state=_torch(s0), chunk=128, mode=mode)
    want = ops.linear_scan(*[_jax(a) for a in (q, k, v, ld)], bonus=_jax(u),
                           initial_state=_jax(s0), chunk=128, mode=mode)
    np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(want[1]), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("mode", ["rwkv", "ssm"])
def test_per_channel_decay_at_chunk_128_overflows_like_jax(mode):
    """The same inputs with every decay at the clamp: 128 x -4 takes
    exp(-la) past float32. The plain version keeps the JAX chunked
    engine's 0/1 mask product, so a masked inf * 0 makes every row NaN:
    NaN where ``chunked_linear_attention`` has NaN, 1e-4 elsewhere. The
    JAX Pallas scan masks with ``jnp.where`` instead: its NaN are a subset
    of those (rows past the overflow that the mask zeroes stay finite
    there), and the final states agree at 1e-4."""
    q, k, v, ld, u, s0 = _inputs(5, b=1, s=256, h=2, dk=16, dv=8,
                                 bonus=mode == "rwkv")
    ld = np.full_like(ld, -4.0)
    y, st = linear_scan(*[_torch(a) for a in (q, k, v, ld)], bonus=_torch(u),
                        initial_state=_torch(s0), chunk=128, mode=mode)
    jargs = [_jax(a) for a in (q, k, v, ld)]
    kw = dict(bonus=_jax(u), initial_state=_jax(s0), chunk=128, mode=mode)
    chunked = JL.chunked_linear_attention(*jargs, **kw)
    pallas = ops.linear_scan(*jargs, **kw)
    nan = np.isnan(y.numpy())
    assert nan.any()
    np.testing.assert_array_equal(nan, np.isnan(np.asarray(chunked[0])))
    for g, w in zip((y, st), chunked):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, equal_nan=True)
    pallas_nan = np.isnan(np.asarray(pallas[0]))
    assert pallas_nan.any() and not (pallas_nan & ~nan).any()
    np.testing.assert_allclose(st.numpy(), np.asarray(pallas[1]), atol=1e-4,
                               rtol=1e-4)


def test_per_channel_decay_at_chunk_128_fits_the_kernel():
    """The wrapper's reckoning of the kernel's shared memory (the larger
    pass): a per-channel decay at chunk 128, dk = dv = 64, takes the
    tensor-core pass A's 107,024 B, as a scalar one does, so two blocks
    fit an SM (228 KB, 1 KB reserved a block); at chunk 16 the CUDA-core
    layout stands; what does not fit a block (dk = 128, dv = 512) is
    refused."""
    for per_channel in (True, False):
        assert _smem_floats(128, 64, 64, per_channel) * 4 == 107_024
    assert 2 * (107_024 + 1024) <= 233_472
    assert _smem_floats(16, 64, 64, True) * 4 == 25_600
    assert _smem_floats(128, 128, 128, True) * 4 <= _SMEM_BYTES
    assert _smem_floats(128, 128, 512, True) * 4 > _SMEM_BYTES
