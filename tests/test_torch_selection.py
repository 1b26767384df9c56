"""The port's channel selection (paper §3.1, eqs. 2-3) against the JAX
package.

Correlation matrices at 1e-5 (float32 sums in other orders); the ranking
runs on the host in numpy, so the same rho gives the identical order. For
``compute_channel_order`` both packages see the same numpy batches and
bridged weights, and the orders must agree wherever two channels' totals
differ by more than the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core import selection as jsel
from repro.data.synthetic import ShapesDatasetConfig as JData
from repro.models.cnn import CNNConfig as JCNNConfig
from repro.models.cnn import init_cnn
from repro.train import baf_trainer as jtrainer
from repro_torch.bridge import cnn_from_jax
from repro_torch.core import selection as tsel
from repro_torch.data.synthetic import ShapesDatasetConfig
from repro_torch.models.cnn import CNNConfig
from repro_torch.train import baf_trainer as ttrainer

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(width_mult=0.125, input_size=32, num_classes=8, tail_res_blocks=1)
DATA = dict(image_size=32, num_classes=8, batch_size=4)


@pytest.mark.parametrize("shape", [(2, 4, 4, 6, 3), (3, 8, 6, 16, 5),
                                   (1, 16, 16, 32, 16)])
def test_correlation_matrix_conv_matches(shape):
    b, h, w, p, q = shape
    rng = np.random.default_rng(p)
    z = rng.normal(size=(b, h, w, p)).astype(np.float32)
    x = rng.normal(size=(b, 2 * h, 2 * w, q)).astype(np.float32)
    x[..., 0] += 0.7 * np.repeat(np.repeat(z[..., 0], 2, 1), 2, 2)
    want = np.asarray(jsel.correlation_matrix_conv(jnp.asarray(z),
                                                   jnp.asarray(x)))
    got = tsel.correlation_matrix_conv(torch.from_numpy(z),
                                       torch.from_numpy(x))
    assert got.shape == (p, q) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(2, 9, 5, 3), (1, 64, 12, 7)])
def test_correlation_matrix_stream_matches(shape):
    b, s, p, q = shape
    rng = np.random.default_rng(s)
    z = rng.normal(size=(b, s, p)).astype(np.float32)
    x = (rng.normal(size=(b, s, q)) * 3 + 1).astype(np.float32)
    x[..., 1] = z[..., 2] * -2.0                 # |rho| = 1
    want = np.asarray(jsel.correlation_matrix_stream(jnp.asarray(z),
                                                     jnp.asarray(x)))
    got = tsel.correlation_matrix_stream(torch.from_numpy(z),
                                         torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert abs(got[2, 1] - 1.0) < 1e-5


def test_stride2_offsets_cover_everything():
    x = torch.arange(2 * 6 * 4 * 3, dtype=torch.float32).view(2, 6, 4, 3)
    offs = tsel.stride2_offsets(x)
    assert len(offs) == 4 and all(o.shape == (2, 3, 2, 3) for o in offs)
    got = torch.sort(torch.cat([o.reshape(-1) for o in offs])).values
    assert torch.equal(got, x.reshape(-1))


@pytest.mark.parametrize("ties", [False, True])
def test_select_channels_identical_order(ties):
    """The same numpy rho (as a tensor or an array) gives the identical
    order and scores; equal totals keep index order in both."""
    rng = np.random.default_rng(4)
    rho = rng.uniform(0, 1, size=(40, 9)).astype(np.float32)
    if ties:
        rho[[3, 17, 29]] = rho[11]
        rho[[5, 6]] = 0.5
    want = jsel.select_channels(jnp.asarray(rho))
    for given_rho in (rho, torch.from_numpy(rho)):
        got = tsel.select_channels(given_rho)
        np.testing.assert_array_equal(got.order, want.order)
        np.testing.assert_array_equal(got.scores, want.scores)
        np.testing.assert_array_equal(got.rho, rho)


@given(p=st.integers(2, 12), q=st.integers(1, 6), seed=st.integers(0, 2**16))
@settings(max_examples=30, deadline=None)
def test_property_greedy_equals_sort(p, q, seed):
    """The paper's iterative re-selection is one stable descending sort,
    in the port as in the reference (ties included)."""
    r = np.random.default_rng(seed)
    rho = r.uniform(0, 1, size=(p, q)).astype(np.float32)
    if p > 3:
        rho[p - 1] = rho[0]                     # a tie
    c = max(1, p // 2)
    greedy = tsel.select_channels_greedy(torch.from_numpy(rho), c)
    np.testing.assert_array_equal(greedy, tsel.select_channels(rho).order[:c])
    np.testing.assert_array_equal(greedy,
                                  jsel.select_channels_greedy(rho, c))


def test_accumulate_correlation_matches():
    rng = np.random.default_rng(8)
    pairs = [(rng.normal(size=(2, 4, 4, 6)).astype(np.float32),
              rng.normal(size=(2, 8, 8, 3)).astype(np.float32))
             for _ in range(3)]
    want = jsel.accumulate_correlation(
        [(jnp.asarray(z), jnp.asarray(x)) for z, x in pairs])
    got = tsel.accumulate_correlation(
        [(torch.from_numpy(z), torch.from_numpy(x)) for z, x in pairs])
    np.testing.assert_allclose(got.rho, want.rho, **TOL)
    assert sorted(got.order.tolist()) == list(range(6))
    assert (np.diff(got.scores) <= 0).all()
    with pytest.raises(ValueError, match="no batches"):
        tsel.accumulate_correlation([])


def test_compute_channel_order_matches(monkeypatch):
    """Bridged weights, the same numpy batches: the same totals at 1e-5,
    and the same order of every two channels whose totals differ by more
    than that."""
    rng = np.random.default_rng(0)
    jcfg, tcfg = JCNNConfig(**CFG), CNNConfig(**CFG)
    params = jax.tree.map(np.asarray, jax.jit(init_cnn, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    batches = [rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
               for _ in range(3)]
    labels = np.zeros(4, np.int32)
    monkeypatch.setattr(jtrainer, "shapes_batch_iterator",
                        lambda cfg, seed=0: iter(
                            [(jnp.asarray(b), labels) for b in batches]))
    monkeypatch.setattr(ttrainer, "shapes_batch_iterator",
                        lambda cfg, seed=0, start_step=0, device=None: iter(
                            [(torch.from_numpy(b), torch.from_numpy(labels))
                             for b in batches]))
    want = jtrainer.compute_channel_order(jax.tree.map(jnp.asarray, params),
                                          JData(**DATA), batches=3)
    got = ttrainer.compute_channel_order(
        cnn_from_jax(params, tcfg, device="cpu"),
        ShapesDatasetConfig(**DATA), batches=3, device="cpu")
    np.testing.assert_allclose(got.rho, want.rho, **TOL)
    tot_j, tot_t = want.rho.sum(1), got.rho.sum(1)
    np.testing.assert_allclose(tot_t, tot_j, **TOL)
    pos_j = np.argsort(want.order)
    pos_t = np.argsort(got.order)
    tol = TOL["atol"] * want.rho.shape[1]
    apart = np.abs(tot_j[:, None] - tot_j[None, :]) > tol
    same = np.sign(pos_j[:, None] - pos_j[None, :]) == \
        np.sign(pos_t[:, None] - pos_t[None, :])
    assert apart.sum() > 0 and same[apart].all()
