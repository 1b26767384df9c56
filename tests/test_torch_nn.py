"""The port's layers against ``repro/nn.py`` on the same numpy inputs.

Tolerance atol/rtol 1e-5: XLA and PyTorch sum the convolution products in
different orders on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro_torch import nn as tnn

TOL = dict(atol=1e-5, rtol=1e-5)


def _hwio_to_oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_conv_same_padding(stride, k, hw):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    w = rng.normal(size=(k, k, 5, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    want = jnn.conv_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          jnp.asarray(x), stride=stride)
    got = tnn.conv_apply(torch.from_numpy(x), _hwio_to_oihw(w),
                         torch.from_numpy(b), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw", [(4, 4), (5, 3)])
def test_conv_transpose_same(hw):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    w = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    want = jnn.conv_transpose_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                    jnp.asarray(x), stride=2)
    got = tnn.conv_transpose_apply(torch.from_numpy(x), _hwio_to_oihw(w),
                                   torch.from_numpy(b), stride=2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batchnorm_apply_and_inverse():
    rng = np.random.default_rng(2)
    p = {"scale": rng.normal(size=6), "bias": rng.normal(size=6),
         "mean": rng.normal(size=6), "var": rng.uniform(0.1, 2.0, size=6)}
    p["scale"][1] = 1e-8                              # floored to 1e-6
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 3, 3, 6)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_allclose(
        tnn.batchnorm_apply(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jnn.batchnorm_apply(jp, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        tnn.batchnorm_inverse(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jnn.batchnorm_inverse(jp, jnp.asarray(x))), **TOL)


def test_activations_and_dense():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    a = rng.uniform(0, 1, size=6).astype(np.float32)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(tnn.leaky_relu(tx).numpy(),
                                  np.asarray(jnn.leaky_relu(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tnn.prelu_apply(torch.from_numpy(a), tx).numpy(),
        np.asarray(jnn.prelu_apply({"alpha": jnp.asarray(a)}, jnp.asarray(x))))
    np.testing.assert_allclose(
        tnn.dense_apply(tx, torch.from_numpy(w), torch.from_numpy(b)).numpy(),
        np.asarray(jnn.dense_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                   jnp.asarray(x))), **TOL)
