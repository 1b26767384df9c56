"""Signed zeros in the side info: the port against the JAX package.

``jnp.min`` ranks -0.0 below +0.0 and ``jnp.max`` ranks +0.0 above -0.0,
whatever order the zeros come in; the fp16 min is sent on the wire, so the
port's plain version (and, on the card, its kernel) must order them the
same way. Channels here hold exact zeros of both signs in both orders,
beside all-zero and all-negative-zero channels. Side info, codes and wire
bytes must be bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipe
from repro.core import quant as jq
from repro.kernels.quantize import quantize_pallas
from repro_torch import pipeline as tpipe
from repro_torch.core import quant as tq
from repro_torch.kernels.quantize import quantize_fused, quantize_plain

R = 8
# one column per channel, R rows: the zeros' signs and orders under test
COLUMNS = [
    [0.0, -0.0] + [0.5, 1.0] * 3,           # +0 first, then -0
    [-0.0, 0.0] + [0.5, 1.0] * 3,           # -0 first
    [1.0, 0.0, 2.0, -0.0, 0.0, 3.0, -0.0, 4.0],
    [0.0] * R,                              # all +0
    [-0.0] * R,                             # all -0
    [-1.0, -0.0, -2.0, 0.0] * 2,            # zeros at the top
    [0.0, -0.0, -0.0, 0.0] * 2,             # only zeros, mixed
    [0.25, 0.5, 0.75, 1.0] * 2,             # no zero
]


def _zeros_x(batch: int = 2) -> np.ndarray:
    """(batch, R, C) float32; example b reverses the row order when b is odd,
    so each example meets the zeros in the other order."""
    x = np.array(COLUMNS, np.float32).T                      # (R, C)
    return np.stack([x if b % 2 == 0 else x[::-1] for b in range(batch)])


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == np.float16 else a


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_the_inputs_hold_both_zeros():
    x = _zeros_x()
    zero = x == 0
    assert (zero & np.signbit(x)).any() and (zero & ~np.signbit(x)).any()


@pytest.mark.parametrize("per_example", [True, False])
@pytest.mark.parametrize("bits", [4, 8, 12])
def test_quant_params_order_signed_zeros_like_jax(per_example, bits):
    x = _zeros_x()
    jqp = jq.compute_quant_params(jnp.asarray(x), bits,
                                  per_example=per_example)
    tqp = tq.compute_quant_params(torch.from_numpy(x), bits,
                                  per_example=per_example)
    _same(tqp.mins.numpy(), jqp.mins)
    _same(tqp.maxs.numpy(), jqp.maxs)
    _same(tq.quantize(torch.from_numpy(x), tqp).numpy(),
          jq.quantize(jnp.asarray(x), jqp))


@pytest.mark.parametrize("dims", [(1,), (0, 1)])
def test_min_max_follow_jnp_min_max(dims):
    """The float32 min and max before rounding: -0 wins the min and +0 the
    max, as in jnp.min / jnp.max."""
    x = _zeros_x()
    mn, mx = tq.signed_zero_min_max(torch.from_numpy(x), dims, False)
    _same(mn.numpy().view(np.uint32),
          np.asarray(jnp.min(jnp.asarray(x), axis=dims)).view(np.uint32))
    _same(mx.numpy().view(np.uint32),
          np.asarray(jnp.max(jnp.asarray(x), axis=dims)).view(np.uint32))


def test_min_max_still_propagate_nan():
    x = _zeros_x()
    x[1, 3, 0] = np.nan
    mn, mx = tq.signed_zero_min_max(torch.from_numpy(x), (1,), False)
    assert np.isnan(mn.numpy()[1, 0]) and np.isnan(mx.numpy()[1, 0])
    assert np.isnan(mn.numpy()).sum() == np.isnan(mx.numpy()).sum() == 1


@pytest.mark.parametrize("bits", [2, 8])
def test_quantize_plain_and_wrapper_match_pallas(bits):
    x = _zeros_x()
    jc, jm, jM = quantize_pallas(jnp.asarray(x), bits, block_c=x.shape[-1],
                                 interpret=True)
    for got in (quantize_plain(torch.from_numpy(x), bits),
                quantize_fused(torch.from_numpy(x), bits)):
        for t, j in zip(got, (jc, jm, jM)):
            _same(t.numpy(), j)
    # the min of the channel that meets +0 first is -0, in both examples
    assert (_bits(jm)[:, 0] == 0x8000).all()


def test_quantize_wrapper_gathers_zero_channels_like_jax():
    """The channel gather with the zero channels among unselected noise."""
    rng = np.random.default_rng(11)
    x = _zeros_x()
    p = 20
    sel = rng.permutation(p)[:x.shape[-1]]
    full = rng.normal(size=(x.shape[0], R, p)).astype(np.float32)
    full[..., sel] = x
    jqp = jq.compute_quant_params(jnp.asarray(x), 10, per_example=True)
    codes, mins, maxs = quantize_fused(torch.from_numpy(full), 10,
                                       torch.from_numpy(sel.astype(np.int32)))
    _same(mins.numpy(), np.asarray(jqp.mins).reshape(mins.shape))
    _same(maxs.numpy(), np.asarray(jqp.maxs).reshape(maxs.shape))
    _same(codes.numpy(), jq.quantize(jnp.asarray(x), jqp))


@pytest.mark.parametrize("backend", ["rans", "raw"])
def test_plan_wire_bytes_match_jax(backend):
    """plan.encode(z).data of a z whose selected channels hold the zeros:
    byte-identical between the two packages."""
    rng = np.random.default_rng(12)
    x = _zeros_x(batch=1)[0]                                # (R, C)
    c, p = x.shape[-1], 16
    sel = rng.permutation(p)[:c]
    z = rng.normal(size=(1, 2, R // 2, p)).astype(np.float32)
    z[..., sel] = x.reshape(2, R // 2, c)
    jplan = jpipe.compile(jpipe.OperatingPoint(c=c, bits=8, backend=backend),
                          jpipe.ModelSpec(sel_idx=sel))
    tplan = tpipe.compile(tpipe.OperatingPoint(c=c, bits=8, backend=backend),
                          tpipe.ModelSpec(sel_idx=sel), device="cpu")
    jblob, tblob = jplan.encode(z), tplan.encode(z)
    assert tblob.data == jblob.data
    tdec = tplan.decode_batch([tblob])
    assert (tdec.mins.reshape(-1).view(np.uint16)[:2] == 0x8000).all()
