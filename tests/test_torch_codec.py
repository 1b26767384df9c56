"""The port's wire codec against the JAX package's: same codes, same bytes.

Containers must be byte-identical for every backend, and a blob written by
either package must decode in the other to the same codes and side info.
"""
import jax  # noqa: F401  (both frameworks load in one test process)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.core import codec as jwire
from repro.core.quant import QuantParams as JQP
from repro_torch.core import codec as twire
from repro_torch.core.quant import QuantParams as TQP
from repro_torch.kernels.histogram import channel_histogram

BACKENDS = ["zlib", "raw", "rans", "rans-ctx", "png"]


def _inputs(backend, bits, seed=0):
    rng = np.random.default_rng(seed)
    if jwire.backend_wants_tiling(backend):
        shape = (16, 32)                      # a tiled 2D image
    else:
        shape = (2, 6, 5, 8)                  # channel-last BaF codes
    # skewed codes, as BaF residuals are, so entropy coding has work to do
    codes = np.clip(rng.normal(size=shape) * (1 << bits) / 8
                    + (1 << bits) / 2, 0, (1 << bits) - 1).astype(np.uint8)
    mins = rng.normal(size=(2, 8)).astype(np.float16)
    maxs = (mins + np.float16(2)).astype(np.float16)
    return codes, mins, maxs


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("backend", BACKENDS)
def test_containers_byte_identical_and_cross_decode(backend, bits):
    if backend == "png":
        pytest.importorskip("PIL")
    codes, mins, maxs = _inputs(backend, bits)
    jdata = jwire.encode(codes, JQP(mins, maxs, bits), backend).to_bytes()
    tdata = twire.encode(codes, TQP(mins, maxs, bits), backend).to_bytes()
    assert tdata == jdata
    # port decodes the JAX blob, JAX decodes the port's blob
    tc, tqp = twire.decode(twire.EncodedTensor.from_bytes(jdata))
    jc, jqp = jwire.decode(jwire.EncodedTensor.from_bytes(tdata))
    for c, qp in ((tc, tqp), (jc, jqp)):
        np.testing.assert_array_equal(c.reshape(codes.shape), codes)
        np.testing.assert_array_equal(np.asarray(qp.mins).ravel().view(np.uint16),
                                      mins.ravel().view(np.uint16))
        np.testing.assert_array_equal(np.asarray(qp.maxs).ravel().view(np.uint16),
                                      maxs.ravel().view(np.uint16))


@pytest.mark.parametrize("backend", ["zlib", "rans", "rans-ctx"])
def test_decode_many_matches_jax(backend):
    blobs = []
    for seed in range(3):
        codes, mins, maxs = _inputs(backend, 6, seed)
        blobs.append(jwire.encode(codes, JQP(mins, maxs, 6), backend)
                     .to_bytes())
    tcodes, tqps = twire.decode_many(
        [twire.EncodedTensor.from_bytes(b) for b in blobs])
    jcodes, jqps = jwire.decode_many(
        [jwire.EncodedTensor.from_bytes(b) for b in blobs])
    np.testing.assert_array_equal(tcodes, jcodes)
    assert tcodes.dtype == jcodes.dtype
    for t, j in zip(tqps, jqps):
        np.testing.assert_array_equal(np.asarray(t.mins), np.asarray(j.mins))


@pytest.mark.parametrize("bits", [1, 5, 8])
def test_rans_with_precomputed_counts_matches_jax(bits):
    codes, mins, maxs = _inputs("rans", bits, seed=4)
    counts = channel_histogram(codes, bits)
    tdata = twire.encode(codes, TQP(mins, maxs, bits), "rans",
                         counts=counts).to_bytes()
    jdata = jwire.encode(codes, JQP(mins, maxs, bits), "rans").to_bytes()
    assert tdata == jdata
    assert twire.empirical_entropy_bits(codes, bits, counts) == \
        jwire.empirical_entropy_bits(codes, bits)
    with pytest.raises(ValueError, match="do not fit"):
        twire.encode(codes, TQP(mins, maxs, bits), "rans",
                     counts=counts[:, :1])


def test_corrupt_blobs_raise_like_jax():
    codes, mins, maxs = _inputs("rans", 8)
    data = twire.encode(codes, TQP(mins, maxs, 8), "rans").to_bytes()
    for bad in (data[:5], b"XXXX" + data[4:], data + b"\0"):
        with pytest.raises(ValueError) as te:
            twire.decode(twire.EncodedTensor.from_bytes(bad))
        with pytest.raises(ValueError) as je:
            jwire.decode(jwire.EncodedTensor.from_bytes(bad))
        assert str(te.value) == str(je.value)
