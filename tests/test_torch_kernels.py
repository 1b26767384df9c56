"""The port's quantize, histogram, CDF and consolidate against the JAX
package.

On the CPU each kernel wrapper runs its plain torch version; these tests
hold that version to the JAX reference functions and to the Pallas kernels
in interpret mode, on the same numpy inputs. Codes, side info, counts and
the CDF must be bit-identical (NaN side info at the same places);
consolidation is held at the JAX kernel test's atol of 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import ref
from repro.kernels.consolidate import consolidate_pallas
from repro.kernels.histogram import cdf_pallas
from repro.kernels.histogram import channel_histogram as jax_channel_histogram
from repro.kernels.histogram import \
    channel_histogram_cdf as jax_channel_histogram_cdf
from repro.kernels.histogram import histogram_pallas
from repro.kernels.quantize import quantize_pallas
from repro_torch.core import quant as tq
from repro_torch.kernels.consolidate import consolidate_fused
from repro_torch.kernels import histogram as thist
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels.histogram import (cdf, cdf_plain, channel_histogram,
                                          channel_histogram_cdf, histogram)
from repro_torch.kernels.quantize import quantize_fused

# (scale, offset): ordinary, shifted, tiny, fp16-subnormal, beyond fp16
CASES = [(1.0, 0.0), (3.0, 0.5), (1e-6, 0.0), (1e-7, 0.5), (1e5, -1.0),
         (65504.0, 0.5)]


def _x(seed, shape, scale, offset):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale + offset).astype(np.float32)
    x[0, ..., 0] = offset                       # a constant channel
    return x


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == np.float16:
        a, b = a.view(np.uint16), b.view(np.uint16)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bits", [1, 4, 8, 12, 16])
@pytest.mark.parametrize("scale,offset", CASES)
@pytest.mark.parametrize("per_example", [True, False])
def test_quant_functions_bit_identical(bits, scale, offset, per_example):
    x = _x(0, (2, 6, 5, 8), scale, offset)
    jqp = jq.compute_quant_params(jnp.asarray(x), bits,
                                  per_example=per_example)
    tqp = tq.compute_quant_params(torch.from_numpy(x), bits,
                                  per_example=per_example)
    _bits_equal(tqp.mins.numpy(), jqp.mins)
    _bits_equal(tqp.maxs.numpy(), jqp.maxs)
    jcodes = jq.quantize(jnp.asarray(x), jqp)
    tcodes = tq.quantize(torch.from_numpy(x), tqp)
    _bits_equal(tcodes.numpy(), jcodes)
    jlo, jhi = jq.bin_bounds(jcodes, jqp)
    tlo, thi = tq.bin_bounds(tcodes, tqp)
    _bits_equal(tlo.numpy(), jlo)
    _bits_equal(thi.numpy(), jhi)
    np.testing.assert_allclose(tq.dequantize(tcodes, tqp).numpy(),
                               np.asarray(jq.dequantize(jcodes, jqp)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("scale,offset", CASES)
@pytest.mark.parametrize("shape", [(1, 64, 8), (3, 100, 16)])
def test_quantize_plain_matches_pallas(bits, scale, offset, shape):
    x = _x(1, shape, scale, offset)
    jc, jm, jM = quantize_pallas(jnp.asarray(x), bits, block_c=shape[-1],
                                 interpret=True)
    tc, tm, tM = quantize_fused(torch.from_numpy(x), bits)
    for t, j in ((tc, jc), (tm, jm), (tM, jM)):
        _bits_equal(t.numpy(), j)
    rc, rm, rM = ref.quantize_fused_ref(jnp.asarray(x), bits)
    _bits_equal(tc.numpy(), rc)


def test_quantize_gathers_selected_channels():
    x = _x(2, (2, 48, 32), 2.0, 0.0)
    sel = np.random.default_rng(3).permutation(32)[:8]
    jc, jm, jM = quantize_pallas(jnp.asarray(x[..., sel]), 8, block_c=8,
                                 interpret=True)
    tc, tm, tM = quantize_fused(torch.from_numpy(x), 8,
                                torch.from_numpy(sel.astype(np.int32)))
    for t, j in ((tc, jc), (tm, jm), (tM, jM)):
        _bits_equal(t.numpy(), j)


@pytest.mark.parametrize("bits", [8, 12])
def test_quantize_nan_matches_jax(bits):
    """A NaN makes its (example, channel) side info NaN and its codes 0, as
    core.quant gives; every other channel is bit-identical."""
    x = _x(9, (2, 16, 4), 1.0, 0.0)
    x[1, 3, 2] = np.nan
    jqp = jq.compute_quant_params(jnp.asarray(x), bits, per_example=True)
    jcodes = np.asarray(jq.quantize(jnp.asarray(x), jqp))
    codes, mins, maxs = quantize_fused(torch.from_numpy(x), bits)
    for got, want in ((mins, jqp.mins), (maxs, jqp.maxs)):
        got = got.numpy()
        want = np.asarray(want).reshape(got.shape)
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        assert nan[1, 2] and nan.sum() == 1
        _bits_equal(got[~nan], want[~nan])
    _bits_equal(codes.numpy(), jcodes)
    assert not codes.numpy()[1, :, 2].any()


@pytest.mark.parametrize("bits", [1, 4, 8, 12])
def test_histogram_plain_matches_pallas_and_bincount(bits):
    nsym = 1 << bits
    rng = np.random.default_rng(bits)
    codes = rng.integers(-1, nsym + 1, size=(100, 5)).astype(np.int32)
    codes[::9, :] = nsym                                # padding sentinel
    got = histogram(torch.from_numpy(codes), nsym).numpy()
    want = np.asarray(histogram_pallas(jnp.asarray(codes), nsym,
                                       interpret=True)).T
    np.testing.assert_array_equal(got, want)
    for c in range(codes.shape[1]):
        col = codes[:, c]
        col = col[(col >= 0) & (col < nsym)]
        np.testing.assert_array_equal(got[c], np.bincount(col, minlength=nsym))


def test_channel_histogram_matches_jax():
    codes = np.random.default_rng(5).integers(0, 16, size=(2, 3, 4, 6))
    got = channel_histogram(codes.astype(np.uint8), 4)
    want = jax_channel_histogram(codes.astype(np.uint8), 4, interpret=True)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert channel_histogram(np.empty((0, 4), np.uint8), 8).shape == (4, 256)


@pytest.mark.parametrize("bits", [1, 8, 12])
@pytest.mark.parametrize("shape", [(256, 8), (4096, 5), (1000, 70)])
def test_cdf_plain_matches_pallas(bits, shape):
    counts = np.random.default_rng(bits).integers(
        0, 1 << bits, size=shape).astype(np.int32)
    got = cdf(torch.from_numpy(counts))
    assert got.dtype == torch.int32
    want = np.asarray(cdf_pallas(jnp.asarray(counts), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.cumsum(counts, axis=0) - counts)


@pytest.mark.parametrize("bits", [4, 8, 12])
def test_channel_histogram_cdf_matches_jax(bits):
    codes = np.random.default_rng(bits).integers(0, 1 << bits,
                                                 size=(2, 30, 7))
    got = channel_histogram_cdf(codes, bits, device="cpu")
    want = jax_channel_histogram_cdf(codes, bits, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64 and g.shape == (7, 1 << bits)
        np.testing.assert_array_equal(g, w)
    empty = channel_histogram_cdf(np.empty((0, 3), np.int32), 4,
                                  device="cpu")
    assert [e.shape for e in empty] == [(3, 16), (3, 16)]


@pytest.mark.parametrize("s,c", [(2, 1), (256, 64), (4096, 5)])
@pytest.mark.parametrize("out_layout", ["rows", "cols", None])
def test_cdf_on_transposed_views_matches_pallas(s, c, out_layout):
    """The cdf path's layout: the (S, C) view of the histogram's (C, S)
    counts, the CDF written through the (S, C) view of a (C, S) buffer
    (or a row-major one, or a new tensor)."""
    counts_cs = np.random.default_rng(s + c).integers(
        0, 1 << 12, size=(c, s)).astype(np.int32)
    view = torch.from_numpy(counts_cs).t()
    assert not view.is_contiguous() or s == 1 or c == 1
    out = {"rows": torch.full((s, c), -7, dtype=torch.int32),
           "cols": torch.full((c, s), -7, dtype=torch.int32).t(),
           None: None}[out_layout]
    got = cdf(view, out=out)
    assert out is None or got is out
    want = np.asarray(cdf_pallas(jnp.asarray(counts_cs.T), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cdf_refuses_an_output_of_another_shape():
    with pytest.raises(ValueError, match="out must be"):
        cdf(torch.zeros((8, 3), dtype=torch.int32),
            out=torch.zeros((3, 8), dtype=torch.int32))


def _cdf_kernel_model(counts, warps):
    """numpy model of csrc/cdf.cu for one channel: warp w scans symbols
    [256 w, 256 w + 256), lane l holds 8 from 256 w + 8 l; lane-local
    exclusive sums, shuffle scan of the 32 lane totals, totals of the warps
    before, all in uint32 (wrapping as int32 does)."""
    s = counts.shape[0]
    v = np.zeros(warps * thist.SEG_SYMBOLS, np.uint32)
    v[:s] = counts.astype(np.uint32)
    v = v.reshape(warps, 32, 8)
    lane_tot = v.sum(2, dtype=np.uint32)
    in_lane = np.cumsum(v, 2, dtype=np.uint32) - v
    in_warp = np.cumsum(lane_tot, 1, dtype=np.uint32) - lane_tot
    warp_tot = lane_tot.sum(1, dtype=np.uint32)
    before = np.cumsum(warp_tot, dtype=np.uint32) - warp_tot
    out = in_lane + in_warp[:, :, None] + before[:, None, None]
    return out.reshape(-1)[:s].view(np.int32)


@pytest.mark.parametrize("s", [1, 2, 7, 255, 256, 257, 4096, 8192])
def test_cdf_plan_covers_the_symbols(s):
    """The warps a channel takes cover S in 256-symbol segments, within a
    block's 32; the kernel's decomposition under that plan gives
    cumsum - counts exactly, the wrap of int32 included."""
    warps = thist.cdf_plan(s)
    assert 1 <= warps <= thist.MAX_CDF_WARPS
    assert (warps - 1) * thist.SEG_SYMBOLS < s <= warps * thist.SEG_SYMBOLS
    counts = np.random.default_rng(s).integers(0, 1 << 30, size=s,
                                               dtype=np.int64).astype(np.int32)
    want = cdf_plain(torch.from_numpy(counts)[:, None]).numpy()[:, 0]
    np.testing.assert_array_equal(_cdf_kernel_model(counts, warps), want)


@pytest.mark.parametrize("bits,dtype", [(3, np.uint8), (8, np.uint8),
                                        (12, np.uint16)])
def test_channel_histogram_cdf_uint_codes_match_jax(bits, dtype):
    """uint8 and uint16 codes reach the kernel as they are (no widening on
    the host); counts and CDF as the JAX package's."""
    codes = np.random.default_rng(bits).integers(
        0, 1 << bits, size=(3, 20, 6)).astype(dtype)
    c, flat = thist._host_codes(codes, 1 << bits)
    assert c == 6 and flat.dtype == torch.from_numpy(codes).dtype
    got = channel_histogram_cdf(codes, bits, device="cpu")
    want = jax_channel_histogram_cdf(codes, bits, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64 and g.shape == (6, 1 << bits)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int64, np.uint32])
def test_channel_histogram_cdf_counts_out_of_range_nowhere(dtype):
    """Other integer types are sent as int32 after a clip to [-1, nsym]:
    negative values and values >= nsym (2^32 + 3 too, which a cast to
    int32 would wrap to 3) are counted nowhere."""
    bits, nsym = 4, 16
    rng = np.random.default_rng(11)
    vals = rng.integers(0, nsym, size=(50, 3)).astype(np.int64)
    bad = {np.int8: [-1, -128, 16, 127], np.int16: [-1, -300, 16, 9000],
           np.int64: [-1, 16, 2**32 + 3, -(2**40)],
           np.uint32: [16, 2**31, 2**32 - 1, 99]}[dtype]
    codes = vals.copy()
    codes[:4, 1] = bad
    codes = codes.astype(dtype)
    c, flat = thist._host_codes(codes, nsym)
    assert flat.dtype == torch.int32
    counts, cum = channel_histogram_cdf(codes, bits, device="cpu")
    keep = codes.astype(np.int64)
    want = np.stack([np.bincount(col[(col >= 0) & (col < nsym)],
                                 minlength=nsym) for col in keep.T])
    np.testing.assert_array_equal(counts, want)
    np.testing.assert_array_equal(cum, np.cumsum(want, 1) - want)
    np.testing.assert_array_equal(channel_histogram(codes, bits), want)


@pytest.mark.parametrize("bits", [10, 16])
def test_consolidate_plain_wide_codes_match_ref(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(2, 100, 16)).astype(np.float32)
    codes, mins, maxs = quantize_fused(torch.from_numpy(x), bits)
    assert codes.dtype == torch.uint16
    est = x + rng.normal(size=x.shape).astype(np.float32) * 0.3
    got = consolidate_fused(torch.from_numpy(est.copy()), codes, mins, maxs,
                            bits)
    want = ref.consolidate_ref(jnp.asarray(est),
                               jnp.asarray(codes.numpy().astype(np.uint16)),
                               jnp.asarray(mins.numpy()),
                               jnp.asarray(maxs.numpy()), bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("bits", [3, 8])
@pytest.mark.parametrize("shape", [(1, 64, 8), (2, 512, 32), (2, 100, 16)])
def test_consolidate_plain_matches_pallas(bits, shape):
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    codes, mins, maxs = quantize_fused(torch.from_numpy(x), bits)
    est = x + rng.normal(size=shape).astype(np.float32) * 0.3
    r = shape[1]
    want = consolidate_pallas(jnp.asarray(est), jnp.asarray(codes.numpy()),
                              jnp.asarray(mins.numpy()),
                              jnp.asarray(maxs.numpy()), bits,
                              block_r=512 if r % 512 == 0 else r,
                              interpret=True)
    got = consolidate_fused(torch.from_numpy(est.copy()), codes, mins, maxs,
                            bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    rwant = ref.consolidate_ref(jnp.asarray(est), jnp.asarray(codes.numpy()),
                                jnp.asarray(mins.numpy()),
                                jnp.asarray(maxs.numpy()), bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(rwant), atol=1e-5,
                               rtol=0)


def test_consolidate_writes_only_selected_channels_in_place():
    rng = np.random.default_rng(8)
    z = rng.normal(size=(2, 40, 24)).astype(np.float32)
    sel = rng.permutation(24)[:8]
    codes, mins, maxs = quantize_fused(torch.from_numpy(z), 6,
                                       torch.from_numpy(sel.astype(np.int32)))
    est = z + rng.normal(size=z.shape).astype(np.float32)
    zt = torch.from_numpy(est.copy())
    out = consolidate_fused(zt, codes, mins, maxs, 6,
                            torch.from_numpy(sel.astype(np.int32)))
    assert out is zt
    want = est.copy()
    want[..., sel] = np.asarray(ref.consolidate_ref(
        jnp.asarray(est[..., sel]), jnp.asarray(codes.numpy()),
        jnp.asarray(mins.numpy()), jnp.asarray(maxs.numpy()), 6))
    np.testing.assert_allclose(zt.numpy(), want, atol=1e-5, rtol=0)
    rest = np.setdiff1d(np.arange(24), sel)
    np.testing.assert_array_equal(zt.numpy()[..., rest], est[..., rest])


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no quantize kernel"):
        quantize_fused(meta, 8)
    with pytest.raises(ValueError, match="no histogram kernel"):
        histogram(torch.empty((4, 4), dtype=torch.uint8, device="meta"), 256)
    with pytest.raises(ValueError, match="no cdf kernel"):
        cdf(torch.empty((4, 4), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no consolidate kernel"):
        consolidate_fused(meta, torch.empty((1, 4, 4), dtype=torch.uint8,
                                            device="meta"),
                          torch.empty((1, 4), dtype=torch.float16,
                                      device="meta"),
                          torch.empty((1, 4), dtype=torch.float16,
                                      device="meta"), 8)


def _assert_partition(spans, n):
    """[lo, hi) spans, empty ones dropped, cover [0, n) exactly once."""
    spans = sorted((lo, hi) for lo, hi in spans if hi > lo)
    at = 0
    for lo, hi in spans:
        assert lo == at, (lo, at)
        at = hi
    assert at == n


def _cluster_ok(cluster):
    return 1 <= cluster <= 16 and cluster & (cluster - 1) == 0


@pytest.mark.parametrize("k,c,nsym", [
    (4096, 64, 256), (32768, 64, 256), (4096, 64, 4096), (1000, 5, 16),
    (3, 5, 256), (4096, 5, 2), (1000, 70, 4096), (100, 1, 2), (0, 3, 256),
    (4096, 64, 1), (32768, 64, 4096)])
def test_histogram_plan_covers_rows_and_channels_once(k, c, nsym):
    """The histogram kernel's launch plan at the path's and the tests'
    shapes: every row and channel counted by exactly one block, every bin
    stored by exactly one block, and no block over 227 KB of shared
    memory."""
    plan = thist.histogram_plan(k, c, nsym)
    assert _cluster_ok(plan.cluster)
    assert 1 <= plan.group <= thist.MAX_GROUP
    assert plan.group & (plan.group - 1) == 0
    unit, share = plan.unit, plan.share
    assert unit == (4 if nsym % 4 == 0 else 1)
    # one histogram of the group, and the bins a block sums as every block
    # of the cluster stores them
    assert plan.smem_bytes == 4 * (plan.group * nsym
                                   + plan.cluster * share * unit)
    assert plan.smem_bytes <= thist.SMEM_MAX
    if plan.smem_bytes > thist.SMEM_MAX // 2:
        assert plan.cluster <= 8              # one block per SM: portable
    rpb = plan.rows_per_block
    _assert_partition([(q * rpb, min(k, (q + 1) * rpb))
                       for q in range(plan.cluster)], k)
    groups = -(-c // plan.group)
    _assert_partition([(g * plan.group, min(c, (g + 1) * plan.group))
                       for g in range(groups)], c)
    for g in range(groups):                   # the bins of one group
        n = min(plan.group, c - g * plan.group) * nsym // unit
        _assert_partition([(q * share, min(n, (q + 1) * share))
                           for q in range(plan.cluster)], n)


@pytest.mark.parametrize("b,r,c", [
    (1, 4096, 64), (8, 4096, 64), (1, 65536, 64), (1, 1, 64), (1, 7, 64),
    (1, 4095, 1), (1, 4096, 33), (2, 4096, 256), (3, 1000, 40), (1, 77, 33),
    (1, 65536, 1), (2, 16, 4), (1, 8192, 64), (1, 8193, 64)])
def test_quantize_plan_covers_rows_and_channels_once(b, r, c):
    """The quantize kernel's launch plan: each (example, channel group) is
    one cluster whose blocks split R exactly once; groups of the channel
    table take every channel once; a block that holds its rows keeps at
    most HOLD values a thread."""
    plan = tquant.quantize_plan(b, r, c)
    assert _cluster_ok(plan.cluster)
    assert 1 <= plan.group <= 8 and plan.group & (plan.group - 1) == 0
    rpb = plan.rows_per_block
    _assert_partition([(q * rpb, min(r, (q + 1) * rpb))
                       for q in range(plan.cluster)], r)
    cap = tquant.HOLD * tquant.THREADS // plan.group
    assert plan.held == (rpb <= cap)
    if r * plan.group <= tquant.MAX_CLUSTER * tquant.HOLD * tquant.THREADS:
        assert plan.held                      # the docstring's limit
    groups = -(-c // plan.group)
    assert groups * plan.group >= c > (groups - 1) * plan.group


@pytest.mark.parametrize("c", [1, 8, 33, 64, 256])
def test_channel_order_sorts_sel_by_column_of_x(c):
    """The quantize kernel's channel table: every output column once, each
    beside its own column of x, the rows sorted by column of x (equal
    columns, a channel selected twice, by position)."""
    sel = np.random.default_rng(c).integers(0, 256, size=c)
    table = tquant.channel_order(torch.from_numpy(sel.astype(np.int32)))
    assert table.dtype == torch.int32 and table.shape == (c, 2)
    assert table.is_contiguous()
    out, col = table[:, 0].numpy(), table[:, 1].numpy()
    np.testing.assert_array_equal(np.sort(out), np.arange(c))
    np.testing.assert_array_equal(col, sel[out])
    np.testing.assert_array_equal(
        out, np.lexsort((np.arange(c), sel)))   # by column, then position


def test_quantize_fused_takes_the_channel_table_on_cpu():
    """The plan hands the wrapper the table it computed once; on the CPU
    the plain version gives the same as without it, and a table without
    a selection is refused."""
    x = torch.from_numpy(_x(3, (2, 50, 24), 1.0, 0.0))
    sel = torch.tensor([5, 17, 5, 3, 0, 22], dtype=torch.int32)
    want = quantize_fused(x, 8, sel)
    got = quantize_fused(x, 8, sel, order=tquant.channel_order(sel))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="order"):
        quantize_fused(x, 8, order=tquant.channel_order(sel))
