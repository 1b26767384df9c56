"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: skipped where there is no CUDA device (decided inside the
fixture, so every pytest worker collects the same tests). Run on a machine
with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: quantize codes and side info, histogram counts and the CDF
must be exact (NaN side info at the same places, -0.0 and +0.0 told
apart); consolidation is held bit-identical (the kernel keeps the
reference's operation order, built with -fmad=false), with NaN where the
plain version has NaN. Flash attention: atol/rtol 2e-5 in float32 and 3e-2
in bf16 (the JAX kernel tests' tolerances; the kernel sums in another order and
rounds its output to bf16 once, as the plain version does; in bf16 it
feeds P to the tensor cores as a high and a low bf16 part). Linear scan: 1e-4 (float32 sums in
another order over 16-step chunks), NaN where the plain version has NaN.
"""
import contextlib
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import histogram as hist_kernel
from repro_torch.kernels import quantize as quant_kernel
from repro_torch.kernels.baf_conv import baf_conv
from repro_torch.kernels.consolidate import consolidate_fused, consolidate_plain
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.histogram import cdf, cdf_plain, histogram, \
    histogram_plain
from repro_torch.kernels.linear_scan import linear_scan, linear_scan_plain
from repro_torch.kernels.quantize import quantize_fused, quantize_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _x(rng, shape, scale, offset=0.0):
    return rng.normal(size=shape).astype(np.float32) * scale + offset


@pytest.mark.parametrize("bits", [2, 8, 12, 16])
@pytest.mark.parametrize("shape,c", [((2, 4096, 256), 64), ((3, 100, 40), 40),
                                     ((1, 77, 64), 33)])
@pytest.mark.parametrize("scale", [1.0, 1e-6, 1e5])
def test_quantize_kernel_matches_plain(cuda, bits, shape, c, scale):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_x(rng, shape, scale)).to(cuda)
    x[0, :, 0] = 0.25                                   # a constant channel
    sel = torch.from_numpy(rng.permutation(shape[-1])[:c].astype(np.int32))
    sel = sel.to(cuda)
    got = quantize_fused(x, bits, sel)
    torch.cuda.synchronize()
    want = quantize_plain(x, bits, sel.long())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


def _bits(t):
    """Integer view for exact comparison (fp16 and uint16 as int16)."""
    return t if t.dtype == torch.uint8 else t.view(torch.int16)


def test_quantize_kernel_propagates_nan(cuda):
    """A NaN makes its (example, channel) side info NaN and its codes 0,
    as jnp.min/max and the plain version give; other channels unchanged."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_x(rng, (2, 16, 4), 1.0)).to(cuda)
    x[1, 3, 2] = float("nan")
    for bits in (8, 12):
        got = quantize_fused(x, bits)
        want = quantize_plain(x, bits)
        torch.cuda.synchronize()
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            assert bool(torch.isnan(g[1, 2])) and int(torch.isnan(g).sum()) == 1
            keep = ~torch.isnan(w)
            assert torch.equal(_bits(g)[keep], _bits(w)[keep])
        assert torch.equal(got[0], want[0])
        assert int(got[0][1, :, 2].to(torch.int32).abs().sum()) == 0


@pytest.mark.parametrize("r", [1, 7, 4095, 65536])
@pytest.mark.parametrize("c", [1, 33, 64])
def test_quantize_kernel_edge_shapes(cuda, r, c):
    """R of one row, of 7, not a multiple of the cluster's blocks (4095),
    and beyond what the blocks hold in registers (65536: its rows are read
    twice); C of one channel and C not a multiple of the channel group."""
    rng = np.random.default_rng(r + c)
    p = 256
    x = torch.from_numpy(_x(rng, (1, r, p), 2.0, 0.5)).to(cuda)
    sel = torch.from_numpy(rng.permutation(p)[:c].astype(np.int32)).to(cuda)
    for bits in (8, 12):
        got = quantize_fused(x, bits, sel)
        torch.cuda.synchronize()
        want = quantize_plain(x, bits, sel.long())
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("r", [1, 7, 100])
def test_quantize_kernel_cluster_wider_than_its_rows(cuda, r):
    """A plan the wrapper does not pick, through ``_launch``: 16 blocks a
    cluster over R < 16 rows (blocks without rows still send their
    partials) and over R not a multiple of 16."""
    rng = np.random.default_rng(r)
    x = torch.from_numpy(_x(rng, (2, r, 64), 1.0)).to(cuda)
    sel = torch.from_numpy(rng.permutation(64)[:20].astype(np.int32))
    sel = sel.to(cuda)
    plan = quant_kernel.QuantizePlan(8, 16, -(-r // 16), True)
    got = quant_kernel._launch(x, 8, quant_kernel.channel_order(sel), plan)
    torch.cuda.synchronize()
    for g, w in zip(got, quantize_plain(x, 8, sel.long())):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("bits", [8, 12])
def test_quantize_kernel_channels_selected_twice(cuda, bits):
    """sel naming a channel of x more than once: each of its c gets the
    same side info and codes, as the plain gather gives (the channel table
    ranks equal indices by position)."""
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(_x(rng, (2, 1000, 40), 1.0)).to(cuda)
    sel = torch.tensor([5, 17, 5, 39, 0, 17, 5, 22], dtype=torch.int32,
                       device=cuda)
    for plan in (quant_kernel.quantize_plan(2, 1000, 8),
                 quant_kernel.QuantizePlan(4, 16, 63, True)):
        got = quant_kernel._launch(x, bits, quant_kernel.channel_order(sel),
                                   plan)
        torch.cuda.synchronize()
        for g, w in zip(got, quantize_plain(x, bits, sel.long())):
            assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("short", ["rows", "bins", "shared memory"])
def test_kernels_refuse_plans_short_of_their_rows(cuda, short):
    """A plan whose blocks do not cover every row, every bin, or whose
    shared memory does not hold what its bins need, is refused by the
    kernel's entry (KernelError), not run on part of the input."""
    x = torch.ones((1, 100, 8), device=cuda)
    if short == "rows":
        with pytest.raises(_build.KernelError):
            quant_kernel._launch(x, 8, None,
                                 quant_kernel.QuantizePlan(8, 4, 10, True))
    codes = torch.zeros((100, 8), dtype=torch.uint8, device=cuda)
    plan = hist_kernel._plan(100, 256, 4, 4)
    plan = {"rows": plan._replace(rows_per_block=10),
            "bins": plan._replace(share=plan.share - 1),
            "shared memory": plan._replace(smem_bytes=plan.smem_bytes - 4),
            }[short]
    with pytest.raises(_build.KernelError):
        hist_kernel._launch(codes, 256, plan)


def test_quantize_kernel_takes_every_channel_without_sel(cuda):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_x(rng, (2, 4096, 256), 1.0)).to(cuda)
    for bits in (8, 12):
        got = quantize_fused(x, bits)
        torch.cuda.synchronize()
        for g, w in zip(got, quantize_plain(x, bits)):
            assert torch.equal(_bits(g), _bits(w))


def test_quantize_kernel_orders_signed_zeros_like_jnp(cuda):
    """Channels of exact zeros of both signs, in both orders: the kernel's
    side info and codes equal the plain version's on the CPU (which the CPU
    tests hold to jnp.min/jnp.max): the min of a channel holding -0.0 and
    no negative value is -0.0 (fp16 0x8000)."""
    rng = np.random.default_rng(8)
    r, p = 4096, 256
    x = _x(rng, (2, r, p), 1.0)
    x[:, :, 0] = 0.0
    x[:, 5::2, 0] = -0.0                         # +0 first, then -0
    x[:, :, 1] = -0.0
    x[:, 3::4, 1] = 0.0                          # -0 first
    x[:, :, 2] = 0.0                             # all +0
    x[:, :, 3] = -0.0                            # all -0
    x[:, :, 4] = np.abs(x[:, :, 4])
    x[1, 4000, 4] = -0.0                         # one -0 late among positives
    sel = np.array([4, 0, 1, 2, 3] + list(range(100, 159)), np.int32)
    xt = torch.from_numpy(x)
    for bits in (8, 12):
        got = quantize_fused(xt.to(cuda), bits, torch.from_numpy(sel).to(cuda))
        torch.cuda.synchronize()
        want = quantize_plain(xt, bits, torch.from_numpy(sel).long())
        for g, w in zip(got, want):
            assert torch.equal(_bits(g.cpu()), _bits(w))
        mins = got[1].cpu().view(torch.int16).to(torch.int32) & 0xFFFF
        assert (mins[:, 1] == 0x8000).all() and (mins[:, 2] == 0x8000).all()
        assert int(mins[1, 0]) == 0x8000 and (mins[:, 3] == 0).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32])
@pytest.mark.parametrize("kind", ["single", "peaked"])
@pytest.mark.parametrize("shape", [(4096, 64), (3, 5), (1000, 5),
                                   (32768, 64)])
def test_histogram_kernel_hot_bins(cuda, dtype, kind, shape):
    """One symbol everywhere, and codes heaped on a few symbols (most of a
    warp's codes land on one bin); K below the cluster (3 rows) and C=5."""
    rng = np.random.default_rng(4)
    nsym = 256 if dtype == np.uint8 else 4096
    if kind == "single":
        v = np.full(shape, 17, np.int64)
    else:
        v = np.minimum(rng.geometric(0.6, size=shape) - 1 + 100, nsym - 1)
    codes = torch.from_numpy(v.astype(dtype)).to(cuda)
    got = histogram(codes, nsym)
    torch.cuda.synchronize()
    want = histogram_plain(codes, nsym)
    assert torch.equal(got, want)
    assert int(got.sum()) == shape[0] * shape[1]


@pytest.mark.parametrize("dtype,nsym", [(np.uint8, 256), (np.int32, 4096)])
@pytest.mark.parametrize("k", [3, 100])
def test_histogram_kernel_cluster_wider_than_its_rows(cuda, dtype, nsym, k):
    """16 blocks a cluster over K < 16 rows, and over K not a multiple of
    16, through ``_launch``: blocks without rows still send their (zero)
    bins."""
    rng = np.random.default_rng(k)
    codes = torch.from_numpy(rng.integers(0, nsym, size=(k, 6))
                             .astype(dtype)).to(cuda)
    group = 4 if nsym == 256 else 2
    plan = hist_kernel._plan(k, nsym, group, 16)
    got = hist_kernel._launch(codes, nsym, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, histogram_plain(codes, nsym))


@pytest.mark.parametrize("bits", [1, 4, 8, 12])
@pytest.mark.parametrize("shape", [(4096, 64), (1000, 5), (32768, 64)])
@pytest.mark.parametrize("wide", [False, True])
def test_histogram_kernel_matches_plain(cuda, bits, shape, wide):
    rng = np.random.default_rng(1)
    nsym = 1 << bits
    if wide:
        codes = torch.from_numpy(
            rng.integers(0, nsym, size=shape).astype(np.uint16)).to(cuda)
    elif bits <= 8:
        codes = torch.from_numpy(
            rng.integers(0, nsym, size=shape).astype(np.uint8)).to(cuda)
    else:
        v = rng.integers(-2, nsym + 2, size=shape).astype(np.int32)
        v[::7] = nsym                                    # padding sentinel
        codes = torch.from_numpy(v).to(cuda)
    got = histogram(codes, nsym)
    torch.cuda.synchronize()
    assert torch.equal(got, histogram_plain(codes, nsym))


@pytest.mark.parametrize("bits", [3, 8, 12, 16])
@pytest.mark.parametrize("shape,c", [((8, 4096, 256), 64), ((2, 100, 64), 64)])
def test_consolidate_kernel_matches_plain(cuda, bits, shape, c):
    rng = np.random.default_rng(2)
    z = torch.from_numpy(_x(rng, shape, 2.0)).to(cuda)
    sel = torch.from_numpy(rng.permutation(shape[-1])[:c].astype(np.int32))
    sel = sel.to(cuda)
    codes, mins, maxs = quantize_plain(z, bits, sel.long())
    est = z + torch.from_numpy(_x(rng, shape, 0.3)).to(cuda)
    want = consolidate_plain(est.clone(), codes, mins, maxs, bits, sel.long())
    got = consolidate_fused(est.clone(), codes, mins, maxs, bits, sel)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _same_bits_or_nan(got, want):
    """NaN at the same places, the same bits everywhere else."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


@pytest.mark.parametrize("bits", [8, 12])           # uint8 and uint16 codes
@pytest.mark.parametrize("case", ["z", "side", "both"])
@pytest.mark.parametrize("table", ["given", "omitted"])
def test_consolidate_kernel_propagates_nan(cuda, case, bits, table):
    """NaN in z~ with finite side info, NaN side info (min and max, as the
    quantizer writes them), or both: NaN where the plain version
    (torch.maximum/minimum, like jnp.clip) has NaN, the same bits
    elsewhere; with the plan's channel table given or computed by the
    wrapper."""
    rng = np.random.default_rng(6)
    b, r, p, c = 2, 300, 64, 20
    z = torch.from_numpy(_x(rng, (b, r, p), 1.5)).to(cuda)
    sel = torch.from_numpy(rng.permutation(p)[:c].astype(np.int32)).to(cuda)
    codes, mins, maxs = quantize_plain(z, bits, sel.long())
    est = z + torch.from_numpy(_x(rng, (b, r, p), 0.4)).to(cuda)
    if case in ("z", "both"):
        est[0, 17, sel[3]] = float("nan")
        est[1, :5, sel[11]] = float("nan")
        est[1, 9, sel[7]] = float("nan")      # where the side info is NaN
        est[0, 4, int(np.setdiff1d(np.arange(p), sel.cpu())[0])] = \
            float("nan")                         # an unselected channel
    if case in ("side", "both"):
        mins[1, 7] = maxs[1, 7] = float("nan")
    want = consolidate_plain(est.clone(), codes, mins, maxs, bits,
                             sel.long())
    kw = {"order": quant_kernel.channel_order(sel)} if table == "given" \
        else {}
    got = consolidate_fused(est.clone(), codes, mins, maxs, bits, sel, **kw)
    torch.cuda.synchronize()
    assert int(torch.isnan(want).sum()) == \
        {"z": 8, "side": r, "both": r + 7}[case]
    _same_bits_or_nan(got, want)


@pytest.mark.parametrize("bits", [3, 8, 12, 16])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("r", [1, 7, 4095])
@pytest.mark.parametrize("c", [1, 33, 64, 256])
def test_consolidate_kernel_edge_shapes(cuda, c, r, b, bits):
    """C of one channel, not a multiple of a warp, the path's 64 and all P
    (with sel_idx=None and with a full permutation); R of one row, of 7,
    and not a multiple of the plan's tile; B of one and eight; codes of
    3, 8, 12 and 16 bits. Bit-identical to the plain version, with the
    channel table given and omitted."""
    p = 256
    gen = torch.Generator().manual_seed(c * 131 + r * 7 + b + bits)
    z = (torch.randn((b, r, p), generator=gen) * 2.0).to(cuda)
    noise = (torch.randn((b, r, p), generator=gen) * 0.3).to(cuda)
    sels = [torch.randperm(p, generator=gen)[:c].to(torch.int32).to(cuda)]
    if c == p:
        sels.append(None)
    for sel in sels:
        sel64 = None if sel is None else sel.long()
        codes, mins, maxs = quantize_plain(z, bits, sel64)
        est = z + noise
        want = consolidate_plain(est.clone(), codes, mins, maxs, bits, sel64)
        tables = [{}] if sel is None else \
            [{}, {"order": quant_kernel.channel_order(sel)}]
        for kw in tables:
            got = consolidate_fused(est.clone(), codes, mins, maxs, bits, sel,
                                    **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_consolidate_refuses_a_wrong_channel_table(cuda):
    z = torch.zeros((1, 8, 16), device=cuda)
    sel = torch.arange(4, dtype=torch.int32, device=cuda)
    codes = torch.zeros((1, 8, 4), dtype=torch.uint8, device=cuda)
    side = torch.zeros((1, 4), dtype=torch.float16, device=cuda)
    before = _build.CONSOLIDATE.launches
    for bad in (quant_kernel.channel_order(sel)[:3],
                quant_kernel.channel_order(sel).long(),
                quant_kernel.channel_order(sel).t()):
        with pytest.raises(ValueError, match="order"):
            consolidate_fused(z, codes, side, side, 8, sel, order=bad)
    assert _build.CONSOLIDATE.launches == before


@pytest.mark.parametrize("bad", ["j_high", "j_negative", "p_high",
                                 "p_negative"])
def test_consolidate_skips_a_table_entry_out_of_range(cuda, bad):
    """A channel table of the right shape with one entry whose output
    column or column of z is out of range: the kernel skips that entry
    (its column of z keeps its values), clips the others as the plain
    version does, and writes nothing past z."""
    gen = torch.Generator().manual_seed(17)
    b, r, p, bits = 2, 7, 16, 8
    sel = torch.tensor([9, 2, 14, 5], dtype=torch.int32, device=cuda)
    c = sel.numel()
    z0 = (torch.randn((b, r, p), generator=gen) * 2.0).to(cuda)
    codes, mins, maxs = quantize_plain(z0, bits, sel.long())
    buf = torch.randn((b * r * p + 64,), generator=gen).to(cuda)
    buf[:b * r * p] = (z0 + 0.3 * torch.randn((b, r, p), generator=gen)
                       .to(cuda)).view(-1)
    est = buf[:b * r * p].view(b, r, p)
    guard = buf[b * r * p:].clone()
    order = quant_kernel.channel_order(sel).clone()
    k = 1
    j0 = int(order[k, 0])
    order[k, {"j_high": 0, "j_negative": 0, "p_high": 1,
              "p_negative": 1}[bad]] = \
        {"j_high": c + 5, "j_negative": -1, "p_high": p + 3,
         "p_negative": -2}[bad]
    keep = [j for j in range(c) if j != j0]
    want = consolidate_plain(est.clone(), codes[..., keep].contiguous(),
                             mins[:, keep].contiguous(),
                             maxs[:, keep].contiguous(), bits,
                             sel.long()[keep])
    got = consolidate_fused(est, codes, mins, maxs, bits, sel, order=order)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(buf[b * r * p:], guard)


@pytest.mark.parametrize("bad", ["j_high", "j_negative", "p_high",
                                 "p_negative"])
def test_quantize_skips_a_table_entry_out_of_range(cuda, bad):
    """A channel table of the right shape with one entry whose output
    column (C or -1) or column of x (P or -1) is out of range: the kernel
    skips that entry, and every other output column's codes, mins and maxs
    equal the plain version's bit for bit. A kernel that followed the
    output column would write row r+-1 of a valid column."""
    gen = torch.Generator().manual_seed(19)
    b, r, p, bits = 2, 64, 32, 8
    sel = torch.tensor([9, 2, 14, 5, 30, 21], dtype=torch.int32, device=cuda)
    c = sel.numel()
    x = torch.randn((b, r, p), generator=gen).to(cuda)
    order = quant_kernel.channel_order(sel).clone()
    k = 1
    j0 = int(order[k, 0])
    field, value = {"j_high": (0, c), "j_negative": (0, -1),
                    "p_high": (1, p), "p_negative": (1, -1)}[bad]
    order[k, field] = value
    got = quantize_fused(x, bits, sel, order=order)
    torch.cuda.synchronize()
    want = quantize_plain(x, bits, sel.long())
    keep = [j for j in range(c) if j != j0]
    for g, w in zip(got, want):
        assert torch.equal(g[..., keep].view(torch.uint8),
                           w[..., keep].view(torch.uint8))


@pytest.mark.parametrize("s", [2, 256, 4096])
@pytest.mark.parametrize("c", [1, 5, 64])
@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("out_layout", ["rows", "cols"])
def test_cdf_kernel_layouts(cuda, s, c, layout, out_layout):
    """Counts (S, C) row-major or the (S, C) view of a (C, S) buffer (the
    histogram's layout), into either; exact against the plain version,
    sums that wrap int32 included (S = 4096 counts up to 2^20)."""
    rng = np.random.default_rng(s * 7 + c)
    counts = torch.from_numpy(rng.integers(0, 1 << 20, size=(s, c))
                              .astype(np.int32)).to(cuda)
    if layout == "cols":
        counts = counts.t().contiguous().t()
    out = torch.full((s, c), -1, dtype=torch.int32, device=cuda) \
        if out_layout == "rows" else \
        torch.full((c, s), -1, dtype=torch.int32, device=cuda).t()
    before = _build.CDF.launches
    got = cdf(counts, out=out)
    torch.cuda.synchronize()
    assert got is out and _build.CDF.launches == before + 1
    assert torch.equal(got, cdf_plain(counts))
    assert torch.equal(cdf(counts), cdf_plain(counts))


def test_cdf_refuses_layouts_it_does_not_take(cuda):
    counts = torch.ones((512, 8), dtype=torch.int32, device=cuda)
    before = _build.CDF.launches
    with pytest.raises(ValueError, match="layout|row-major"):
        cdf(counts[::2])                       # symbols two rows apart
    with pytest.raises(ValueError, match="overlaps"):
        cdf(counts, out=counts)
    with pytest.raises(ValueError, match="S <="):
        cdf(torch.ones((8193, 2), dtype=torch.int32, device=cuda))
    assert _build.CDF.launches == before


@pytest.mark.parametrize("bits,dtype", [(8, np.uint8), (12, np.uint16),
                                        (4, np.int64)])
def test_channel_histogram_cdf_on_the_card(cuda, bits, dtype):
    """The cdf path on the card: one histogram and one cdf launch, counts
    and CDF equal to the plain versions on the CPU."""
    codes = np.random.default_rng(bits).integers(
        0, 1 << bits, size=(1, 64, 64, 64)).astype(dtype)
    before = (_build.HISTOGRAM.launches, _build.CDF.launches)
    got = hist_kernel.channel_histogram_cdf(codes, bits, device=cuda)
    assert (_build.HISTOGRAM.launches, _build.CDF.launches) == \
        (before[0] + 1, before[1] + 1)
    want = hist_kernel.channel_histogram_cdf(codes, bits, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bits", [8, 12])
@pytest.mark.parametrize("shape", [(256, 64), (4096, 64), (4096, 5),
                                   (1000, 70)])
def test_cdf_kernel_matches_plain(cuda, bits, shape):
    rng = np.random.default_rng(3)
    counts = torch.from_numpy(rng.integers(0, 1 << bits, size=shape)
                              .astype(np.int32)).to(cuda)
    got = cdf(counts)
    torch.cuda.synchronize()
    assert torch.equal(got, cdf_plain(counts))


FLASH_CASES = [
    # B, Sq, Sk, H, KH, hd, causal, window
    (2, 512, 512, 28, 4, 128, True, None),      # qwen2-7b prefill, GQA 7
    (1, 256, 256, 4, 4, 64, True, None),        # g = 1, hd 64
    (2, 200, 200, 8, 2, 64, True, None),        # ragged S
    (1, 128, 128, 4, 2, 128, False, None),      # non-causal
    (1, 300, 300, 4, 1, 64, True, 100),         # window
    (1, 64, 256, 7, 1, 128, True, None),        # Sq < Sk (chunked prefill)
    (2, 77, 131, 4, 2, 16, True, 33),           # ragged, window, Sq < Sk
    (1, 96, 96, 2, 2, 32, False, 40),           # window, not causal
    (2, 1500, 1500, 6, 6, 64, False, None),     # whisper encoder
    (2, 448, 1500, 6, 6, 64, False, None),      # whisper cross-attention
    (2, 200, 200, 8, 2, 8, True, None),         # hd 8 (qwen2-72b smoke)
    (1, 77, 131, 4, 4, 8, True, 33),            # hd 8, ragged, window
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    b, sq, sk, h, kh, hd, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, sq, h, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, sk, kh, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, sk, kh, hd), generator=g, device=cuda).to(dtype)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_kernel_reads_strided_inputs(cuda):
    """q, k, v sliced out of one fused projection, not contiguous."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((2, 130, 4 + 2 + 2, 64), generator=g, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v),
                               atol=2e-5, rtol=2e-5)


def test_flash_bf16_kernel_reads_strided_inputs(cuda):
    """bf16 q, k, v sliced out of one fused projection: the tensor-core
    kernel reads them in place through their 16-byte-aligned strides."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((2, 130, 4 + 2 + 2, 64), generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("shape", [(2, 200, 200, 8, 2, True, None),
                                   (1, 77, 131, 4, 4, True, 50),
                                   (1, 128, 64, 2, 1, False, None)])
def test_flash_bf16_tensor_cores_every_head_dim(cuda, hd, shape):
    """Every head dim through the wgmma kernel: one 128B swizzle for all,
    lines padded to 64 values below hd 64."""
    b, sq, sk, h, kh, causal, window = shape
    g = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn((b, s, n, hd), generator=g, device=cuda)
               .to(torch.bfloat16) for s, n in ((sq, h), (sk, kh), (sk, kh)))
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("shape", [(2, 200, 200, 8, 2, True, None),
                                   (1, 77, 131, 4, 4, True, 50),
                                   (1, 130, 70, 6, 2, False, None),
                                   (1, 97, 97, 2, 1, False, 33)])
def test_flash_f32_tensor_cores_every_head_dim(cuda, hd, shape):
    """Every head dim through the float32 mma.sync kernel (3xTF32), causal,
    windowed and GQA, with Sq and Sk off the 16-row warp tiles and the
    64- and 32-key kv tiles: one launch a call, 2e-5."""
    b, sq, sk, h, kh, causal, window = shape
    g = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn((b, s, n, hd), generator=g, device=cuda)
               for s, n in ((sq, h), (sk, kh), (sk, kh)))
    before = _build.FLASH_ATTENTION.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("which", ["q", "k", "v", "all"])
def test_flash_f32_reads_misaligned_inputs(cuda, hd, which):
    """float32 q, k or v whose base is 4 bytes off a 16-byte boundary, or
    whose strides are not multiples of 16 bytes: the kernel copies K and V
    4 bytes at a time there, and still launches once, 2e-5."""
    g = torch.Generator(device=cuda).manual_seed(hd)
    shape = (2, 150, 4, hd)

    def aligned():
        return torch.randn(shape, generator=g, device=cuda)

    def shifted():                      # base 4 bytes off
        flat = torch.randn(1 + math.prod(shape), generator=g, device=cuda)
        return flat[1:].view(shape)

    def padded():                       # head stride hd + 1 elements
        return torch.randn(shape[:3] + (hd + 1,), generator=g,
                           device=cuda)[..., :hd]

    q, k, v = aligned(), aligned(), aligned()
    if which == "all":
        q, k, v = shifted(), padded(), shifted()
    elif which == "q":
        q = shifted()
    elif which == "k":
        k = shifted()
    else:
        v = padded()
    before = _build.FLASH_ATTENTION.launches
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION.launches == before + 1
    torch.testing.assert_close(got, flash_attention_plain(q, k, v),
                               atol=2e-5, rtol=2e-5)


def test_flash_f32_propagates_nan_at_the_detect_heads_shape(cuda):
    """One NaN in a q row, a k row and a v row at the detect head's shape
    (not causal): NaN exactly where the plain version has it (the q row's
    output row, every row of the k row's (b, head), the v entry's column
    of its (b, head)), the rest within 2e-5."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((8, 4096, 2, 16), generator=g, device=cuda)
               for _ in range(3))
    q[1, 100, 0, 3] = float("nan")
    k[3, 2000, 1, 7] = float("nan")
    v[5, 4095, 0, 12] = float("nan")
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=False)
    assert bool(want.isnan().any())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5,
                               equal_nan=True)


def test_flash_bf16_refuses_unaligned_inputs(cuda):
    """A base or a stride that is not a multiple of 16 bytes raises, and
    nothing is launched: no other kernel and no plain version takes over."""
    g = torch.Generator(device=cuda).manual_seed(2)
    flat = torch.randn(1 + 64 * 2 * 64, generator=g, device=cuda)
    flat = flat.to(torch.bfloat16)
    shifted = flat[1:].view(1, 64, 2, 64)           # base 2 bytes off
    ok = flat[:-1].view(1, 64, 2, 64)
    padded = torch.randn((1, 64, 2, 68), generator=g, device=cuda) \
        .to(torch.bfloat16)[..., :64]               # head stride 136 bytes
    before = _build.FLASH_ATTENTION.launches
    for q, k, v in ((shifted, ok, ok), (ok, shifted, ok), (ok, ok, padded),
                    (padded, ok, ok)):
        with pytest.raises(ValueError, match="16"):
            flash_attention(q, k, v, causal=True)
    assert _build.FLASH_ATTENTION.launches == before


SCAN_CASES = [
    # B, S, H, dk, dv, chunk, mode, per-channel decay, bonus, initial state
    (2, 512, 40, 64, 64, 16, "rwkv", True, True, False),   # rwkv6-3b prefill
    (2, 1024, 40, 64, 64, 16, "rwkv", True, True, True),   # its ingest block
    (2, 64, 4, 16, 16, 8, "rwkv", True, True, True),       # smoke width
    (1, 96, 3, 32, 48, 16, "rwkv", True, False, False),
    (2, 128, 4, 64, 64, 16, "ssm", False, False, True),    # scalar decay
    (1, 64, 2, 16, 40, 8, "ssm", True, False, False),      # ragged dv tile
    (2, 512, 64, 64, 64, 128, "ssm", False, False, False), # zamba2 prefill
    (2, 4096, 64, 64, 64, 128, "ssm", False, False, True), # its ingest block
    # chunk 128 on the tensor cores: both modes, both decays, with and
    # without an initial state, compiled and generic dims, a chunk that
    # is not a multiple of the 16-row tiles
    (2, 512, 8, 64, 64, 128, "ssm", True, False, False),
    (2, 512, 8, 64, 64, 128, "ssm", True, False, True),
    (2, 512, 8, 64, 64, 128, "rwkv", True, True, True),
    (2, 256, 4, 64, 64, 128, "rwkv", False, True, False),
    (2, 256, 4, 64, 64, 128, "rwkv", True, False, False),
    (1, 256, 3, 32, 48, 128, "ssm", True, False, True),
    (1, 256, 3, 72, 136, 128, "rwkv", True, True, True),
    (1, 256, 2, 128, 128, 128, "rwkv", True, True, True),   # dk = 128
    (1, 200, 2, 24, 40, 100, "rwkv", True, True, True),
    (1, 200, 2, 24, 40, 100, "ssm", False, False, False),
    # dk and dv not multiples of 8: pass A's element-wise loads and pads
    (1, 256, 3, 20, 12, 128, "ssm", True, False, True),
    (2, 256, 2, 20, 12, 128, "ssm", False, False, False),
    (1, 256, 3, 20, 12, 128, "rwkv", True, True, False),
    (1, 256, 2, 20, 12, 128, "rwkv", False, True, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_linear_scan_kernel_matches_plain(cuda, dtype, case):
    b, s, h, dk, dv, chunk, mode, per_channel, bonus, init = case
    g = torch.Generator(device=cuda).manual_seed(2)

    def rnd(*shape, scale=0.5):
        return torch.randn(shape, generator=g, device=cuda) * scale

    q, k = rnd(b, s, h, dk).to(dtype), rnd(b, s, h, dk).to(dtype)
    v = rnd(b, s, h, dv, scale=1.0).to(dtype)
    ld = -torch.exp(rnd(b, s, h, dk if per_channel else 1) - 1.0)
    u = rnd(h, dk) if bonus else None
    s0 = rnd(b, h, dk, dv) if init else None
    got = linear_scan(q, k, v, ld, bonus=u, initial_state=s0, chunk=chunk,
                      mode=mode)
    torch.cuda.synchronize()
    want = linear_scan_plain(q, k, v, ld, bonus=u, initial_state=s0,
                             chunk=chunk, mode=mode)
    for gt, wt in zip(got, want):
        assert gt.dtype == torch.float32 and gt.shape == wt.shape
        torch.testing.assert_close(gt, wt, atol=1e-4, rtol=1e-4)


OVERFLOW_CASES = [
    # B, S, H, dk, dv, chunk, mode, per-channel decay, bonus
    (2, 64, 3, 32, 16, 32, "rwkv", True, True),
    (2, 256, 4, 64, 64, 128, "ssm", False, False),     # zamba2's layout
    (1, 256, 3, 64, 64, 128, "rwkv", True, True),
    (1, 256, 3, 20, 12, 128, "ssm", True, False),      # element-wise loads
    (1, 256, 2, 20, 12, 128, "rwkv", False, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", OVERFLOW_CASES)
def test_linear_scan_kernel_overflows_like_plain(cuda, dtype, case):
    """Every decay at the clamp (-4): exp(-la) overflows and exp(la)
    underflows; the kernel keeps the factorisation, so its NaNs stand
    exactly where the plain version's do. At chunk 128 a masked inf * 0
    makes whole rows NaN in the plain version: the tensor-core pass must
    form the tiles above the diagonal of such a chunk too."""
    b, s, h, dk, dv, chunk, mode, per_channel, bonus = case
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k = (torch.randn((b, s, h, dk), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=g, device=cuda).to(dtype)
    ld = torch.full((b, s, h, dk if per_channel else 1), -4.0, device=cuda)
    u = torch.randn((h, dk), generator=g, device=cuda) if bonus else None
    got = linear_scan(q, k, v, ld, bonus=u, chunk=chunk, mode=mode)
    torch.cuda.synchronize()
    want = linear_scan_plain(q, k, v, ld, bonus=u, chunk=chunk, mode=mode)
    assert not bool(torch.isfinite(want[0]).all())
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, atol=1e-4, rtol=1e-4,
                                   equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["ssm", "rwkv"])
@pytest.mark.parametrize("overflow", [False, True])
def test_linear_scan_kernel_misaligned_inputs_match_plain(cuda, dtype, mode,
                                                          overflow):
    """Chunk 128 with q, k, v and the per-channel decay contiguous views
    one element past a 16-byte boundary: pass A takes its element-wise
    loads; within 1e-4 of the plain version, and at the clamp with NaN at
    the plain version's positions."""
    b, s, h, dk, dv = 1, 256, 2, 64, 64
    g = torch.Generator(device=cuda).manual_seed(12)

    def shifted(shape, scale, dt):
        flat = torch.randn(1 + math.prod(shape), generator=g, device=cuda)
        return (flat * scale).to(dt)[1:].view(shape)

    q, k = (shifted((b, s, h, dk), 0.5, dtype) for _ in range(2))
    v = shifted((b, s, h, dv), 1.0, dtype)
    ld = shifted((b, s, h, dk), 0.5, torch.float32)
    ld = ld.fill_(-4.0) if overflow else ld.sub_(1.0).exp_().neg_()
    u = torch.randn((h, dk), generator=g, device=cuda) * 0.5 \
        if mode == "rwkv" else None
    assert all(t.is_contiguous() and t.data_ptr() % 16
               for t in (q, k, v, ld))
    got = linear_scan(q, k, v, ld, bonus=u, chunk=128, mode=mode)
    torch.cuda.synchronize()
    want = linear_scan_plain(q, k, v, ld, bonus=u, chunk=128, mode=mode)
    assert bool(torch.isfinite(want[0]).all()) != overflow
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, atol=1e-4, rtol=1e-4,
                                   equal_nan=True)


def test_linear_scan_kernel_overflow_in_one_chunk(cuda):
    """Chunk 128, one chunk of four at the clamp: that chunk forms every
    tile (NaN as the plain version), the others skip the tiles above the
    diagonal; all within 1e-4 of the plain version."""
    b, s, h, dk, dv = 1, 512, 4, 64, 64
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k = (torch.randn((b, s, h, dk), generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=g, device=cuda) \
        .to(torch.bfloat16)
    ld = -torch.exp(torch.randn((b, s, h, 1), generator=g, device=cuda)
                    - 2.0)
    ld[:, 256:384] = -4.0
    got = linear_scan(q, k, v, ld, chunk=128, mode="ssm")
    torch.cuda.synchronize()
    want = linear_scan_plain(q, k, v, ld, chunk=128, mode="ssm")
    nan = torch.isnan(want[0])
    assert bool(nan[:, 256:384].all()) and not bool(nan[:, :256].any())
    assert torch.equal(torch.isnan(got[0]), nan)
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, atol=1e-4, rtol=1e-4,
                                   equal_nan=True)


def test_linear_scan_refuses_dk_over_128(cuda):
    """The carry pass holds at most 128 state rows a block: a wider dk
    raises before any launch."""
    q = torch.ones((1, 16, 1, 136), device=cuda)
    v = torch.ones((1, 16, 1, 8), device=cuda)
    before = _build.LINEAR_SCAN.launches
    with pytest.raises(ValueError, match="dk <= 128"):
        linear_scan(q, q, v, -q, chunk=16)
    assert _build.LINEAR_SCAN.launches == before


def test_linear_scan_refuses_per_channel_decay_at_chunk_128(cuda):
    """A per-channel decay at chunk 128 and dk = dv = 64 now fits the
    tensor-core pass (107,024 B of shared memory): one launch, within 1e-4
    of the plain version. What still does not fit a block's shared memory
    at that chunk (dk = 128 with dv = 512) raises before any launch."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((1, 128, 1, 64), generator=g, device=cuda) * 0.5
    ld = -torch.exp(torch.randn((1, 128, 1, 64), generator=g,
                                device=cuda) * 0.5 - 2.0)
    before = _build.LINEAR_SCAN.launches
    got = linear_scan(q, q, q, ld, chunk=128, mode="ssm")
    torch.cuda.synchronize()
    assert _build.LINEAR_SCAN.launches == before + 1
    want = linear_scan_plain(q, q, q, ld, chunk=128, mode="ssm")
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, atol=1e-4, rtol=1e-4)
    wide = torch.ones((1, 128, 1, 128), device=cuda)
    v = torch.ones((1, 128, 1, 512), device=cuda)
    with pytest.raises(ValueError, match="per-channel decay do not fit"):
        linear_scan(wide, wide, v, -wide, chunk=128, mode="ssm")
    assert _build.LINEAR_SCAN.launches == before + 1


ALL_ARCHS = ["qwen2_7b", "rwkv6_3b", "starcoder2_15b", "nemotron4_15b",
             "qwen2_72b", "olmoe_1b_7b", "arctic_480b", "zamba2_1p2b",
             "pixtral_12b", "whisper_tiny"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_lms_on_the_card_match_the_cpu(cuda, arch):
    """Every smoke-scale arch in float32 from the same weights: the kernels
    on the card against the plain versions on the CPU, 1e-4 (whisper
    through ``encode`` and ``decode_train``, vlm from embeddings;
    qwen2-72b at its published head dim 8)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.encdec import decode_train, encode, init_encdec
    from repro_torch.models.lm import init_lm, lm_forward
    cfg = get_smoke_config(arch).with_(dtype=torch.float32)
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab, (2, 96), generator=gen)
    if cfg.family == "audio":
        cpu = init_encdec(cfg, seed=3, device="cpu")
        card = init_encdec(cfg, seed=3, device="cpu").to(cuda)
        audio = torch.randn((2, 150, cfg.d_model), generator=gen)
        enc = encode(cpu, audio)
        want = decode_train(cpu, tokens, enc)
        got_enc = encode(card, audio.to(cuda))
        torch.testing.assert_close(got_enc.cpu(), enc, atol=1e-4, rtol=1e-4)
        got = decode_train(card, tokens.to(cuda), got_enc)
    else:
        cpu = init_lm(cfg, seed=3, device="cpu")
        card = init_lm(cfg, seed=3, device="cpu").to(cuda)
        kw = ({"tokens": tokens} if cfg.embed_inputs else
              {"embeds": torch.randn((2, 96, cfg.d_model), generator=gen)})
        want = lm_forward(cpu, **kw)[0]
        got = lm_forward(card, **{k: v.to(cuda) for k, v in kw.items()})[0]
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_training_grads_on_the_card_match_the_cpu(cuda, arch):
    """One training step's loss and gradients (2 microbatches, float32,
    remat) at smoke scale: the kernels forward on the card and their
    plain-torch backward against the plain versions on the CPU, 1e-4 of
    each leaf's largest |g| (TF32 off)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.trainer import (TrainConfig, init_params,
                                           make_grads_fn)
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config(arch).with_(dtype=torch.float32)
    params = init_params(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (4, 65), generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.randn((4, 150, cfg.d_model),
                                            generator=gen)
    elif not cfg.embed_inputs:
        batch["embeds"] = torch.randn((4, 64, cfg.d_model), generator=gen)
    grads_of = make_grads_fn(cfg, TrainConfig(num_microbatches=2))
    want_loss, want = grads_of(params, batch)
    before = [k.launches for k in _build.KERNELS]
    loss, got = grads_of(
        {k: v.detach().to(cuda).requires_grad_(True)
         for k, v in params.items()},
        {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    launched = sum(k.launches - b for k, b in zip(_build.KERNELS, before))
    assert launched > 0
    torch.testing.assert_close(loss.cpu(), want_loss, atol=1e-4, rtol=1e-4)
    for name, w in want.items():
        torch.testing.assert_close(
            got[name].cpu(), w, rtol=1e-4,
            atol=1e-4 * max(float(w.abs().max()), 1e-6), msg=name)


GRAD_FLASH_CASES = [
    # B, Sq, Sk, H, KH, hd, causal, window
    (2, 128, 128, 4, 4, 8, True, None),         # hd 8
    (1, 200, 200, 8, 2, 16, True, 64),          # windowed, GQA 4
    (1, 96, 160, 4, 1, 64, False, None),        # cross-attention, GQA 4
    (1, 64, 64, 2, 2, 32, True, None),
    (2, 256, 256, 8, 2, 128, True, None),       # GQA 4, hd 128
]


def _within_bf16_noise(got, plain16, plain32, name):
    """A bf16 gradient against the plain path's: within twice the plain
    bf16 gradient's own distance from float32 (two bf16 evaluations each
    that far from float32 lie within twice it of each other)."""
    noise = float((plain16.float() - plain32).abs().max())
    err = float((got.float() - plain16.float()).abs().max())
    assert err <= 2 * noise, f"{name}: {err} > 2 x {noise}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GRAD_FLASH_CASES)
def test_flash_kernel_carries_gradients(cuda, dtype, case):
    """With grad mode on, the kernel's output carries q, k and v's
    gradients (the plain-torch backward; one launch, none in the backward)
    and they equal autograd through the plain version: 1e-4 of the largest
    entry in float32; in bf16 within the plain bf16 path's noise. Without
    grad mode the output has no graph."""
    b, sq, sk, h, kh, hd, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(hd)

    def leaves(dt):
        return [t.to(dt).requires_grad_(True) for t in rnd]
    rnd = [torch.randn((b, s, n, hd), generator=g, device=cuda)
           for s, n in ((sq, h), (sk, kh), (sk, kh))]
    dout = torch.randn((b, sq, h, hd), generator=g, device=cuda)
    kw = dict(causal=causal, window=window)
    inputs = leaves(dtype)
    before = _build.FLASH_ATTENTION.launches
    out = flash_attention(*inputs, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, inputs, dout.to(dtype))
    torch.cuda.synchronize()
    assert _build.FLASH_ATTENTION.launches == before + 1
    plain_in = leaves(dtype)
    want = torch.autograd.grad(flash_attention_plain(*plain_in, **kw),
                               plain_in, dout.to(dtype))
    for name, gt, wt, t in zip("qkv", got, want, inputs):
        assert gt.dtype == t.dtype and gt.shape == t.shape
        if dtype == torch.float32:
            torch.testing.assert_close(
                gt, wt, rtol=1e-4, atol=1e-4 * float(wt.abs().max()))
    if dtype == torch.bfloat16:
        in32 = leaves(torch.float32)
        want32 = torch.autograd.grad(flash_attention_plain(*in32, **kw),
                                     in32, dout)
        for name, gt, wt, w32 in zip("qkv", got, want, want32):
            _within_bf16_noise(gt, wt, w32, name)
    with torch.no_grad():
        assert flash_attention(*inputs, **kw).grad_fn is None


GRAD_SCAN_CASES = [
    # B, S, H, dk, dv, chunk, mode, per-channel decay, bonus, initial state
    (2, 128, 4, 64, 64, 16, "rwkv", True, True, True),     # rwkv6, chunk 16
    (2, 256, 8, 64, 64, 128, "ssm", False, False, True),   # zamba2, chunk 128
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GRAD_SCAN_CASES)
def test_linear_scan_kernel_carries_gradients(cuda, dtype, case):
    """y and the final state carry the gradients of q, k, v, the decay (a
    (B, S, H, 1) decay's summed back to its shape), the bonus and the
    initial state; q and k of the ssm case are one (B, S, 1, dk) tensor
    broadcast over the heads, as Mamba-2 hands them over. Equal to
    autograd through the plain version (1e-4 of the largest entry in
    float32; in bf16 within the plain bf16 path's noise), one launch."""
    b, s, h, dk, dv, chunk, mode, per_channel, bonus, init = case
    g = torch.Generator(device=cuda).manual_seed(chunk)
    qk_heads = h if mode == "rwkv" else 1
    base = [torch.randn((b, s, qk_heads, dk), generator=g, device=cuda) * 0.5
            for _ in range(2)]
    base.append(torch.randn((b, s, h, dv), generator=g, device=cuda))
    raw = torch.randn((b, s, h, dk if per_channel else 1), generator=g,
                      device=cuda)
    # rwkv6's decay; at chunk 128 zamba2's, -softplus(A_log) dt with its
    # dt_bias of -2 (a decay as strong as rwkv's overflows the chunk's
    # exp(-la) factor in the backward, as in the reference's chunked path)
    base.append(-torch.exp(raw - 1.0) if mode == "rwkv" else
                -torch.nn.functional.softplus(raw - 2.0) * 0.6931)
    base.append(torch.randn((h, dk), generator=g, device=cuda) * 0.3
                if bonus else None)
    base.append(torch.randn((b, h, dk, dv), generator=g, device=cuda)
                if init else None)
    dy = torch.randn((b, s, h, dv), generator=g, device=cuda)
    dstate = torch.randn((b, h, dk, dv), generator=g, device=cuda)

    def run(fn, dt):
        leaves = [None if t is None else
                  (t.to(dt) if i < 3 else t).requires_grad_(True)
                  for i, t in enumerate(base)]
        q, k = (t.expand(b, s, h, dk) for t in leaves[:2])
        y, st = fn(q, k, leaves[2], leaves[3], bonus=leaves[4],
                   initial_state=leaves[5], chunk=chunk, mode=mode)
        wrt = [t for t in leaves if t is not None]
        return y, wrt, torch.autograd.grad((y, st), wrt, (dy, dstate))
    before = _build.LINEAR_SCAN.launches
    y, wrt, got = run(linear_scan, dtype)
    torch.cuda.synchronize()
    assert y.grad_fn is not None
    assert _build.LINEAR_SCAN.launches == before + 1
    _, _, want = run(linear_scan_plain, dtype)
    for gt, wt, t in zip(got, want, wrt):
        assert gt.dtype == t.dtype and gt.shape == t.shape
        if dtype == torch.float32:
            torch.testing.assert_close(
                gt, wt, rtol=1e-4, atol=1e-4 * float(wt.abs().max()))
    if dtype == torch.bfloat16:
        _, _, want32 = run(linear_scan_plain, torch.float32)
        for i, (gt, wt, w32) in enumerate(zip(got, want, want32)):
            _within_bf16_noise(gt, wt, w32, f"input {i}")


def test_kernels_count_their_launches(cuda):
    x = torch.ones((1, 64, 32), device=cuda)
    before = [k.launches for k in _build.KERNELS]
    codes, mins, maxs = quantize_fused(x, 8)
    counts = histogram(codes.view(64, 32), 256)
    consolidate_fused(x, codes, mins, maxs, 8)
    cdf(counts.t().contiguous())
    q = torch.ones((1, 64, 2, 16), device=cuda)
    flash_attention(q, q, q)
    linear_scan(q, q, q, -q, chunk=16)
    baf_conv(torch.ones((1, 4, 4, 8), device=cuda),
             torch.ones((16, 8, 3, 3), device=cuda))
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(_build.KERNELS, before)] == \
        [1, 1, 1, 1, 1, 1, 1]


def test_baf_loss_runs_the_quantize_kernel_once_a_call(cuda):
    """The BaF training loss on the card quantizes through the kernel, one
    launch a call, with the channel table computed once by make_baf_loss.
    On the same z (so the same codes) its value and its BaF gradients
    match the same loss on the CPU at 1e-3 (gradients: atol 1e-3 x the
    leaf's largest |g|; float32 convolutions and their transposes summed in
    another order, with cuDNN's TF32 off as in chip_smoke.py)."""
    from repro_torch.core.baf import BaFConv, BaFConvConfig
    from repro_torch.models.cnn import CNN, CNNConfig
    from repro_torch.train.baf_trainer import baf_grads, make_baf_loss

    cfg = CNNConfig(width_mult=0.25, input_size=64, num_classes=8,
                    tail_res_blocks=1)
    img = torch.randn((2, 64, 64, 3), generator=torch.Generator()
                      .manual_seed(3))
    z = CNN(cfg, seed=0, device="cpu").edge(img)[1]
    sel = np.random.default_rng(4).permutation(cfg.split_p)[:16]
    out = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in (cuda, torch.device("cpu")):
            model = CNN(cfg, seed=0, device=dev)
            baf = BaFConv(BaFConvConfig(c=16, q=cfg.split_q, hidden=16),
                          seed=1, device=dev).requires_grad_(True)
            loss_fn = make_baf_loss(model, sel, 8, device=dev)
            before = _build.QUANTIZE.launches
            loss, grads = baf_grads(baf, z.to(dev), loss_fn)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert _build.QUANTIZE.launches == before + 1
            assert all(q.grad is None for q in model.parameters())
            out.append([loss.cpu()] + [g.cpu() for g in grads.values()])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for a, b in zip(*out):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-3 * float(
            b.abs().max()))


def test_serving_gateway_on_the_card_matches_the_cpu(cuda):
    """A 4-request ServingGateway on the card (max_batch 3: micro-batches of
    3 and 1): one quantize and one histogram launch a request, one
    consolidate launch a micro-batch; wire bytes and telemetry records
    equal the CPU gateway's for the same z (both edges pinned to the CPU's
    z), logits within 1e-3 (cuDNN's TF32 off)."""
    from repro_torch import pipeline
    from repro_torch.core.baf import BaFConv, BaFConvConfig
    from repro_torch.models.cnn import CNN, CNNConfig
    from repro_torch.serve import (ChannelConfig, LinearCostModel,
                                   SerialExecutor, ServingGateway,
                                   SimulatedChannel)

    cfg = CNNConfig(width_mult=0.25, input_size=64, num_classes=8,
                    tail_res_blocks=1)
    imgs = np.random.default_rng(6).normal(size=(4, 64, 64, 3)) \
        .astype(np.float32)
    sel = np.random.default_rng(7).permutation(cfg.split_p)[:16]
    cpu_model = CNN(cfg, seed=0, device="cpu")
    zs = {im.tobytes(): cpu_model.edge(torch.from_numpy(im[None]))[1]
          for im in imgs}
    runs = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in (cuda, torch.device("cpu")):
            model = CNN(cfg, seed=0, device=dev)
            baf = BaFConv(BaFConvConfig(c=16, q=cfg.split_q, hidden=16),
                          seed=1, device=dev)
            gw = ServingGateway(
                model, {16: (baf, sel)}, max_batch=3,
                default_op=pipeline.OperatingPoint(c=16, bits=8,
                                                   backend="rans"),
                channel=SimulatedChannel(ChannelConfig(bandwidth_bps=1e6)),
                executor=SerialExecutor(cost=LinearCostModel()), device=dev)
            gw._edge_fn = lambda img, d=dev: \
                zs[img.cpu().numpy().tobytes()].to(d)
            wire, sizes = [], []
            submit = gw.executor.submit

            def watched(batch, t, *, run_fn=None, wire=wire, sizes=sizes,
                        submit=submit):
                wire.extend(r.blob.data for r in batch.requests)
                sizes.append(len(batch.requests))
                return submit(batch, t, run_fn=run_fn)
            gw.executor.submit = watched
            before = [k.launches for k in _build.KERNELS]
            resp, tel = gw.serve(imgs)
            launches = {k.name: k.launches - b
                        for k, b in zip(_build.KERNELS, before)}
            runs.append((wire, sizes, tel.records,
                         np.stack([r.logits for r in resp]), launches))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (wire, sizes, recs, logits, launches), (cwire, csizes, crecs, clogits,
                                            _) = runs
    assert wire == cwire and sizes == csizes == [3, 1] and recs == crecs
    assert launches == {"quantize": 4, "histogram": 4, "consolidate": 2,
                        "cdf": 0, "flash_attention": 0, "linear_scan": 0,
                        "baf_conv": 10}
    np.testing.assert_allclose(logits, clogits, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("bits", [4, 12])
def test_session_clip_on_the_card_matches_the_cpu(cuda, bits):
    """A 10-frame session clip (I then P, keyframe interval 4) on the card
    and on the CPU from the same z: SSF1 frames byte-identical, decoded
    codes identical; quantize and histogram once a frame on the card, and
    the P-frames' delta formed on the card (12 bits: uint16 codes)."""
    from repro_torch import pipeline
    from repro_torch.session import (SessionConfig, SessionDecoder,
                                     SessionEncoder)

    rng = np.random.default_rng(bits)
    z = rng.normal(size=(1, 16, 16, 32)).astype(np.float32)
    zs = []
    for _ in range(10):
        z = z + 0.01 * rng.normal(size=z.shape).astype(np.float32)
        zs.append(torch.from_numpy(z.copy()))
    op = pipeline.OperatingPoint(c=8, bits=bits, backend="rans")
    spec = pipeline.ModelSpec(sel_idx=rng.permutation(32)[:8])
    runs = []
    for dev in (cuda, torch.device("cpu")):
        def plan_for(o, dev=dev):
            return pipeline.compile(o, spec, device=dev)
        cfg = SessionConfig(session_id=2, levels=(op,), keyframe_interval=4)
        enc, dec = SessionEncoder(cfg, plan_for), SessionDecoder(cfg,
                                                                 plan_for)
        before = [k.launches for k in _build.KERNELS]
        out = [enc.encode(x.to(dev)) for x in zs]
        launches = {k.name: k.launches - b
                    for k, b in zip(_build.KERNELS, before)}
        runs.append(([b for b, _ in out], [m.intra for _, m in out],
                     [dec.decode(b)[0].codes for b, _ in out], launches))
    (blobs, intra, codes, launches), (cblobs, cintra, ccodes, _) = runs
    assert blobs == cblobs and intra == cintra
    assert intra == [True, False, False, False] * 2 + [True, False]
    assert all(np.array_equal(a, b) for a, b in zip(codes, ccodes))
    assert launches == {"quantize": 10, "histogram": 10, "consolidate": 0,
                        "cdf": 0, "flash_attention": 0, "linear_scan": 0,
                        "baf_conv": 0}


def test_detect_head_on_the_card_matches_the_cpu(cuda):
    """The detect head (and the other two) on the card against the CPU from
    the same weights and z, 1e-4 (cuDNN's TF32 off for the classify head's
    convolutions); the detect head launches the flash kernel once a call,
    float32, head dim 16, not causal."""
    from repro_torch.models.cnn import CNN, CNNConfig
    from repro_torch.tasks import HeadConfig, init_head_bank, run_heads

    cfg = CNNConfig(width_mult=0.25, input_size=64, num_classes=8,
                    tail_res_blocks=1)
    hcfg = HeadConfig(split_p=cfg.split_p, num_classes=cfg.num_classes)
    z = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 32, 32, cfg.split_p)).astype(np.float32))
    outs = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in (cuda, torch.device("cpu")):
            model = CNN(cfg, seed=0, device=dev)
            heads = init_head_bank(torch.Generator().manual_seed(9), hcfg,
                                   device=dev)
            before = _build.FLASH_ATTENTION.launches
            outs.append(run_heads(model, heads, z.to(dev),
                                  ("classify", "detect", "embed"), hcfg))
            if dev == cuda:
                assert _build.FLASH_ATTENTION.launches - before == 1
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for task in ("classify", "detect", "embed"):
        np.testing.assert_allclose(outs[0][task], outs[1][task], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("b", [1, 8])
def test_flash_f32_at_the_detect_heads_shape(cuda, b):
    """float32, head dim 16, not causal, S = 4096 (a 64x64 grid of
    tokens), two heads: the kernel against its plain version, 2e-5."""
    g = torch.Generator(device=cuda).manual_seed(b)
    q, k, v = (torch.randn((b, 4096, 2, 16), generator=g, device=cuda)
               for _ in range(3))
    got = flash_attention(q, k, v, causal=False)
    want = flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# Distributed training and the pod pipeline, world size 1 over NCCL
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A (pod, data, model) = (1, 1, 1) mesh over NCCL in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.distributed import init_mesh
    mesh = init_mesh((1, 1, 1), backend="nccl", rank=0, world=1,
                     init_file=str(tmp_path_factory.mktemp("nccl")
                                   / "rendezvous"), device_type="cuda")
    yield mesh
    dist.destroy_process_group()


def _stream(shape, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 3
    x[..., 1] = 1e5
    x[..., 2] = -7e4
    x[..., 4] = -0.0
    x[..., 5] = rng.choice([0.0, -0.0], size=shape[:-1])
    return torch.from_numpy(x).to(dtype)


def _f16_bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_stream_quantizer_on_the_card_matches_cpu(cuda, bits, subset):
    """The pod pipeline's quantizer (the kernel at B = 1, R = B * S) on a
    bf16 stream: codes and side info bit-identical to the CPU, one launch."""
    from repro_torch.distributed.pipeline import _quantize_stream
    x = _stream((2, 512, 3584), bits)
    sel = torch.arange(0, 3584, 4, dtype=torch.int32) if subset else None
    want = _quantize_stream(x, bits, sel)
    before = _build.QUANTIZE.launches
    got = _quantize_stream(x.to(cuda), bits,
                           None if sel is None else sel.to(cuda))
    torch.cuda.synchronize()
    assert _build.QUANTIZE.launches - before == 1
    assert torch.equal(got[0].cpu(), want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(_f16_bits(g.cpu()), _f16_bits(w))


@pytest.mark.parametrize("bits", [1, 3, 4, 8])
def test_pack_codes_on_the_card(cuda, bits):
    from repro_torch.distributed.pipeline import pack_codes, unpack_codes
    codes = torch.randint(0, 1 << bits, (2, 1000, 37), dtype=torch.uint8)
    wire = pack_codes(codes.to(cuda), bits)
    assert torch.equal(wire.cpu(), pack_codes(codes, bits))
    back = unpack_codes(wire, bits, codes.numel()).reshape(codes.shape)
    assert torch.equal(back.cpu(), codes)


@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_pod_mean_world_one(nccl_mesh, cuda, bits):
    """At one pod the mean is the dequantized codes of the gradient itself
    and the residual what they miss: bit for bit the plain formula."""
    from repro_torch.optim.grad_compress import quantized_pod_mean
    g = torch.Generator(device=cuda).manual_seed(bits)
    grads = {"w": torch.randn((512, 384), generator=g, device=cuda),
             "b": torch.randn((384,), generator=g, device=cuda) * 1e-3,
             "z": torch.zeros((4, 4), device=cuda)}
    means, resid = quantized_pod_mean(grads, nccl_mesh, bits=bits)
    levels = (1 << (bits - 1)) - 1
    for k, v in grads.items():
        one = lambda x: torch.tensor(float(x), device=cuda)
        scale = torch.maximum(v.abs().amax(), one(1e-30)) / one(levels)
        codes = torch.clamp(torch.round(v / scale), -levels, levels)
        assert torch.equal(means[k], codes * scale / one(1)), k
        assert torch.equal(resid[k], v - codes * scale), k


@pytest.mark.parametrize("length", [0, 511, 1023])
def test_seq_sharded_decode_world_one(nccl_mesh, cuda, length):
    """qwen2-7b's heads (28 over 4 kv heads, head dim 128) against the
    plain one-token decode in float32, 1e-5 of the largest entry."""
    from repro_torch.distributed.collectives import \
        seq_sharded_decode_attention
    g = torch.Generator(device=cuda).manual_seed(length)
    ck, cv = (torch.randn((2, 1024, 4, 128), generator=g, device=cuda)
              for _ in range(2))
    q = torch.randn((2, 28, 128), generator=g, device=cuda)
    nk, nv = (torch.randn((2, 4, 128), generator=g, device=cuda)
              for _ in range(2))
    fk, fv = ck.clone(), cv.clone()
    fk[:, length], fv[:, length] = nk, nv
    got, lk, _ = seq_sharded_decode_attention(q, ck, cv, nk, nv, length,
                                              nccl_mesh, axis="model")
    p = torch.softmax(torch.einsum("bkgh,bskh->bkgs",
                                   q.reshape(2, 4, 7, 128),
                                   fk[:, :length + 1]) / 128 ** 0.5, -1)
    want = torch.einsum("bkgs,bskh->bkgh", p,
                        fv[:, :length + 1]).reshape(2, 28 * 128)
    assert torch.equal(lk, fk)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_lm_decode_under_flash_decode_ctx_on_the_card(nccl_mesh, cuda):
    """qwen2-7b's smoke LM in float32 at world size 1: the sharded decode
    against the unsharded one, 1e-5 of the largest logit."""
    from repro_torch import configs
    from repro_torch.distributed import flash_decode_ctx
    from repro_torch.models.lm import init_decode_cache, init_lm, \
        lm_decode_step
    cfg = configs.get_smoke_config("qwen2_7b").with_(dtype=torch.float32)
    model = init_lm(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    runs = []
    for sharded in (False, True):
        ctx = flash_decode_ctx(nccl_mesh) if sharded else \
            contextlib.nullcontext()
        with ctx, torch.no_grad():
            cache = init_decode_cache(cfg, 2, 16, device=cuda)
            runs.append(torch.stack([lm_decode_step(
                model, cache, tokens[:, t].to(cuda))[0]
                for t in range(8)]))
    torch.testing.assert_close(runs[1], runs[0], rtol=0,
                               atol=1e-5 * float(runs[0].abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subset_pod_transfer_on_the_card(nccl_mesh, cuda, dtype):
    """C of D channels through quantize (one launch), the stream BaF
    predictor, a frozen block and consolidate (one launch): the output the
    plain consolidate's on the same estimate, bit for bit; in float32
    within 1e-4 of the CPU's largest entry."""
    from repro_torch.core.baf import BaFStream, BaFStreamConfig
    from repro_torch.distributed.pipeline import (_quantize_stream,
                                                  subset_pod_transfer)
    d, c = 256, 64
    x = _stream((2, 128, d), 7, dtype)
    x[..., 1:3] = 0.5
    sel = torch.arange(0, d, d // c, dtype=torch.int32)
    w = torch.randn((d, d), generator=torch.Generator().manual_seed(2)) * .05
    outs, seen = [], {}
    for dev in (cuda, torch.device("cpu")):
        baf = BaFStream(BaFStreamConfig(c=c, d_in=d, hidden=64), seed=3,
                        device=dev)
        wd = w.to(dev, dtype)

        def block(t):
            out = t @ wd
            seen[dev.type] = out.clone()       # consolidation writes in out
            return out
        q0, c0 = _build.QUANTIZE.launches, _build.CONSOLIDATE.launches
        outs.append(subset_pod_transfer(x.to(dev), nccl_mesh,
                                        sel_idx=sel.to(dev), baf=baf,
                                        forward_fn=block, dtype=dtype))
        if dev == cuda:
            torch.cuda.synchronize()
            assert _build.QUANTIZE.launches - q0 == 1
            assert _build.CONSOLIDATE.launches - c0 == 1
    codes, mn, mx = _quantize_stream(x.to(cuda), 8, sel.to(cuda))
    z32 = seen["cuda"].reshape(1, -1, d).float()
    consolidate_plain(z32, codes.reshape(1, -1, c), mn[None], mx[None], 8,
                      sel.long().to(cuda))
    assert torch.equal(outs[0], z32.reshape(x.shape).to(dtype))
    if dtype == torch.float32:
        torch.testing.assert_close(outs[0].cpu(), outs[1], rtol=0,
                                   atol=1e-4 * float(outs[1].abs().max()))


# ---------------------------------------------------------------------------
# The sharded cloud tier and the program cost counter
# ---------------------------------------------------------------------------

def _mesh_system(dev):
    from repro_torch import pipeline
    from repro_torch.core.baf import BaFConv, BaFConvConfig
    from repro_torch.models.cnn import CNN, CNNConfig

    cfg = CNNConfig(width_mult=0.25, input_size=64, num_classes=8,
                    tail_res_blocks=1)
    model = CNN(cfg, seed=0, device=dev)
    baf = BaFConv(BaFConvConfig(c=16, q=cfg.split_q, hidden=16), seed=1,
                  device=dev)
    sel = np.random.default_rng(7).permutation(cfg.split_p)[:16]
    spec = pipeline.ModelSpec(sel_idx=sel, params=model, baf_params=baf)
    return cfg, pipeline.compile(pipeline.OperatingPoint(c=16, bits=8),
                                 spec, device=dev)


def _decoded(cfg, n):
    from repro_torch.pipeline.plan import DecodedBatch
    rng = np.random.default_rng(8)
    hw = cfg.split_hw
    return DecodedBatch(
        codes=rng.integers(0, 256, (n, hw, hw, 16)).astype(np.uint8),
        mins=(-rng.uniform(1, 2, (n, 1, 1, 16))).astype(np.float16),
        maxs=rng.uniform(1, 2, (n, 1, 1, 16)).astype(np.float16))


@pytest.mark.parametrize("n_data", [1, 2])
def test_run_sharded_on_the_card(cuda, n_data):
    """MeshExecutor over data=1 and over two shards of cuda:0: each shard's
    logits bit-identical to the serial path at its row count (cuDNN
    deterministic), at data=1 to the serial path at the padded size; one
    consolidate launch a shard; the logits within 1e-3 of the CPU's (TF32
    off)."""
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.pipeline.plan import DecodedBatch
    from repro_torch.serve import LinearCostModel, MeshExecutor

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        cfg, plan = _mesh_system(cuda)
        dec = _decoded(cfg, 6)
        ex = MeshExecutor(make_dev_mesh(n_data, prefer="data",
                                        device="cuda:0"),
                          cost=LinearCostModel())
        assert ex.mesh.devices_along("data") == [cuda] * n_data
        before = _build.CONSOLIDATE.launches
        got = ex.run_sharded(plan, dec, 8)
        assert _build.CONSOLIDATE.launches - before == n_data
        assert got.shape == (8, cfg.num_classes) and np.isfinite(got).all()
        rows = ex.shard_rows(8)
        padded = dec.pad_to(rows * n_data)
        for i in range(n_data):
            part = slice(i * rows, (i + 1) * rows)
            shard = DecodedBatch(codes=padded.codes[part],
                                 mins=padded.mins[part],
                                 maxs=padded.maxs[part])
            want = plan.spec.params.cloud(plan.restore(shard)).cpu().numpy()
            assert np.array_equal(got[part], want)
        assert ex._replicas == {}
        _, cplan = _mesh_system(torch.device("cpu"))
        cpu = MeshExecutor(make_dev_mesh(n_data, prefer="data",
                                         device="cpu")).run_sharded(
            cplan, dec, 8)
        np.testing.assert_allclose(got, cpu, rtol=1e-3, atol=1e-3)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def _kernel_calls(dev):
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 64, 32), generator=g).to(dev)
    sel = torch.randperm(32, generator=g)[:8].to(torch.int32).to(dev)
    codes, mins, maxs = quantize_fused(x, 8, sel)
    counts = histogram(codes.view(-1, 8), 256)
    q = torch.randn((1, 64, 4, 16), generator=g).to(dev)
    kv = torch.randn((1, 64, 2, 16), generator=g).to(dev)
    ld = -torch.rand((1, 64, 4, 16), generator=g).to(dev)
    return [lambda: quantize_fused(x, 8, sel),
            lambda: histogram(codes.view(-1, 8), 256),
            lambda: cdf(counts.t()),
            lambda: consolidate_fused(x, codes, mins, maxs, 8, sel),
            lambda: flash_attention(q, kv, kv, causal=True, window=16),
            lambda: linear_scan(q, q, q, ld, chunk=16)]


def test_kernel_charges_are_the_same_on_the_card_and_the_cpu(cuda):
    """Each wrapper charges the program counter the same entry whether its
    kernel (the card) or its plain version (the CPU) runs, and nothing
    else is counted inside it."""
    from repro_torch.launch.hlo_cost import analyze_program

    got = {}
    for dev in (cuda, torch.device("cpu")):
        out = []
        for call in _kernel_calls(dev):
            est = analyze_program(call)
            assert len(est["kernels"]) == 1
            assert set(est["bytes_by_op"]) == {est["kernels"][0]["name"]}
            out.append(est["kernels"][0])
        got[dev.type] = out
    assert [k["name"] for k in got["cuda"]] == [
        "quantize", "histogram", "cdf", "consolidate", "flash_attention",
        "linear_scan"]
    assert got["cuda"] == got["cpu"]


def test_mesh_needs_a_card(monkeypatch):
    """Without a card, the default mesh and the default MeshExecutor raise
    rather than fall back to the CPU; a CPU mesh is only made on request.
    Runs anywhere (``torch.cuda.is_available`` patched)."""
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.serve import MeshExecutor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_dev_mesh, lambda: make_dev_mesh(prefer="data"),
                 MeshExecutor):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    mesh = make_dev_mesh(2, prefer="data", device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 2
