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
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import histogram as hist_kernel
from repro_torch.kernels import quantize as quant_kernel
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_scan_kernel_overflows_like_plain(cuda, dtype):
    """chunk 32 with every decay at the clamp (-4): exp(-la) overflows and
    exp(la) underflows; the kernel keeps the factorisation, so its NaNs
    stand exactly where the plain version's do."""
    b, s, h, dk, dv = 2, 64, 3, 32, 16
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k = (torch.randn((b, s, h, dk), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=g, device=cuda).to(dtype)
    ld = torch.full((b, s, h, dk), -4.0, device=cuda)
    u = torch.randn((h, dk), generator=g, device=cuda)
    got = linear_scan(q, k, v, ld, bonus=u, chunk=32)
    torch.cuda.synchronize()
    want = linear_scan_plain(q, k, v, ld, bonus=u, chunk=32)
    assert not bool(torch.isfinite(want[0]).all())
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
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


def test_smoke_lms_on_the_card_match_the_cpu(cuda):
    """Smoke-scale qwen2 and rwkv6 in float32 from the same weights: the
    kernels on the card against the plain versions on the CPU, 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import init_lm, lm_forward
    for arch in ("qwen2_7b", "rwkv6_3b"):
        cfg = get_smoke_config(arch).with_(dtype=torch.float32)
        cpu = init_lm(cfg, seed=3, device="cpu")
        card = init_lm(cfg, seed=3, device="cpu").to(cuda)
        tokens = torch.randint(0, cfg.vocab, (2, 96),
                               generator=torch.Generator().manual_seed(4))
        want = lm_forward(cpu, tokens=tokens)[0]
        got = lm_forward(card, tokens=tokens.to(cuda))[0]
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


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
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(_build.KERNELS, before)] == \
        [1, 1, 1, 1, 1, 1]


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
                        "cdf": 0, "flash_attention": 0, "linear_scan": 0}
    np.testing.assert_allclose(logits, clogits, rtol=1e-3, atol=1e-3)
