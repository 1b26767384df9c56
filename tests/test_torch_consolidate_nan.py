"""Consolidation with NaN in the estimate or the side info, and the
consolidate kernel's launch plan, on the CPU.

``consolidate_fused`` on CPU tensors runs its plain version; here it is
held to the JAX package's ``consolidate_pallas`` (interpret mode) and
``ref.consolidate_ref`` on the same numpy inputs, NaN included: NaN where
z~ or an (example, channel)'s side info is NaN, as ``jnp.clip`` gives, and
within the JAX kernel test's atol of 1e-5 elsewhere. The plan and the way
the kernel walks it (channel table in address order, tiles of rows, lanes
over channels) are checked by a numpy model of the kernel, which must give
the plain version's bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.consolidate import consolidate_pallas
from repro_torch.kernels import consolidate as tcons
from repro_torch.kernels.consolidate import (consolidate_fused,
                                             consolidate_plain,
                                             consolidate_plan)
from repro_torch.kernels.quantize import channel_order, quantize_fused

NAN_CASES = ["z", "side", "both"]


def _nan_inputs(case, bits, shape=(2, 64, 12), seed=0):
    """(est, codes, mins, maxs) as numpy: codes and side info of a clean z,
    the estimate z plus noise; NaN placed in the estimate, in the side info
    of (1, 3) (min and max both, as the quantizer writes them), or both."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    codes, mins, maxs = (t.numpy() for t in
                         quantize_fused(torch.from_numpy(x), bits))
    est = x + rng.normal(size=shape).astype(np.float32) * 0.3
    if case in ("z", "both"):
        est[0, 5, 2] = np.nan
        est[1, :3, 7] = np.nan
        est[1, 10, 3] = np.nan               # also where side info is NaN
    if case in ("side", "both"):
        mins[1, 3] = maxs[1, 3] = np.float16("nan")
    return est, codes, mins, maxs


@pytest.mark.parametrize("bits", [8, 12])          # uint8 and uint16 codes
@pytest.mark.parametrize("case", NAN_CASES)
def test_consolidate_nan_matches_pallas_and_ref(case, bits):
    est, codes, mins, maxs = _nan_inputs(case, bits)
    got = consolidate_fused(torch.from_numpy(est.copy()),
                            torch.from_numpy(codes), torch.from_numpy(mins),
                            torch.from_numpy(maxs), bits).numpy()
    jargs = (jnp.asarray(est), jnp.asarray(codes), jnp.asarray(mins),
             jnp.asarray(maxs), bits)
    for want in (consolidate_pallas(*jargs, block_r=64, interpret=True),
                 ref.consolidate_ref(*jargs)):
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   equal_nan=True)
    nan = np.isnan(got)
    if case != "side":
        assert nan[0, 5, 2] and nan[1, :3, 7].all()
    if case != "z":
        assert nan[1, :, 3].all()
    assert int(nan.sum()) == {"z": 5, "side": 64, "both": 68}[case]


@pytest.mark.parametrize("case", NAN_CASES)
def test_consolidate_nan_with_selection_matches_ref(case):
    """The fused form on a full (B, R, P) estimate: the selected channels
    as ``consolidate_ref`` on the gathered ones, NaN included; the other
    channels untouched (a NaN there stays)."""
    est, codes, mins, maxs = _nan_inputs(case, 8, shape=(2, 40, 12), seed=3)
    sel = np.array([7, 2, 11, 0, 3, 9, 4, 5, 1, 10, 6, 8])[:9]
    full = np.random.default_rng(4).normal(size=(2, 40, 20)).astype(np.float32)
    full[..., 14] = np.nan                      # an unselected NaN column
    full[..., sel] = est[..., :9]
    got = consolidate_fused(torch.from_numpy(full.copy()),
                            torch.from_numpy(codes[..., :9].copy()),
                            torch.from_numpy(mins[:, :9].copy()),
                            torch.from_numpy(maxs[:, :9].copy()), 8,
                            torch.from_numpy(sel.astype(np.int32))).numpy()
    want = full.copy()
    want[..., sel] = np.asarray(ref.consolidate_ref(
        jnp.asarray(est[..., :9]), jnp.asarray(codes[..., :9]),
        jnp.asarray(mins[:, :9]), jnp.asarray(maxs[:, :9]), 8))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

def _kernel_model(z, codes, mins, maxs, bits, order, plan):
    """numpy model of csrc/consolidate.cu under ``plan``: a block per
    (example, tile of rows), the channel table (``order`` rows: output
    column, column of z; None = identity), thread t keeping channel
    k = t % row_threads (+ row_threads ...), dividing its step once, and
    walking rows t // row_threads, + 256 // row_threads, ...; every
    (row, channel) of a tile must be visited once, and an entry whose
    output column or column of z is out of range is skipped. float32
    throughout; np.maximum and np.minimum propagate NaN, as torch.maximum
    and torch.minimum do."""
    b, r, p = z.shape
    c = codes.shape[-1]
    levels = np.float32((1 << bits) - 1)
    rows_pb, row_threads = plan
    row_step = tcons.THREADS // row_threads
    tab = np.arange(c)[:, None].repeat(2, 1) if order is None else order
    out = z.copy()
    for bi in range(b):
        m = mins[bi].astype(np.float32)
        step = (maxs[bi].astype(np.float32) - m) / levels
        for r0 in range(0, r, rows_pb):
            rows = min(rows_pb, r - r0)
            seen = np.zeros((rows, c), np.int64)
            for t in range(row_step * row_threads):
                lane_k, row_lane = t % row_threads, t // row_threads
                for k in range(lane_k, c, row_threads):
                    j, col = tab[k]
                    rr = np.arange(row_lane, rows, row_step)
                    seen[rr, k] += 1
                    if not (0 <= j < c and 0 <= col < p):
                        continue
                    cc = codes[bi, r0 + rr, j].astype(np.float32)
                    lo = m[j] + (cc - np.float32(0.5)) * step[j]
                    hi = m[j] + (cc + np.float32(0.5)) * step[j]
                    out[bi, r0 + rr, col] = np.minimum(
                        np.maximum(out[bi, r0 + rr, col], lo), hi)
            assert (seen == 1).all()
    return out


@pytest.mark.parametrize("b,r,p,c", [(8, 4096, 256, 64), (1, 4096, 256, 64),
                                     (1, 1, 256, 1), (2, 7, 256, 33),
                                     (3, 4095, 256, 256), (1, 65536, 64, 64),
                                     (70000, 2, 8, 8), (1, 10, 20000, 12000)])
def test_consolidate_plan_fits_the_kernel(b, r, p, c):
    """What csrc/consolidate.cu's entry checks, and the plan's aims: rows a
    block in [1, R] and within 32-bit offsets of a tile's base, at most
    ROWS_A_THREAD rows a thread, at least MIN_BLOCKS blocks where the rows
    allow, threads across a row no more than C or a block."""
    rows, row_threads = consolidate_plan(b, r, c)
    assert 1 <= rows <= r
    assert row_threads == min(c, tcons.THREADS)
    assert rows * p <= tcons.INT32_MAX
    assert rows <= tcons.THREADS // row_threads * tcons.ROWS_A_THREAD
    if r >= -(-tcons.MIN_BLOCKS // b):            # rows enough to split
        assert b * -(-r // rows) >= tcons.MIN_BLOCKS


@pytest.mark.parametrize("with_sel", [True, False])
@pytest.mark.parametrize("bits,shape,c", [(8, (2, 37, 24), 7),
                                          (12, (1, 300, 64), 33),
                                          (3, (3, 5, 300), 260)])
def test_kernel_model_under_the_plan_gives_the_plain_bits(bits, shape, c,
                                                          with_sel):
    """The kernel's walk, modelled in numpy under the wrapper's plan and
    the plan's channel table (``channel_order``), NaN included: the plain
    version's bits, NaN at the same places."""
    rng = np.random.default_rng(bits)
    b, r, p = shape
    if not with_sel:
        c = p
    sel = rng.permutation(p)[:c].astype(np.int32) if with_sel else None
    x = rng.normal(size=shape).astype(np.float32)
    codes, mins, maxs = quantize_fused(
        torch.from_numpy(x), bits,
        None if sel is None else torch.from_numpy(sel))
    codes, mins, maxs = codes.numpy(), mins.numpy(), maxs.numpy()
    mins[0, c // 2] = maxs[0, c // 2] = np.float16("nan")
    est = x + rng.normal(size=shape).astype(np.float32) * 0.4
    est[b - 1, r // 2, 0] = np.nan
    order = None if sel is None else \
        channel_order(torch.from_numpy(sel)).numpy()
    plan = consolidate_plan(b, r, c)
    got = _kernel_model(est, codes, mins, maxs, bits, order, plan)
    want = consolidate_plain(
        torch.from_numpy(est.copy()), torch.from_numpy(codes),
        torch.from_numpy(mins), torch.from_numpy(maxs), bits,
        None if sel is None else torch.from_numpy(sel).long()).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep].view(np.int32),
                                  want[keep].view(np.int32))


def test_consolidate_fused_takes_the_channel_table_on_cpu():
    """The plan hands the wrapper the table it computed once; on the CPU
    the plain version gives the same as without it, and a table without
    a selection is refused."""
    est, codes, mins, maxs = _nan_inputs("both", 8, shape=(2, 30, 8))
    z = np.random.default_rng(9).normal(size=(2, 30, 16)).astype(np.float32)
    sel = torch.tensor([9, 2, 15, 0, 7, 4, 12, 1], dtype=torch.int32)
    args = (torch.from_numpy(codes), torch.from_numpy(mins),
            torch.from_numpy(maxs), 8, sel)
    want = consolidate_fused(torch.from_numpy(z.copy()), *args)
    got = consolidate_fused(torch.from_numpy(z.copy()), *args,
                            order=channel_order(sel))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="order"):
        consolidate_fused(torch.from_numpy(est.copy()), *args[:4],
                          order=channel_order(sel))


@pytest.mark.parametrize("field,value", [(0, 9), (0, -1), (1, 40), (1, -2)])
def test_kernel_model_skips_a_table_entry_out_of_range(field, value):
    """A table of the right shape with one entry out of range (output
    column ``field`` 0, column of z ``field`` 1): the walk leaves that
    channel of z as it was and gives the plain version's bits on the
    others, as the gpu test of the kernel demands."""
    rng = np.random.default_rng(21)
    b, r, p, bits = 2, 9, 24, 8
    sel = np.array([9, 2, 14, 5, 20], np.int32)
    x = rng.normal(size=(b, r, p)).astype(np.float32)
    codes, mins, maxs = quantize_fused(torch.from_numpy(x), bits,
                                       torch.from_numpy(sel))
    est = x + rng.normal(size=(b, r, p)).astype(np.float32) * 0.4
    order = channel_order(torch.from_numpy(sel)).numpy().copy()
    j0 = int(order[2, 0])
    order[2, field] = value
    keep = [j for j in range(sel.size) if j != j0]
    got = _kernel_model(est, codes.numpy(), mins.numpy(), maxs.numpy(),
                        bits, order, consolidate_plan(b, r, sel.size))
    want = consolidate_plain(
        torch.from_numpy(est.copy()), codes[..., keep].contiguous(),
        mins[:, keep].contiguous(), maxs[:, keep].contiguous(), bits,
        torch.from_numpy(sel).long()[keep]).numpy()
    np.testing.assert_array_equal(got[..., sel[j0]], est[..., sel[j0]])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
