"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: skipped where there is no CUDA device (decided inside the
fixture, so every pytest worker collects the same tests). Run on a machine
with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: quantize codes and side info, and histogram counts, must be
exact; consolidation is held bit-identical (the kernel keeps the
reference's operation order, built with -fmad=false).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consolidate import consolidate_fused, consolidate_plain
from repro_torch.kernels.histogram import histogram, histogram_plain
from repro_torch.kernels.quantize import quantize_fused, quantize_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _x(rng, shape, scale, offset=0.0):
    return rng.normal(size=shape).astype(np.float32) * scale + offset


@pytest.mark.parametrize("bits", [2, 8])
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
        assert torch.equal(g.view(torch.uint8) if g.dtype == torch.uint8
                           else g.view(torch.int16),
                           w.view(torch.uint8) if w.dtype == torch.uint8
                           else w.view(torch.int16))


@pytest.mark.parametrize("bits", [1, 4, 8, 12])
@pytest.mark.parametrize("shape", [(4096, 64), (1000, 5), (32768, 64)])
def test_histogram_kernel_matches_plain(cuda, bits, shape):
    rng = np.random.default_rng(1)
    nsym = 1 << bits
    if bits <= 8:
        codes = torch.from_numpy(
            rng.integers(0, nsym, size=shape).astype(np.uint8)).to(cuda)
    else:
        v = rng.integers(-2, nsym + 2, size=shape).astype(np.int32)
        v[::7] = nsym                                    # padding sentinel
        codes = torch.from_numpy(v).to(cuda)
    got = histogram(codes, nsym)
    torch.cuda.synchronize()
    assert torch.equal(got, histogram_plain(codes, nsym))


@pytest.mark.parametrize("bits", [3, 8])
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


def test_kernels_count_their_launches(cuda):
    x = torch.ones((1, 64, 32), device=cuda)
    before = [k.launches for k in _build.KERNELS]
    codes, mins, maxs = quantize_fused(x, 8)
    histogram(codes.view(64, 32), 256)
    consolidate_fused(x, codes, mins, maxs, 8)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(_build.KERNELS, before)] == [1, 1, 1]
