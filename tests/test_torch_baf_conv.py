"""The served restore's convolutions: ``kernels/baf_conv.py``.

On the CPU: the fused restore equals the chain it replaced bit for bit (the
wrapper's plain version is the layers' own ops); the wrapper's refusals;
no launch; the trainer's ``baf_conv_predict`` and the unfused
``restore_codes`` never reach it; ``analyze_program`` counts what it
counted before, on CPU and ``meta`` tensors; the weights' prepared layout
and the kernel's gather, emulated from ``csrc/baf_conv.cu``'s index map in
float64, against the plain conv; the prepared weights follow in-place
updates.

On the card (marked ``gpu``, skipped without one; no JAX is imported
here): the kernel against a float64 conv at every conv shape of both
configurations (C=64 and C=96: the x2 transposed ``up``, ``c2``/``c3``,
``c4`` and the split conv with BN) at B=1, 8 and 32, ragged row counts,
odd channel counts and a misaligned input; the full restore against the
cuDNN chain; launches a restore; an in-place weight update seen by the next
restore.

Kernel tolerance: 2e-5 relative and absolute against float64, the float32
flash kernel's (the JAX kernel tests' float32 tolerance). Derivation: with
x ~ N(0, 1) and He-normal weights the outputs are O(1). 3xTF32 leaves each
product within ~1.25 2^-20 of |a b| (A's high part truncated, remainder
rounded: 2^-21 |a|; B's parts rounded: 2^-22 |b|; the dropped lo x lo
2^-21 |a b|), errors of both signs, so a sum of K products drifts by
~2^-20 sqrt(sum (a b)^2) ~ 1e-6; each k-tile's 12 truncating tensor-core
additions start from zero and the k-tiles are added in float32 to
nearest. One TF32 product (~2^-11 |a b|) would give ~1e-4 and fail.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch import nn as tnn
from repro_torch.core.baf import BaFConv, BaFConvConfig, baf_conv_predict
from repro_torch.core.quant import QuantParams, dequantize
from repro_torch.core.split import (restore_codes, restore_codes_fused,
                                    restore_convs)
from repro_torch.kernels import _build
from repro_torch.kernels import baf_conv as bc
from repro_torch.kernels.consolidate import consolidate_fused
from repro_torch.launch.hlo_cost import analyze_program
from repro_torch.models.cnn import ConvBN

Q, P, HIDDEN, BITS = 128, 256, 64, 8
HW = 16                        # CPU tests: the split's H = W
KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)


def _system(c, device="cpu", seed=0):
    """BaF net and split ConvBN with biases, PReLU slopes and BN statistics
    drawn away from their identity initial values."""
    gen = torch.Generator().manual_seed(seed + 1)
    baf = BaFConv(BaFConvConfig(c=c, q=Q, hidden=HIDDEN), seed=seed,
                  device="cpu")
    split = ConvBN(Q, P, 3, gen=gen)
    with torch.no_grad():
        for layer in (baf.up, baf.c2, baf.c3, baf.c4):
            layer.bias.normal_(0.0, 0.1, generator=gen)
        for act in (baf.up_act, baf.c2_act, baf.c3_act):
            act.alpha.uniform_(0.0, 0.5, generator=gen)
        bn = split.bn
        bn.scale.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(0.0, 0.1, generator=gen)
        bn.mean.normal_(0.0, 0.1, generator=gen)
        bn.var.uniform_(0.5, 2.0, generator=gen)
    sel = torch.randperm(P, generator=gen)[:c].to(torch.int32)
    return baf.to(device), split.to(device), sel.to(device)


def _codes(b, hw, c, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << BITS, (b, hw, hw, c)).astype(np.uint8)
    mins = (-rng.uniform(1, 2, (b, 1, 1, c))).astype(np.float16)
    maxs = rng.uniform(1, 2, (b, 1, 1, c)).astype(np.float16)
    return tuple(torch.from_numpy(a).to(device) for a in (codes, mins, maxs))


@torch.no_grad()
def _chain_restore(baf, split, sel, codes, mins, maxs):
    """The fused restore as it ran before its convolutions moved to
    ``baf_conv``: ``baf_conv_predict`` (nn.py's convs), then the
    consolidate kernel."""
    qp = QuantParams(mins, maxs, BITS)
    z = baf_conv_predict(baf, split, sel, dequantize(codes, qp)).contiguous()
    b, h, w, p = z.shape
    c = codes.shape[-1]
    consolidate_fused(z.view(b, h * w, p),
                      codes.reshape(b, h * w, c).contiguous(),
                      mins.reshape(b, c).contiguous(),
                      maxs.reshape(b, c).contiguous(), BITS, sel)
    return z


def _spy(monkeypatch) -> list:
    """Record every call that reaches the wrapper (each passes _check)."""
    calls = []
    check = bc._check

    def spy(*args):
        calls.append(args[0].shape)
        return check(*args)
    monkeypatch.setattr(bc, "_check", spy)
    return calls


@pytest.mark.parametrize("c", [64, 96])
@pytest.mark.parametrize("b", [1, 8])
def test_fused_restore_on_cpu_is_the_chain_bit_for_bit(c, b):
    baf, split, sel = _system(c)
    codes, mins, maxs = _codes(b, HW, c, seed=b)
    want = _chain_restore(baf, split, sel, codes, mins, maxs)
    got = restore_codes_fused(baf, split, sel, codes, mins, maxs, bits=BITS)
    assert got.shape == (b, HW, HW, P) and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _conv_args(cin=8, cout=16, h=6):
    g = torch.Generator().manual_seed(3)
    return (torch.randn((2, h, h, cin), generator=g),
            torch.randn((cout, cin, 3, 3), generator=g),
            torch.randn((cout,), generator=g))


@pytest.mark.parametrize("bad", ["rank", "dtype", "weight_dtype", "strided",
                                 "device", "bias_shape", "kernel_size",
                                 "channels", "stride", "prelu_and_bn",
                                 "grad"])
def test_wrapper_refuses(bad):
    x, w, bias = _conv_args()
    kw = {}
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x = x.double()
    elif bad == "weight_dtype":
        w = w.half()
    elif bad == "strided":
        x = x.transpose(1, 2)
    elif bad == "device":
        w = w.to("meta")
    elif bad == "bias_shape":
        bias = bias[:-1]
    elif bad == "kernel_size":
        w = w[..., :1, :1].contiguous()
    elif bad == "channels":
        w = torch.randn((16, 7, 3, 3))
    elif bad == "stride":
        kw = dict(stride=1, transposed=True)
    elif bad == "prelu_and_bn":
        kw = dict(alpha=torch.ones(16),
                  bn={k: torch.ones(16) for k in bc.BN_KEYS})
    elif bad == "grad":
        w.requires_grad_(True)
    with pytest.raises(ValueError):
        bc.baf_conv(x, w, bias, **kw)


def test_cpu_restore_launches_nothing():
    baf, split, sel = _system(64)
    restore_codes_fused(baf, split, sel, *_codes(2, HW, 64), bits=BITS)
    assert _build.BAF_CONV.launches == 0


def test_trainer_path_never_reaches_the_wrapper(monkeypatch):
    """``baf_conv_predict`` with gradients (the BaF trainer's call) runs
    nn.py's convolutions; the fused restore makes five wrapper calls."""
    calls = _spy(monkeypatch)
    baf, split, sel = _system(64)
    baf.requires_grad_(True)
    codes, mins, maxs = _codes(2, HW, 64)
    z_hat = dequantize(codes, QuantParams(mins, maxs, BITS))
    loss = baf_conv_predict(baf, split, sel, z_hat).square().mean()
    loss.backward()
    assert calls == []
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in baf.parameters())
    restore_codes_fused(baf, split, sel, codes, mins, maxs, bits=BITS)
    assert len(calls) == 5


@pytest.mark.parametrize("consolidation", [True, False])
def test_unfused_restore_never_reaches_the_wrapper(monkeypatch,
                                                   consolidation):
    calls = _spy(monkeypatch)
    baf, split, sel = _system(64)
    restore_codes(baf, split, sel, *_codes(2, HW, 64), bits=BITS,
                  consolidation=consolidation)
    assert calls == []


@pytest.mark.parametrize("c", [64, 96])
def test_program_counts_on_cpu_are_the_chains(c):
    """CPU tensors: the plain chain's ATen ops are counted as they were,
    op by op; the consolidate kernel is the one charge."""
    baf, split, sel = _system(c)
    args = (baf, split, sel, *_codes(2, HW, c))
    got = analyze_program(lambda: restore_codes_fused(*args, bits=BITS))
    want = analyze_program(lambda: _chain_restore(*args))
    assert got == want
    assert [k["name"] for k in got["kernels"]] == ["consolidate"]


def _conv_flops(n, ho, wo, cin, cout):
    return 2 * n * ho * wo * 9 * cin * cout


@pytest.mark.parametrize("c", [64, 96])
def test_program_counts_on_meta_are_the_chains(c):
    """meta tensors: the five convolutions are five ``baf_conv`` charges
    whose products are the ones nn.py's convolutions count (the transposed
    conv over its input), and the output has the chain's shape."""
    baf, split, sel = _system(c, device="meta")
    b = 4
    z_hat = torch.empty((b, HW, HW, c), device="meta")
    got = analyze_program(lambda: restore_convs(baf, split, sel, z_hat))
    with torch.no_grad():
        want = analyze_program(
            lambda: baf_conv_predict(baf, split, sel, z_hat))
    hw2 = 2 * HW
    assert got["flops"] == want["flops"] == (
        _conv_flops(b, HW, HW, c, HIDDEN)
        + 2 * _conv_flops(b, hw2, hw2, HIDDEN, HIDDEN)
        + _conv_flops(b, hw2, hw2, HIDDEN, Q) + _conv_flops(b, HW, HW, Q, P))
    assert [k["name"] for k in got["kernels"]] == ["baf_conv"] * 5
    assert sum(k["flops"] for k in got["kernels"]) == got["flops"]
    out = restore_convs(baf, split, sel, z_hat)
    assert out.device.type == "meta" and tuple(out.shape) == (b, HW, HW, P)


# ---------------------------------------------------------------------------
# The kernel's layout and index map, emulated on the CPU
# ---------------------------------------------------------------------------

def _read_back(wp, cin, cout):
    """The GEMM's B (tap, Cin, Cout) in float64 as the kernel reads
    ``prepare_weights``' layout: k-step 2h + e of a chunk takes, in its k
    columns t and t + 4, channels 16h + 4t + 2e and + 1 of the chunk, each
    its high part plus its remainder."""
    ntiles, taps, chunks = wp.shape[:3]
    v = wp.double()
    pairs = v[..., 0:2] + v[..., 2:4]     # (..., ks, column, t, pair)
    pairs = pairs.reshape(ntiles, taps, chunks, 2, 2, bc.BN, 4, 2)
    # (ntile, tap, chunk, h, e, column, t, pair) -> (tap, chunk, h, t, e,
    # pair, ntile, column)
    m = pairs.permute(1, 2, 3, 6, 4, 7, 0, 5).reshape(
        taps, chunks * bc.BK, ntiles * bc.BN)
    return m[:, :cin, :cout]


def _emulate(x, weight, bias, *, stride, transposed, alpha=None, bn=None):
    """``csrc/baf_conv.cu``'s GEMM in float64: per parity class (one for a
    regular conv) its rows (b, my, mx) take, through tap (py + 2 ey, px +
    2 ex) (or (ey, ex)), input pixel (iy0 + ey, ix0 + ex) with iy0 = my +
    py - 1 (or stride my - pad_t), zeros outside; B read back from
    ``prepare_weights``; then the epilogue."""
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    wm = _read_back(bc.prepare_weights(weight), cin, cout)
    _, oh, ow, _ = bc.out_shape(x, weight, stride=stride,
                                transposed=transposed)
    pad_t = 0 if transposed else tnn._same_pads(h, 3, stride)[0]
    pad_l = 0 if transposed else tnn._same_pads(w, 3, stride)[0]
    xd = x.double()
    out = torch.zeros((b, oh, ow, cout), dtype=torch.float64)
    classes = [(py, px) for py in (0, 1) for px in (0, 1)] if transposed \
        else [(0, 0)]
    for py, px in classes:
        mh, mw = (h, w) if transposed else (oh, ow)
        my = torch.arange(mh)[:, None]
        mx = torch.arange(mw)[None, :]
        iy0 = my + py - 1 if transposed else my * stride - pad_t
        ix0 = mx + px - 1 if transposed else mx * stride - pad_l
        ny, nx = (2 - py, 2 - px) if transposed else (3, 3)
        acc = torch.zeros((b, mh, mw, cout), dtype=torch.float64)
        for ey in range(ny):
            for ex in range(nx):
                tap = (py + 2 * ey) * 3 + px + 2 * ex if transposed \
                    else 3 * ey + ex
                iy, ix = iy0 + ey, ix0 + ex
                inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                a = xd[:, iy.clamp(0, h - 1), ix.clamp(0, w - 1), :]
                acc += (a * inside[None, :, :, None]) @ wm[tap]
        if transposed:
            out[:, py::2, px::2] = acc
        else:
            out = acc
    if bias is not None:
        out = out + bias.double()
    if alpha is not None:
        out = torch.where(out >= 0, out, alpha.double() * out)
    if bn is not None:
        out = tnn.batchnorm_apply({k: t.double() for k, t in bn.items()},
                                  out)
    return out


def _epilogue_args(kind, cout, gen):
    bias = None if kind == "bn" else torch.randn((cout,), generator=gen)
    alpha = torch.rand((cout,), generator=gen) * 0.5 if kind == "prelu" \
        else None
    bn = None
    if kind == "bn":
        bn = {"mean": torch.randn((cout,), generator=gen) * 0.1,
              "var": torch.rand((cout,), generator=gen) + 0.5,
              "scale": torch.rand((cout,), generator=gen) + 0.5,
              "bias": torch.randn((cout,), generator=gen) * 0.1}
    return bias, alpha, bn


# (H = W, Cin, Cout, stride, transposed, epilogue): the restore's five
# kinds at small H, odd and even sizes, odd channel counts, several column
# tiles
EMULATED = [(5, 64, 64, 2, True, "prelu"), (6, 96, 64, 2, True, "prelu"),
            (7, 5, 7, 2, True, "prelu"), (9, 64, 64, 1, False, "prelu"),
            (8, 64, 128, 1, False, "bias"), (9, 33, 70, 1, False, "bias"),
            (8, 128, 256, 2, False, "bn"), (9, 128, 256, 2, False, "bn"),
            (7, 3, 5, 2, False, "bn")]


@pytest.mark.parametrize("shape", EMULATED)
def test_kernel_index_map_emulated_against_the_plain_conv(shape):
    h, cin, cout, stride, transposed, kind = shape
    gen = torch.Generator().manual_seed(h * 1000 + cin)
    x = torch.randn((2, h, h, cin), generator=gen)
    w = tnn.he_normal((cout, cin, 3, 3), 9 * cin, gen)
    bias, alpha, bn = _epilogue_args(kind, cout, gen)
    got = _emulate(x, w, bias, stride=stride, transposed=transposed,
                   alpha=alpha, bn=bn)
    want = bc.baf_conv_plain(
        x.double(), w.double(), None if bias is None else bias.double(),
        stride=stride, transposed=transposed,
        alpha=None if alpha is None else alpha.double(),
        bn=None if bn is None else {k: t.double() for k, t in bn.items()})
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_prepared_weights_split_each_weight_into_two_tf32_parts():
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((70, 33, 3, 3), generator=gen)
    wp = bc.prepare_weights(w)
    assert wp.shape == (2, 9, 2, 4, bc.BN, 4, 4) and wp.is_contiguous()
    low = wp.view(torch.int32) & 0x1FFF
    assert int(low.abs().sum()) == 0              # both parts are TF32
    back = _read_back(wp, 33, 70)
    want = w.double().permute(2, 3, 1, 0).reshape(9, 33, 70)
    torch.testing.assert_close(back, want, atol=0.0, rtol=2.0 ** -22)
    padded = _read_back(wp, 64, 128)              # channels and columns
    assert float(padded[:, 33:].abs().sum()) == 0.0     # past the weight's
    assert float(padded[:, :, 70:].abs().sum()) == 0.0


def test_prepared_weights_follow_in_place_updates():
    gen = torch.Generator().manual_seed(1)
    conv = tnn.Conv2d(8, 16, 3, gen=gen)
    first = bc.prepared_weights(conv.weight)
    assert bc.prepared_weights(conv.weight) is first
    with torch.no_grad():
        conv.weight.mul_(2.0)
    second = bc.prepared_weights(conv.weight)
    assert second is not first
    torch.testing.assert_close(_read_back(second, 8, 16),
                               2 * _read_back(first, 8, 16))
    conv.weight.data = torch.randn((16, 8, 3, 3), generator=gen)
    third = bc.prepared_weights(conv.weight)
    torch.testing.assert_close(
        _read_back(third, 8, 16),
        conv.weight.double().permute(2, 3, 1, 0).reshape(9, 8, 16),
        atol=0.0, rtol=2.0 ** -22)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _float32_cudnn():
    """cuDNN's float32 convolutions without TF32, as the configurations
    state."""
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = flags


# (label, H = W of the input, Cin, Cout, stride, transposed, epilogue):
# every conv of both configurations (c3 has c2's shape; C=96 changes up)
PATH_CONVS = [("up_c64", 64, 64, 64, 2, True, "prelu"),
              ("up_c96", 64, 96, 64, 2, True, "prelu"),
              ("c2_c3", 128, 64, 64, 1, False, "prelu"),
              ("c4", 128, 64, 128, 1, False, "bias"),
              ("split", 128, 128, 256, 2, False, "bn")]


def _kernel_case(dev, b, h, cin, cout, stride, transposed, kind, *,
                 offset=0):
    gen = torch.Generator().manual_seed(b * 7919 + h * 31 + cin)
    x = torch.randn((b * h * h * cin + offset,), generator=gen)
    x = x.to(dev)[offset:].view(b, h, h, cin)
    w = tnn.he_normal((cout, cin, 3, 3), 9 * cin, gen).to(dev)
    bias, alpha, bn = (None if t is None else
                       {k: v.to(dev) for k, v in t.items()}
                       if isinstance(t, dict) else t.to(dev)
                       for t in _epilogue_args(kind, cout, gen))
    before = _build.BAF_CONV.launches
    with torch.no_grad():
        got = bc.baf_conv(x, w, bias, stride=stride, transposed=transposed,
                          alpha=alpha, bn=bn)
    torch.cuda.synchronize()
    assert _build.BAF_CONV.launches == before + 1
    want = bc.baf_conv_plain(
        x.double(), w.double(), None if bias is None else bias.double(),
        stride=stride, transposed=transposed,
        alpha=None if alpha is None else alpha.double(),
        bn=None if bn is None else {k: t.double() for k, t in bn.items()})
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == want.shape
    torch.testing.assert_close(got.double(), want, **KERNEL_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("conv", PATH_CONVS, ids=[c[0] for c in PATH_CONVS])
def test_kernel_against_float64_at_the_path_shapes(cuda, conv, b):
    _kernel_case(cuda, b, *conv[1:])


# ragged rows (not a multiple of the 128-row block), odd and small channel
# counts (the 4-byte copy path, masked columns), a misaligned input
RAGGED = [(3, 37, 64, 64, 2, True, "prelu", 0),
          (3, 37, 64, 128, 1, False, "bias", 0),
          (3, 37, 128, 256, 2, False, "bn", 0),
          (2, 21, 5, 7, 2, True, "prelu", 0),
          (2, 21, 33, 70, 1, False, "bias", 0),
          (1, 19, 3, 5, 2, False, "bn", 0),
          (2, 21, 64, 64, 1, False, "prelu", 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RAGGED)
def test_kernel_against_float64_ragged(cuda, case):
    *shape, offset = case
    _kernel_case(cuda, *shape, offset=offset)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [64, 96])
@pytest.mark.parametrize("b", [1, 8])
def test_restore_on_the_card_against_the_cudnn_chain(cuda, c, b):
    """The full restore at the path's width (64x64 split, Q=128, P=256)
    against the cuDNN chain it replaced, within the judge's margin (1e-4 of
    the largest |z~|); five launches a restore, and the same bits on a
    second run."""
    baf, split, sel = _system(c, device=cuda)
    codes, mins, maxs = _codes(b, 64, c, seed=c + b, device=cuda)
    with _float32_cudnn():
        want = _chain_restore(baf, split, sel, codes, mins, maxs)
        before = _build.BAF_CONV.launches
        got = restore_codes_fused(baf, split, sel, codes, mins, maxs,
                                  bits=BITS)
        torch.cuda.synchronize()
        assert _build.BAF_CONV.launches - before == 5
        again = restore_codes_fused(baf, split, sel, codes, mins, maxs,
                                    bits=BITS)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    gap = float((got - want).abs().max()) / float(want.abs().max())
    assert gap < 1e-4, gap


@pytest.mark.gpu
def test_restore_sees_an_in_place_weight_update(cuda):
    """An in-place update of the BaF weights (as the trainer's step makes)
    is used by the next restore: the prepared weights are not stale."""
    baf, split, sel = _system(64, device=cuda)
    codes, mins, maxs = _codes(2, 64, 64, seed=5, device=cuda)
    with _float32_cudnn():
        first = restore_codes_fused(baf, split, sel, codes, mins, maxs,
                                    bits=BITS)
        with torch.no_grad():
            baf.c2.weight.mul_(-0.5)
            split.conv.weight.add_(0.01)
        second = restore_codes_fused(baf, split, sel, codes, mins, maxs,
                                     bits=BITS)
        want = _chain_restore(baf, split, sel, codes, mins, maxs)
    assert not torch.allclose(first, second)
    gap = float((second - want).abs().max()) / float(want.abs().max())
    assert gap < 1e-4, gap
