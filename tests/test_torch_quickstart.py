"""The port of ``examples/quickstart.py`` (``repro_torch.launch.quickstart``)
against the example's own steps in the JAX package.

Both are fed the same numpy inputs from ``make_inputs``: the layer input,
the split conv's weight and the BaF predictor's weights (the JAX package's
layout, bridged into the port), and the same split activation z (the JAX
conv's; a last-bit difference in z can move a code). The selected
channels, codes, side info, wire bits and container bytes are identical,
the printed lines too (but the pointer to the trainer), z~ is within 1e-4
of the reference's largest entry, and the consolidated channels lie inside
their bins.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import nn
from repro.core import codec as jwire
from repro.core.baf import baf_conv_predict
from repro.core.quant import (QuantParams, bin_bounds, compute_quant_params,
                              dequantize, quantize)
from repro.core.selection import correlation_matrix_conv, select_channels
from repro.core.tiling import tile_batch, untile_batch
from repro_torch.launch import quickstart

B, H, W, P, Q, C, BITS = (quickstart.B, quickstart.H, quickstart.W,
                          quickstart.P, quickstart.Q, quickstart.C,
                          quickstart.BITS)


def jax_quickstart(x, conv_w, baf):
    """``examples/quickstart.py``'s steps on given numpy inputs."""
    lines = []
    x = jnp.asarray(x)
    conv = {"w": jnp.asarray(conv_w)}
    bn = nn.init_batchnorm(P)
    z = nn.batchnorm_apply(bn, nn.conv_apply(conv, x, stride=2))
    lines.append(f"split tensor Z: {z.shape}, raw fp32 = {z.size * 32:,} bits")
    rho = correlation_matrix_conv(z, x)
    order = select_channels(rho).order
    sel = jnp.asarray(order[:C])
    lines.append(f"selected C={C} of P={P} channels: "
                 f"{np.asarray(sel)[:8]}...")
    z_sel = z[..., sel]
    qp = compute_quant_params(z_sel, BITS, per_example=True)
    codes = quantize(z_sel, qp)
    tiled = np.asarray(tile_batch(codes)).reshape(-1, 4 * W)
    enc = jwire.encode(tiled, qp, backend="zlib")
    blob = enc.to_bytes()
    lines.append(f"wire: {enc.total_bits():,} bits "
                 f"({8 * len(enc.side_info):,} side info) -> "
                 f"{1 - enc.total_bits() / (z.size * 32):.1%} smaller than "
                 f"raw fp32")
    stream, qp_rx = jwire.decode(jwire.EncodedTensor.from_bytes(blob))
    codes_rx = untile_batch(jnp.asarray(stream.reshape(B, -1, 4 * W)), C)
    qp_rx = QuantParams(mins=jnp.asarray(qp_rx.mins).reshape(B, 1, 1, C),
                        maxs=jnp.asarray(qp_rx.maxs).reshape(B, 1, 1, C),
                        bits=BITS)
    z_hat_sel = dequantize(codes_rx, qp_rx)
    lines.append(f"decode exact: {bool(jnp.all(codes_rx == codes))}, "
                 f"dequant err <= step/2: "
                 f"{float(jnp.max(jnp.abs(z_hat_sel - z_sel))):.4f}")
    z_tilde = baf_conv_predict(jax.tree.map(jnp.asarray, baf), conv, bn, sel,
                               z_hat_sel, codes=codes_rx, qp=qp_rx)
    lines.append(f"restored all-P tensor: {z_tilde.shape} (untrained "
                 f"predictor; examples/split_inference.py trains it end to "
                 f"end)")
    lo, hi = bin_bounds(codes_rx, qp_rx)
    inside = bool(jnp.all((z_tilde[..., sel] >= lo - 1e-4)
                          & (z_tilde[..., sel] <= hi + 1e-4)))
    lines.append(f"eq. (6) consolidation holds on transmitted channels: "
                 f"{inside}")
    return dict(lines=lines, sel=np.asarray(sel), codes=np.asarray(codes),
                mins=np.asarray(qp.mins), maxs=np.asarray(qp.maxs),
                side_info=enc.side_info, wire_bits=enc.total_bits(),
                blob=blob, z=np.asarray(z), z_tilde=np.asarray(z_tilde))


@pytest.fixture(scope="module", params=[0, 7])
def both(request):
    inputs = quickstart.make_inputs(request.param)
    want = jax_quickstart(*inputs)
    got = quickstart.run(*inputs, device="cpu", z=want["z"])
    return inputs, want, got


def test_codes_side_info_and_wire_bytes_are_identical(both):
    _, want, got = both
    assert np.array_equal(got["sel"], want["sel"])
    assert got["codes"].dtype == want["codes"].dtype == np.uint8
    assert np.array_equal(got["codes"], want["codes"])
    for k in ("mins", "maxs"):
        assert got[k].dtype == np.float16
        assert np.array_equal(got[k].view(np.uint16),
                              want[k].view(np.uint16))
    assert got["side_info"] == want["side_info"]
    assert got["wire_bits"] == want["wire_bits"]
    assert got["blob"] == want["blob"]


def test_printed_lines_are_the_examples(both):
    _, want, got = both
    assert got["lines"][:4] + got["lines"][5:] == \
        want["lines"][:4] + want["lines"][5:]
    assert got["lines"][4].split(" (")[0] == want["lines"][4].split(" (")[0]
    assert got["lines"][-1].endswith("True")


def test_restored_tensor_and_consolidation(both):
    _, want, got = both
    tol = 1e-4 * float(np.abs(want["z_tilde"]).max())
    np.testing.assert_allclose(got["z_tilde"], want["z_tilde"], rtol=0,
                               atol=tol)
    # the transmitted channels inside their received bins
    step = (want["maxs"].astype(np.float32) - want["mins"].astype(np.float32)
            ) / ((1 << BITS) - 1)
    lo = want["mins"].astype(np.float32) + (got["codes"] - 0.5) * step
    hi = want["mins"].astype(np.float32) + (got["codes"] + 0.5) * step
    kept = got["z_tilde"][..., got["sel"]]
    assert ((kept >= lo - 1e-4) & (kept <= hi + 1e-4)).all()
    assert got["inside"]


def test_split_forward_matches_the_reference(both):
    """Without z given, the port's split conv + BN gives the JAX z."""
    inputs, want, _ = both
    own = quickstart.run(*inputs, device="cpu")
    np.testing.assert_allclose(own["z"], want["z"], rtol=1e-5, atol=1e-5)
    assert own["inside"]


def test_launcher_prints_the_six_lines(capsys):
    assert quickstart.main(["--device", "cpu", "--seed", "3"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 6
    assert out[0] == f"split tensor Z: ({B}, {H}, {W}, {P}), raw fp32 = " \
        f"{B * H * W * P * 32:,} bits"
    assert out[3].startswith("decode exact: True")
    assert out[-1] == "eq. (6) consolidation holds on transmitted channels: " \
        "True"
