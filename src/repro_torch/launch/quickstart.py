"""Quickstart: the paper's pipeline on one tensor.

Port of ``examples/quickstart.py``:

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
      [--seed N]

Takes a feature tensor, selects the most-correlated channel subset (eqs.
2-3), quantizes it (eq. 4, the quantize kernel), tiles and zlib-codes it
(§3.2), decodes it (eq. 5), restores the full tensor with an (untrained)
BaF predictor (§3.3) and consolidates the transmitted channels (eq. 6, the
consolidate kernel), printing real wire bits at every stage. It runs on the
card unless ``--device`` names another; the inputs (the layer input, the
split conv's weights and the predictor's) are drawn from ``--seed`` with
numpy, in the JAX package's layouts.
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from repro_torch.bridge import baf_from_jax
from repro_torch.core import codec as wire
from repro_torch.core.baf import BaFConvConfig
from repro_torch.core.quant import QuantParams, bin_bounds, dequantize
from repro_torch.core.selection import correlation_matrix_conv, select_channels
from repro_torch.core.split import restore_codes_fused, to_device
from repro_torch.core.tiling import tile_batch, untile_batch
from repro_torch.device import resolve_device
from repro_torch.kernels.quantize import quantize_fused
from repro_torch.models.cnn import ConvBN

B, H, W, P, Q, C, BITS = 2, 16, 16, 64, 32, 16, 8
HIDDEN = 32                     # width of the BaF predictor


def make_inputs(seed: int = 0):
    """(x (B, 2H, 2W, Q), the split conv's (3, 3, Q, P) weight, the BaF
    predictor's weights as the JAX package's ``init_baf_conv`` lays them
    out), numpy float32, He-normal weights, zero biases, PReLU 0.25."""
    rng = np.random.default_rng(seed)

    def he(cin, cout):
        std = math.sqrt(2.0 / (cin * 9))
        return (rng.standard_normal((3, 3, cin, cout)) * std).astype(
            np.float32)

    x = rng.standard_normal((B, 2 * H, 2 * W, Q)).astype(np.float32)
    conv_w = he(Q, P)
    baf = {}
    for name, cin, cout in (("up", C, HIDDEN), ("c2", HIDDEN, HIDDEN),
                            ("c3", HIDDEN, HIDDEN), ("c4", HIDDEN, Q)):
        baf[name] = {"w": he(cin, cout), "b": np.zeros(cout, np.float32)}
        if name != "c4":
            baf[name + "_act"] = {"alpha": np.full(cout, 0.25, np.float32)}
    return x, conv_w, baf


def run(x, conv_w, baf, *, device=None, z=None) -> dict:
    """The example's steps on ``device`` (``None`` = the card). ``z``, the
    split activation (B, H, W, P), replaces the split layer's forward when
    given (so two runs can be held to the same z). Returns the printed
    ``lines`` and the intermediate values (host numpy)."""
    dev = resolve_device(device)
    split = ConvBN(Q, P, 3)
    with torch.no_grad():
        split.conv.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(np.transpose(conv_w, (3, 2, 0, 1)))))
    split = split.to(dev).eval()
    predictor = baf_from_jax(baf, BaFConvConfig(c=C, q=Q, hidden=HIDDEN),
                             device=dev).eval()
    lines = []
    with torch.no_grad():
        xt = to_device(x, dev)
        z = split(xt, 2) if z is None else to_device(z, dev)
        lines.append(f"split tensor Z: {tuple(z.shape)}, raw fp32 = "
                     f"{z.numel() * 32:,} bits")

        # 1. channel selection (offline, eqs. 2-3)
        order = select_channels(correlation_matrix_conv(z, xt)).order
        sel = order[:C]
        lines.append(f"selected C={C} of P={P} channels: {sel[:8]}...")
        sel_t = torch.as_tensor(sel.astype(np.int32), device=dev)

        # 2. quantize (eq. 4, the quantize kernel) + tile (§3.2) + code
        codes, mins, maxs = quantize_fused(z.contiguous().view(B, H * W, P),
                                           BITS, sel_t)
        codes = codes.view(B, H, W, C)
        qp = QuantParams(mins=mins.cpu().reshape(B, 1, 1, C),
                         maxs=maxs.cpu().reshape(B, 1, 1, C), bits=BITS)
        tiled = tile_batch(codes.cpu()).numpy().reshape(-1, 4 * W)
        enc = wire.encode(tiled, qp, backend="zlib")   # 4x4 grid for C=16
        blob = enc.to_bytes()
        raw = z.numel() * 32
        lines.append(f"wire: {enc.total_bits():,} bits "
                     f"({8 * len(enc.side_info):,} side info) -> "
                     f"{1 - enc.total_bits() / raw:.1%} smaller than raw "
                     f"fp32")

        # 3. cloud: decode (eq. 5) + BaF restore (§3.3) + consolidation
        # (eq. 6, the consolidate kernel)
        stream, qp_rx = wire.decode(wire.EncodedTensor.from_bytes(blob))
        codes_rx = untile_batch(torch.from_numpy(
            stream.reshape(B, -1, 4 * W)), C).contiguous().to(dev)
        mins_rx = torch.from_numpy(np.array(qp_rx.mins, np.float16)) \
            .reshape(B, 1, 1, C).to(dev)
        maxs_rx = torch.from_numpy(np.array(qp_rx.maxs, np.float16)) \
            .reshape(B, 1, 1, C).to(dev)
        qp_rx = QuantParams(mins=mins_rx, maxs=maxs_rx, bits=BITS)
        z_sel = z[..., sel_t.long()]
        z_hat_sel = dequantize(codes_rx, qp_rx)
        lines.append(f"decode exact: {bool(torch.equal(codes_rx, codes))}, "
                     f"dequant err <= step/2: "
                     f"{float((z_hat_sel - z_sel).abs().max()):.4f}")
        z_tilde = restore_codes_fused(predictor, split, sel_t, codes_rx,
                                      mins_rx, maxs_rx, bits=BITS)
        lines.append(f"restored all-P tensor: {tuple(z_tilde.shape)} "
                     f"(untrained predictor; python -m "
                     f"repro_torch.launch.split_inference trains it end to "
                     f"end)")
        # the transmitted channels are consolidated: they sit inside
        # their bins
        lo, hi = bin_bounds(codes_rx, qp_rx)
        kept = z_tilde[..., sel_t.long()]
        inside = bool(((kept >= lo - 1e-4) & (kept <= hi + 1e-4)).all())
        lines.append(f"eq. (6) consolidation holds on transmitted channels: "
                     f"{inside}")
    return dict(lines=lines, sel=sel, codes=codes.cpu().numpy(),
                mins=qp.mins.numpy(), maxs=qp.maxs.numpy(),
                side_info=enc.side_info, wire_bits=enc.total_bits(),
                blob=blob, z=z.cpu().numpy(), z_tilde=z_tilde.cpu().numpy(),
                inside=inside)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = run(*make_inputs(args.seed), device=args.device)
    for line in res["lines"]:
        print(line)
    return 0 if res["inside"] else 1


if __name__ == "__main__":
    sys.exit(main())
