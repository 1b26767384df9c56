#!/usr/bin/env python3
"""Time the port's six kernels on the card, for one checkout.

    python3 tools/kernel_times.py [--src ROOT] [--phases | --plans | --lm]

Needs one CUDA device and nvcc. Times, with ``chip_smoke.py``'s profiler
helper (device time and device operations per call, 20 calls after a warm
call), the kernels of the checkout at ROOT (default: this one), built from
ROOT's ``src/repro_torch/csrc`` into ROOT's ``build/repro_torch``, at the
shapes ``chip_smoke.py`` times them:

  - quantize at B=1 (one request) and B=8: R=64*64, P=256, C=64, 8 bits,
    the same random selection for every ROOT (with its channel table
    computed once, as the compression plan does, where ROOT has one);
  - histogram on uniform 8-bit codes at K=4096 and K=32768 (C=64), and on
    the path's own codes: the quantize kernel's codes of the edge CNN's z
    (the paper's geometry, seeded random weights and image, as
    ``chip_smoke.py`` builds them);
  - consolidate at B=8 (with the channel table computed once, where ROOT's
    wrapper takes one);
  - cdf at S=256, C=64 on row-major (S, C) counts, the layout every ROOT
    takes, and through the (S, C) views of (C, S) buffers where ROOT's
    wrapper takes them (the cdf path's layout); then one request of the
    cdf path, ``channel_histogram_cdf`` on the path's codes: its device
    time and device operations;
  - flash attention and the linear scan (prefill and ingest block) through
    ``chip_smoke.time_lm_kernels`` (the scan at zamba2's chunk of 128 only
    where ROOT's scan kernel takes it, and there with a per-channel decay
    too); ``--lm`` times these alone.

So two checkouts can be compared on one card, with one way of reading the
profiler, by running this script in turns, e.g. with the parent unpacked
under ``build/parent``::

    python3 tools/kernel_times.py --src build/parent
    python3 tools/kernel_times.py
    python3 tools/kernel_times.py
    python3 tools/kernel_times.py --src build/parent

``--phases`` instead times probes of this checkout's quantize and
histogram kernels at the path's shapes, each built to stop after one of
its phases (their outputs are wrong; they only split the time).
``--plans`` times this checkout's consolidate kernel at B=1 and B=8 under
tiles of 4 to 128 rows, beside the plan the wrapper picks.
"""
from __future__ import annotations

import argparse
import inspect
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (the helpers; imports no torch yet)

def path_codes(dev):
    """(K, C) uint8 codes of request 0 of chip_smoke's main path."""
    import torch
    from repro_torch.configs.yolo_baf import full_config
    from repro_torch.kernels.quantize import quantize_fused
    model, _, spec, _, imgs = cs.build_system(dev, full_config())
    with torch.no_grad():
        z = model.edge(imgs[:1].to(dev))[1].contiguous()
    n, h, w, p = z.shape
    sel = torch.as_tensor(np.asarray(spec.sel_idx, np.int32), device=dev)
    codes = quantize_fused(z.view(n, h * w, p), cs.BITS, sel)[0]
    del model
    return codes.view(h * w, cs.C)


def report(label, fn):
    ms, ops = cs.device_ms(fn)
    print(f"time {label}: device {ms!r} ms per call, {ops!r} device "
          f"operations per call")
    return ms


def takes(fn, keyword: str) -> bool:
    return keyword in inspect.signature(fn).parameters


def time_lm(dev, gen) -> None:
    """flash and the linear scan at chip_smoke's shapes."""
    from repro_torch.kernels.linear_scan import _smem_floats

    def row(name, src, replaces, kernel, plain, nbytes, library, note,
            **_):
        print(f"time {name} ({note}): device {kernel[0]!r} ms per call, "
              f"{kernel[2]!r} device operations per call")
        return {"name": name}     # the training rows add their backward
    # the scan takes a chunk of 128 with a scalar decay where its shared
    # memory is reckoned by the decay's kind
    cs.time_lm_kernels(dev, row, gen,
                       zamba_scan=takes(_smem_floats, "per_channel"))


def time_checkout(dev) -> None:
    import torch
    from repro_torch.kernels import quantize as quant
    from repro_torch.kernels.consolidate import consolidate_fused
    from repro_torch.kernels.histogram import (cdf, channel_histogram_cdf,
                                               histogram)
    gen = torch.Generator().manual_seed(1)
    sel = torch.randperm(cs.P, generator=gen)[:cs.C].to(torch.int32).to(dev)
    # a checkout whose wrapper takes the channel table gets it once
    kw = {"order": quant.channel_order(sel)} \
        if hasattr(quant, "channel_order") else {}
    ckw = kw if takes(consolidate_fused, "order") else {}
    for b in (1, cs.B):
        x = torch.randn((b, cs.R, cs.P), generator=gen).to(dev)
        report(f"quantize B={b} R={cs.R} P={cs.P} C={cs.C}",
               lambda: quant.quantize_fused(x, cs.BITS, sel, **kw))
    for k in (cs.R, cs.B * cs.R):
        codes = torch.randint(0, 256, (k, cs.C), generator=gen,
                              dtype=torch.uint8).to(dev)
        report(f"histogram K={k} C={cs.C} uniform",
               lambda: histogram(codes, 256))
    pcodes = path_codes(dev)
    report(f"histogram K={cs.R} C={cs.C} path codes",
           lambda: histogram(pcodes, 256))
    z = torch.randn((cs.B, cs.R, cs.P), generator=gen).to(dev)
    codes, mins, maxs = quant.quantize_fused(z, cs.BITS, sel)
    est = z + 0.3 * torch.randn((cs.B, cs.R, cs.P), generator=gen).to(dev)
    report(f"consolidate B={cs.B} R={cs.R} P={cs.P} C={cs.C}"
           f"{' with the channel table' if ckw else ''}",
           lambda: consolidate_fused(est, codes, mins, maxs, cs.BITS, sel,
                                     **ckw))
    nsym = 1 << cs.BITS
    counts = torch.randint(0, 64, (nsym, cs.C), generator=gen,
                           dtype=torch.int32).to(dev)
    report(f"cdf S={nsym} C={cs.C} row-major", lambda: cdf(counts))
    if takes(cdf, "out"):
        cols = counts.t().contiguous().t()
        dst = torch.empty_like(cols)
        report(f"cdf S={nsym} C={cs.C} through (C, S) views",
               lambda: cdf(cols, out=dst))
    host = pcodes.cpu().numpy()
    report("cdf path, one request: channel_histogram_cdf on the path's "
           "codes", lambda: channel_histogram_cdf(host, cs.BITS, device=dev))

    time_lm(dev, gen)


def variant(kernel, edits, tag: str):
    """``kernel`` built from its source with each (old, new) of ``edits``
    replaced once."""
    from repro_torch.kernels import _build
    src = kernel.source.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{kernel.source.name} no longer holds {old!r}")
        src = src.replace(old, new, 1)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{kernel.name}_{tag}.cu"
    cu.write_text(src)
    k = _build.CudaKernel(f"{kernel.name}_{tag}", str(cu), kernel.entries)
    k.start_build()
    return k


# Probes: each kernel stopped after one of its phases (every block stops
# there; values that the phase computed are kept live by a store that never
# happens). Their outputs are wrong; they only split the time.
_Q_STOP = ("  if (R < 0) mins[0] = __float2half_rn(0.0f);\n"
           "  dsm::wait();\n  return;\n")
QUANTIZE_PHASES = {
    "launch only": [("  // 1. lanes over the group's slots",
                     _Q_STOP + "  // 1. lanes over the group's slots")],
    "+ channel table": [("  const int r0 = rank * rows_per_block;",
                         "  if (p == -7 || c == -7) R = -1;\n" + _Q_STOP
                         + "  const int r0 = rank * rows_per_block;")],
    "+ load x": [("  for (int off = group; off < 32; off <<= 1) {",
                  "  if (mn == 1.2345f || mx == 1.2345f) R = -1;\n"
                  + _Q_STOP
                  + "  for (int off = group; off < 32; off <<= 1) {")],
    "+ block min/max": [("  // 3. this block's partials",
                         "  if (s_mn[t & 7] == 1.2345f) R = -1;\n" + _Q_STOP
                         + "  // 3. this block's partials")],
    "+ cluster min/max, side info": [
        ("  // 4. codes of the values this block holds",
         "  return;\n  // 4. codes of the values this block holds")],
}
_H_STOP = "  if (sh[threadIdx.x] == -5) counts[0] = 1;\n  return;\n"
HISTOGRAM_PHASES = {
    "launch only": [("  for (int i = threadIdx.x; i < (stride >> 2);",
                     "  dsm::wait();\n  if (K >= 0) return;\n"
                     "  for (int i = threadIdx.x; i < (stride >> 2);")],
    "+ zero, count": [("  // 2. each bin to the block that sums it",
                       "  dsm::wait();\n" + _H_STOP
                       + "  // 2. each bin to the block that sums it")],
    "+ cluster barrier": [("  int* recv = sh + stride;",
                           _H_STOP + "  int* recv = sh + stride;")],
    "+ bins to their blocks": [
        ("  int* out = counts + (size_t)c0 * nsym",
         _H_STOP + "  int* out = counts + (size_t)c0 * nsym")],
}


def time_phases(dev) -> None:
    """Both kernels at the path's shapes with the wrappers' plans, stopped
    after each phase in turn, two rounds."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import quantize as quant
    probes = [(_build.QUANTIZE, f"quantize {name}",
               variant(_build.QUANTIZE, edits, f"phase{i}"))
              for i, (name, edits) in enumerate(QUANTIZE_PHASES.items())]
    probes += [(_build.HISTOGRAM, f"histogram {name}",
                variant(_build.HISTOGRAM, edits, f"phase{i}"))
               for i, (name, edits) in enumerate(HISTOGRAM_PHASES.items())]
    probes += [(_build.QUANTIZE, "quantize full", _build.QUANTIZE),
               (_build.HISTOGRAM, "histogram full", _build.HISTOGRAM)]
    gen = torch.Generator().manual_seed(4)
    sel = torch.randperm(cs.P, generator=gen)[:cs.C].to(torch.int32).to(dev)
    order = quant.channel_order(sel)
    x = torch.randn((1, cs.R, cs.P), generator=gen).to(dev)
    codes = torch.randint(0, 256, (cs.R, cs.C), generator=gen,
                          dtype=torch.uint8).to(dev)
    kept = (_build.QUANTIZE, _build.HISTOGRAM)
    try:
        for rnd in range(2):
            for base, name, k in probes:
                k.finish_build()
                if base is kept[0]:
                    _build.QUANTIZE = k
                    report(f"{name} B=1 (round {rnd})",
                           lambda: quant.quantize_fused(x, cs.BITS, sel,
                                                        order=order))
                else:
                    _build.HISTOGRAM = k
                    report(f"{name} K={cs.R} (round {rnd})",
                           lambda: hist.histogram(codes, 256))
                _build.QUANTIZE, _build.HISTOGRAM = kept
    finally:
        _build.QUANTIZE, _build.HISTOGRAM = kept


def time_plans(dev) -> None:
    """The consolidate kernel at C=64 and 16, B=1 and 8, under tiles of 4
    to 128 rows (threads across a row: every channel); each held bit for
    bit against the plain version first; two rounds."""
    import torch
    from repro_torch.kernels import consolidate as cons
    from repro_torch.kernels.quantize import channel_order, quantize_fused
    gen = torch.Generator().manual_seed(5)
    for c in (cs.C, 16):
        sel = torch.randperm(cs.P, generator=gen)[:c].to(torch.int32).to(dev)
        order = channel_order(sel)
        for rnd in range(2):
            for b in (1, cs.B):
                z = torch.randn((b, cs.R, cs.P), generator=gen).to(dev)
                codes, mins, maxs = quantize_fused(z, cs.BITS, sel,
                                                   order=order)
                est = z + 0.3 * torch.randn((b, cs.R, cs.P),
                                            generator=gen).to(dev)
                want = cons.consolidate_plain(est.clone(), codes, mins, maxs,
                                              cs.BITS, sel.long())
                picked = cons.consolidate_plan(b, cs.R, c)
                for rows in (4, 8, 16, 32, 64, 128):
                    plan = cons.ConsolidatePlan(rows, c)
                    got = cons._launch(est.clone(), codes, mins, maxs,
                                       cs.BITS, order, plan)
                    if not torch.equal(got.view(torch.int32),
                                       want.view(torch.int32)):
                        raise SystemExit(f"{plan} differs from the plain "
                                         "version")
                    mark = " (picked)" if plan == picked else ""
                    report(f"consolidate C={c} B={b} plan {tuple(plan)}"
                           f"{mark} (round {rnd})",
                           lambda: cons._launch(est, codes, mins, maxs,
                                                cs.BITS, order, plan))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--phases", action="store_true",
                    help="time this checkout's kernels stopped after each "
                         "phase")
    ap.add_argument("--plans", action="store_true",
                    help="time this checkout's consolidate kernel under "
                         "other tiles of rows")
    ap.add_argument("--lm", action="store_true",
                    help="time flash attention and the linear scan only")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    root = args.src.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    print(f"device: {cs.nvidia_smi_line()}; kernels of {root}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    if args.phases:
        time_phases(dev)
    elif args.plans:
        time_plans(dev)
    elif args.lm:
        import torch
        time_lm(dev, torch.Generator().manual_seed(1))
    else:
        time_checkout(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
