#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (on PATH or under /usr/local/cuda/bin) and
the ``src/`` tree of this checkout; it imports nothing of JAX or of the JAX
package ``repro``. Phases, each printing lines before the last:

  1. device: card name and power limit, torch and CUDA versions, TF32 flags
     (both set to False, so float32 convolutions are full float32);
  2. build: the three kernels of ``src/repro_torch/csrc``, one nvcc each,
     all started together;
  3. kernels against their plain torch versions on the card, at the
     slice's shapes (B=8, R=64*64, P=256, C=64, bits=8) plus edge cases;
  4. the main path at the paper's full width (YOLO front at 512x512, split
     tensor 64x64x256, C=64, 8 bits, static rANS, fused restore): eight
     one-image requests through edge -> plan.encode -> plan.decode_batch ->
     plan.restore -> cloud, with the kernels' launch counts read over this
     phase alone; the consolidate kernel held bit for bit against its plain
     version on the path's own estimate; the restore checked against the
     plan compiled with fused=False (and bit for bit with
     cudnn.deterministic) and against the same path run on the CPU for the
     first request;
  5. times: each kernel with CUDA events at the main path's shapes (and the
     slice's B=8), beside its memory bound, its plain version and, where
     one PyTorch call computes the same function, that call; per-stage
     request times.

Then one JSON line with every kernel's numbers, the ``nvidia-smi`` name and
power-limit line, and last ``{"ok": true, "device": {...}}``. Any failed
check raises, and the script exits non-zero without that last line. With no
CUDA device it exits 1 at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
B, R, P, C, BITS = 8, 64 * 64, 256, 64, 8
HIDDEN = 64                      # width of the BaF predictor
CONSOLIDATE_ATOL = 1e-5          # the JAX kernel test's tolerance
# The fused and fused=False restores run the same convolutions. With cuDNN's
# default algorithms two runs need not agree to the bit, so the restores of
# the main path are held at the CPU parity tests' 1e-4, and bit for bit when
# rerun with cudnn.deterministic. Card against CPU: 1e-3. Relative and
# absolute.
RESTORE_TOL = 1e-4
CPU_TOL = 1e-3


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time per call between CUDA events around ``iters`` back-to-back
    calls. For a call whose kernels take less time than the host needs to
    launch them, this is the host's launch time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: the summed durations of the kernels, copies and
    memsets ``fn`` puts on the card, from ``torch.profiler``; host launch
    time is not in it. Raises when the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total_us += getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
    if not total_us > 0:
        raise RuntimeError("torch.profiler recorded no CUDA device time")
    return total_us / 1e3 / iters


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_diff(pairs) -> float:
    """Largest |a - b| over (kernel, plain) tensor pairs, in float64."""
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels.consolidate import (consolidate_fused,
                                                 consolidate_plain)
    from repro_torch.kernels.histogram import histogram, histogram_plain
    from repro_torch.kernels.quantize import quantize_fused, quantize_plain

    gen = torch.Generator().manual_seed(0)
    errs = {}

    def quantize_case(b, r, p, c, scale, offset, bits=BITS):
        x = (torch.randn((b, r, p), generator=gen) * scale + offset).to(dev)
        x[0, :, 3] = offset                          # a constant channel
        sel = torch.randperm(p, generator=gen)[:c].to(torch.int32).to(dev)
        got = quantize_fused(x, bits, sel)
        want = quantize_plain(x, bits, sel.long())
        sync(dev)
        ok = all(bits_equal(g, w) for g, w in zip(got, want))
        print(f"quantize B={b} R={r} P={p} C={c} scale={scale:g} "
              f"offset={offset:g}: {'bit-identical' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError("quantize kernel differs from plain version")
        return got, max_abs_diff(zip(got, want))

    (codes, _, _), err = quantize_case(1, R, P, C, 1.0, 0.0)   # main path
    errs["quantize"] = max(
        err,
        quantize_case(B, R, P, C, 1.0, 0.0)[1],               # slice shape
        quantize_case(B, R, P, C, 1e5, -1.0)[1],              # beyond fp16
        quantize_case(2, R, P, C, 1e-7, 0.5)[1],              # fp16 subnormal
        quantize_case(3, 1000, P, 40, 3.0, 0.5, bits=5)[1])   # ragged R, C

    def histogram_case(codes, nsym, label):
        got = histogram(codes, nsym)
        want = histogram_plain(codes, nsym)
        sync(dev)
        ok = bool(torch.equal(got, want))
        print(f"histogram {label} K={codes.shape[0]} C={codes.shape[1]} "
              f"nsym={nsym}: {'exact' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError("histogram kernel differs from plain version")
        return max_abs_diff([(got, want)])

    big = torch.randint(0, 256, (B * R, C), generator=gen, dtype=torch.uint8)
    wide = torch.randint(-2, 4098, (4096, 64), generator=gen,
                         dtype=torch.int32)
    wide[::5] = 4096                                        # padding sentinel
    errs["histogram"] = max(
        histogram_case(codes.view(R, C), 1 << BITS, "u8 main path"),
        histogram_case(big.to(dev), 256, "u8 slice"),
        histogram_case(wide.to(dev), 4096, "i32 bits=12 with sentinels"))

    def consolidate_case(b, r, p, c, bits):
        z = torch.randn((b, r, p), generator=gen).to(dev)
        sel = torch.randperm(p, generator=gen)[:c].to(torch.int32).to(dev)
        codes, mins, maxs = quantize_plain(z, bits, sel.long())
        est = z + 0.3 * torch.randn((b, r, p), generator=gen).to(dev)
        want = consolidate_plain(est.clone(), codes, mins, maxs, bits,
                                 sel.long())
        got = consolidate_fused(est.clone(), codes, mins, maxs, bits, sel)
        sync(dev)
        err = float((got - want).abs().max())
        print(f"consolidate B={b} R={r} P={p} C={c} bits={bits}: max abs "
              f"diff {err!r} (tolerance {CONSOLIDATE_ATOL})")
        if not err <= CONSOLIDATE_ATOL:
            raise AssertionError("consolidate kernel differs from plain")
        return err

    errs["consolidate"] = max(consolidate_case(B, R, P, C, BITS),
                              consolidate_case(3, 1000, 40, 40, 3))
    return errs


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------

def build_system(dev, cfg, seed: int = 0):
    import torch
    from repro_torch import pipeline
    from repro_torch.core.baf import BaFConv, BaFConvConfig
    from repro_torch.models.cnn import CNN

    model = CNN(cfg, seed=seed, device=dev).eval()
    baf = BaFConv(BaFConvConfig(c=C, q=cfg.split_q, hidden=HIDDEN),
                  seed=seed + 1, device=dev).eval()
    sel = np.random.default_rng(seed + 2).permutation(cfg.split_p)[:C]
    spec = pipeline.ModelSpec(sel_idx=sel, params=model, baf_params=baf)
    op = pipeline.OperatingPoint(c=C, bits=BITS, backend="rans")
    gen = torch.Generator().manual_seed(seed + 3)
    imgs = torch.randn((8, cfg.input_size, cfg.input_size, 3), generator=gen)
    return model, baf, spec, op, imgs


def run_requests(dev, model, plan, imgs, registry):
    """Eight one-image requests -> (blobs, decoded, z_tilde, logits, times)."""
    from repro_torch.obs import hooks

    t = {"edge": 0.0, "quantize_histogram_copy": 0.0, "host_rans_encode": 0.0}
    blobs = []
    host_enc = registry.histogram("stage_seconds", stage="pipeline.encode",
                                  backend=plan.op.wire_backend)
    with hooks.active(registry):
        for i in range(imgs.shape[0]):
            img = imgs[i:i + 1].to(dev)
            sync(dev)
            t0 = time.perf_counter()
            z = model.edge(img)[1]
            sync(dev)
            t1 = time.perf_counter()
            before = host_enc.total
            blobs.append(plan.encode(z))
            t2 = time.perf_counter()
            host = host_enc.total - before
            t["edge"] += t1 - t0
            t["host_rans_encode"] += host
            t["quantize_histogram_copy"] += (t2 - t1) - host
        t0 = time.perf_counter()
        decoded = plan.decode_batch(blobs)
        t1 = time.perf_counter()
        z_tilde = plan.restore(decoded)
        sync(dev)
        t2 = time.perf_counter()
        logits = model.cloud(z_tilde)
        sync(dev)
        t3 = time.perf_counter()
    n = imgs.shape[0]
    times = {k: v / n for k, v in t.items()}
    times.update(host_decode_batch=(t1 - t0) / n, restore=(t2 - t1) / n,
                 cloud=(t3 - t2) / n)
    return blobs, decoded, z_tilde, logits, times


def check_consolidate_on_path(dev, model, baf, sel_idx, decoded) -> float:
    """The consolidate kernel against its plain version on the main path's
    own estimate: one z~ of the decoded batch, before eq. (6), clipped by
    each on its own copy. Bit for bit."""
    import torch
    from repro_torch.core.split import restore_codes
    from repro_torch.kernels.consolidate import (consolidate_fused,
                                                 consolidate_plain)

    sel = torch.as_tensor(np.asarray(sel_idx, np.int32), device=dev)
    codes = torch.from_numpy(np.ascontiguousarray(decoded.codes)).to(dev)
    mins = torch.from_numpy(decoded.mins).to(dev)
    maxs = torch.from_numpy(decoded.maxs).to(dev)
    est = restore_codes(baf, model.split, sel, codes, mins, maxs, bits=BITS,
                        consolidation=False).contiguous()
    n, h, w, p = est.shape
    flat = est.view(n, h * w, p)
    args = (codes.view(n, h * w, C), mins.view(n, C), maxs.view(n, C), BITS)
    got = consolidate_fused(flat.clone(), *args, sel)
    want = consolidate_plain(flat.clone(), *args, sel.long())
    sync(dev)
    ok = bits_equal(got, want)
    err = max_abs_diff([(got, want)])
    print(f"consolidate on the main path's z~ {tuple(est.shape)}: kernel vs "
          f"plain {'bit-identical' if ok else 'DIFFERS'} (max abs diff "
          f"{err!r})")
    if not ok:
        raise AssertionError("consolidate kernel differs on the main path")
    return err


def main_path(dev, cfg) -> dict:
    import torch
    from repro_torch import pipeline
    from repro_torch.kernels import _build
    from repro_torch.obs import MetricsRegistry

    model, baf, spec, op, imgs = build_system(dev, cfg)
    plan = pipeline.compile(op, spec, fused=True, device=dev)
    plan_ref = pipeline.compile(op, spec, fused=False, device=dev)
    # warm-up at the same shapes, so cuDNN's choices and the caching
    # allocator are settled before the counted, timed pass
    run_requests(dev, model, plan, imgs, MetricsRegistry())

    _build.reset_launches()
    blobs, decoded, z_tilde, logits, times = run_requests(
        dev, model, plan, imgs, MetricsRegistry())
    launches = {k.name: k.launches for k in _build.KERNELS}
    print(f"main path launches: {launches}")
    n = imgs.shape[0]
    if not (launches["quantize"] == n and launches["histogram"] == n
            and launches["consolidate"] >= 1):
        raise AssertionError(f"main path did not run its kernels: {launches}")

    # checks, after the counts were read
    for i, blob in enumerate(blobs):
        z = model.edge(imgs[i:i + 1].to(dev))[1]
        codes, mins, maxs = plan.quantize(z)
        if not (np.array_equal(decoded.codes[i:i + 1], codes)
                and np.array_equal(decoded.mins[i:i + 1].view(np.uint16),
                                   mins.view(np.uint16))
                and np.array_equal(decoded.maxs[i:i + 1].view(np.uint16),
                                   maxs.view(np.uint16))):
            raise AssertionError(f"request {i}: decoded codes differ")
    print("decoded codes and side info equal the encoder's: yes")
    cons_err = check_consolidate_on_path(dev, model, baf, spec.sel_idx,
                                         decoded)
    ref = plan_ref.restore(decoded)
    diff = float((z_tilde - ref).abs().max())
    print(f"fused restore vs fused=False restore: max abs diff {diff!r}, "
          f"max |z~| {float(ref.abs().max())!r} (tolerance {RESTORE_TOL} "
          f"relative and absolute)")
    if not torch.allclose(z_tilde, ref, rtol=RESTORE_TOL, atol=RESTORE_TOL):
        raise AssertionError("fused and plain restore disagree")
    torch.backends.cudnn.deterministic = True
    det, det_ref = plan.restore(decoded), plan_ref.restore(decoded)
    torch.backends.cudnn.deterministic = False
    same = bits_equal(det, det_ref)
    print(f"with cudnn.deterministic: fused vs fused=False restore "
          f"{'bit-identical' if same else 'DIFFER'} (max abs diff "
          f"{max_abs_diff([(det, det_ref)])!r})")
    if not same:
        raise AssertionError("deterministic fused and plain restore differ")
    if tuple(logits.shape) != (n, cfg.num_classes) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    print(f"logits {tuple(logits.shape)} finite: yes; z_tilde "
          f"{tuple(z_tilde.shape)}")
    wire = [b.nbytes for b in blobs]
    print(f"wire bytes per request: {wire} (mean {float(np.mean(wire))!r}, raw "
          f"fp32 split tensor {blobs[0].stats.raw_bits // 8} bytes)")

    # the same path on the CPU with the plain versions, first request:
    # the same seeds give the same weights on the CPU
    cpu = torch.device("cpu")
    cmodel, cbaf, _, _, _ = build_system(cpu, cfg)
    cspec = pipeline.ModelSpec(sel_idx=spec.sel_idx, params=cmodel,
                               baf_params=cbaf)
    cplan = pipeline.compile(op, cspec, fused=True, device=cpu)
    z0 = model.edge(imgs[:1].to(dev))[1].cpu()
    same = cplan.encode(z0).data == blobs[0].data
    crest = cplan.restore(cplan.decode(blobs[0]))
    clog = cmodel.cloud(crest)
    rd = float((crest - z_tilde[:1].cpu()).abs().max())
    ld = float((clog - logits[:1].cpu()).abs().max())
    print(f"card vs CPU, request 0: wire bytes identical {same}; restore "
          f"max abs diff {rd!r}; logits max abs diff {ld!r}, max |logit| "
          f"{float(clog.abs().max())!r} (tolerance {CPU_TOL} relative "
          f"and absolute)")
    if not (same and torch.allclose(crest, z_tilde[:1].cpu(), rtol=CPU_TOL,
                                    atol=CPU_TOL)
            and torch.allclose(clog, logits[:1].cpu(), rtol=CPU_TOL,
                               atol=CPU_TOL)):
        raise AssertionError("card and CPU paths disagree")
    return dict(launches=launches, times=times, wire=wire, z=z_tilde,
                consolidate_err=cons_err)


# ---------------------------------------------------------------------------
# Phase 5: kernel times
# ---------------------------------------------------------------------------

def time_kernels(dev, errs: dict, launches: dict) -> list:
    import torch
    from repro_torch.kernels.consolidate import (consolidate_fused,
                                                 consolidate_plain)
    from repro_torch.kernels.histogram import histogram, histogram_plain
    from repro_torch.kernels.quantize import quantize_fused, quantize_plain

    gen = torch.Generator().manual_seed(1)
    rows = []

    def timed(fn):
        """(device ms from the profiler, ms per call between CUDA events)."""
        return device_ms(fn), event_ms(fn)

    def row(name, src, replaces, kernel, plain, nbytes, library, note):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        lib = None if library is None else library[0]
        print(f"time {name} ({note}): device time per call, from the "
              f"profiler: kernel {kernel[0]!r} ms, plain {plain[0]!r} ms, "
              f"library {lib!r} ms; bound {bound!r} ms ({nbytes} bytes); per "
              f"call between CUDA events, launch included: kernel "
              f"{kernel[1]!r} ms, plain {plain[1]!r} ms, library "
              f"{None if library is None else library[1]!r} ms")
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches[name], max_abs_err=errs[name],
                    ms=kernel[0], plain_ms=plain[0], bound_ms=bound,
                    bound_by="bytes", library_ms=lib)

    def quantize_times(b):
        x = torch.randn((b, R, P), generator=gen).to(dev)
        sel = torch.randperm(P, generator=gen)[:C].to(torch.int32).to(dev)
        sel64 = sel.long()
        ms = timed(lambda: quantize_fused(x, BITS, sel))
        plain = timed(lambda: quantize_plain(x, BITS, sel64))
        # selected elements read once, codes and fp16 side info written once
        nbytes = b * R * C * 4 + C * 4 + b * R * C + 2 * b * C * 2
        return ms, plain, nbytes

    def histogram_times(k):
        codes = torch.randint(0, 256, (k, C), generator=gen,
                              dtype=torch.uint8).to(dev)
        offs = torch.arange(C, device=dev) * 256
        ms = timed(lambda: histogram(codes, 256))
        plain = timed(lambda: histogram_plain(codes, 256))
        lib = timed(lambda: torch.bincount(
            (codes.long() + offs).view(-1), minlength=C * 256))
        return ms, plain, lib, k * C + C * 256 * 4

    def consolidate_times(b):
        z = torch.randn((b, R, P), generator=gen).to(dev)
        sel = torch.randperm(P, generator=gen)[:C].to(torch.int32).to(dev)
        codes, mins, maxs = quantize_fused(z, BITS, sel)
        est = z + 0.3 * torch.randn((b, R, P), generator=gen).to(dev)
        sel64 = sel.long()
        ms = timed(lambda: consolidate_fused(est, codes, mins, maxs, BITS,
                                             sel))
        plain = timed(lambda: consolidate_plain(est, codes, mins, maxs,
                                                BITS, sel64))
        nbytes = 2 * b * R * C * 4 + b * R * C + 2 * b * C * 2 + C * 4
        return ms, plain, nbytes

    q1 = quantize_times(1)
    q8 = quantize_times(B)
    h1 = histogram_times(R)
    h8 = histogram_times(B * R)
    c8 = consolidate_times(B)
    rows.append(row("quantize", "src/repro_torch/csrc/quantize.cu",
                    "src/repro/kernels/quantize.py:48", q1[0], q1[1], q1[2],
                    None, f"main path B=1 R={R} P={P} C={C}"))
    row("quantize", "", "", q8[0], q8[1], q8[2], None,
        f"slice B={B} R={R} P={P} C={C}")
    rows.append(row("histogram", "src/repro_torch/csrc/histogram.cu",
                    "src/repro/kernels/histogram.py:61", h1[0], h1[1], h1[3],
                    h1[2], f"main path K={R} C={C} nsym=256"))
    row("histogram", "", "", h8[0], h8[1], h8[3], h8[2],
        f"slice K={B * R} C={C} nsym=256")
    rows.append(row("consolidate", "src/repro_torch/csrc/consolidate.cu",
                    "src/repro/kernels/consolidate.py:37", c8[0], c8[1],
                    c8[2], None, f"main path B={B} R={R} P={P} C={C}"))
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.yolo_baf import full_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = resolve_device(None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")

    secs = _build.build_all()
    print(f"build: {secs!r} s wall for "
          + ", ".join(f"{k.name} {k.build_seconds!r} s" for k in
                      _build.KERNELS))

    errs = check_kernels(dev)
    cfg = full_config()
    print(f"main path: {cfg}, split {cfg.split_hw}x{cfg.split_hw}x"
          f"{cfg.split_p}, Q={cfg.split_q}, C={C}, bits={BITS}, rans, fused")
    res = main_path(dev, cfg)
    errs["consolidate"] = max(errs["consolidate"], res["consolidate_err"])
    for k, v in res["times"].items():
        print(f"stage {k}: {v * 1e3!r} ms per request")
    rows = time_kernels(dev, errs, res["launches"])
    print(f"total {time.perf_counter() - t_start!r} s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
