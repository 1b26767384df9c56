#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (on PATH or under /usr/local/cuda/bin) and
the ``src/`` tree of this checkout; it imports nothing of JAX or of the JAX
package ``repro``. Phases, each printing lines before the last:

  1. device: card name and power limit, torch and CUDA versions, TF32 flags
     (both set to False, so float32 convolutions and matmuls are full
     float32);
  2. build: the six kernels of ``src/repro_torch/csrc``, one nvcc each,
     all started together;
  3. kernels against their plain torch versions on the card: the BaF
     kernels at the slice's shapes (B=8, R=64*64, P=256, C=64, bits=8) plus
     edge cases (quantize: NaN, 12 bits, signed zeros against the plain
     version on the CPU, R=1 and 7 (also under a cluster of 16 blocks),
     R=4095, R=65536 beyond what the blocks hold, C=1, 8 and 33,
     sel_idx=None, a channel-table entry out of range skipped; histogram: one symbol everywhere, K=3 (also under a
     cluster of 16 blocks), C=5 peaked; consolidate: NaN in the estimate,
     NaN side info and both, NaN where the plain version has NaN and the
     same bits elsewhere, with and without the plan's channel table); cdf
     at 1, 8 and 12 bits, row-major and through the (S, C) view of a
     (C, S) buffer as the cdf path reads and writes it; flash
     attention (f32 and bf16, causal or not, window, Sq < Sk, GQA 7 and 1,
     hd 16, 64 and 128, ragged S, the qwen2-7b prefill's shape; bf16 q, k,
     v sliced from one fused qkv tensor); the linear scan (rwkv with
     bonus, ssm, per-channel and scalar decay, with and without an initial
     state, the rwkv6-3b prefill's and ingest's shapes; chunk 32 at the
     decay clamp, NaN where the plain version has NaN);
  4. the BaF main path at the paper's full width (YOLO front at 512x512,
     split tensor 64x64x256, C=64, 8 bits, static rANS, fused restore):
     eight one-image requests through edge -> plan.encode ->
     plan.decode_batch -> plan.restore -> cloud, with the kernels' launch
     counts read over this phase alone; the histogram kernel held exact
     against its plain version on the path's own codes, and the
     consolidate kernel bit for bit on the path's own estimate; the restore
     checked against the plan compiled with fused=False (and bit for bit
     with cudnn.deterministic) and against the same path run on the CPU for
     the first request; then ``channel_histogram_cdf`` on each request's
     decoded codes (the cdf kernel's path), exact against numpy, and its
     device operations per request from the profiler: the histogram and
     cdf kernels and three copies, nothing else;
  5. the offline side of the BaF path at the paper's full width
     (``pretrain_cnn`` 4 steps on batches of 8 at 512x512,
     ``compute_channel_order`` over 2 batches, ``train_baf`` 4 steps at
     C=64, then eight requests through ``SplitInferenceEngine`` with the
     trained weights), each with the kernels' counts read over it alone:
     the quantize kernel once per BaF step and bit-identical to its plain
     version on the first step's z, the frozen CNN bit-identical before and
     after, losses finite, logits finite; the steps' times, the selection
     time and the phase's peak memory; at smoke scale one pretraining step
     and one BaF step on the card against the same steps on the CPU;
  6. the BaF serving gateway at the paper's full width (the same
     full_config, float32, TF32 off, a bank of seeded BaF predictors for
     C in {16, 32, 64}, hidden 64, each selecting the first C of one channel
     order): the RD table from ``build_rd_table`` over 2 calibration images
     at C x bits {4, 8}, rans, through ``load_or_build_rd_table`` in a
     temporary directory (its launches printed apart); a ``ServingGateway``
     with a ``RateController``, a metered ``SimulatedChannel`` and
     max_batch 8 serving 16 requests: wall time and requests/s, the hooked
     stage times, telemetry p50/p99, peak memory, the kernels' launches
     over the serve alone (quantize and histogram once a request,
     consolidate once a micro-batch of the telemetry), every response its
     micro-batch's own row with the padding rows dropped, the most padded
     micro-batch's fused restore against fused=False and its consolidate
     bit for bit against the plain version, quantize and histogram on a
     served z; the device's busy share of a profiled serve; then
     ``gateway_demo`` part 7 at full width (gold/silver/bronze, a
     48-request burst, two queues under ``LinearCostModel``, queue-depth
     admission): served + shed = 48, the scheduler's grants equal the
     containers' bits, a second run and a traced run give identical
     telemetry, the spans sum to each latency within 1e-9 s and the Chrome
     trace is valid; at smoke scale the gateway on the card against the
     CPU with both edges given the CPU's z: wire bytes and RequestRecords
     identical, logits within 1e-4;
  7. qwen2-7b at its full published config (28 layers, bf16, random
     weights from a seed): B=2, a 512-token prefill (flash kernel, 28
     launches), the KV cache filled token by token, 16 greedy decode steps;
     prefill against the cache fill's last logits and against the same
     model with plain attention on the card;
  8. rwkv6-3b at its full published config (32 layers): B=2, a 512-token
     prefill (32 scan launches), a 4096-token long ingest in blocks of 1024
     (128 launches) held against one 4096-token prefill, 16 decode steps
     from the ingest state; the top kernels of a prefill, of the ingest
     and of a decode step;
  9. both LMs at smoke scale in float32 from the same seeded weights: the
     kernels on the card against the plain versions on the CPU;
 10. times: each kernel's device time and device operations per call at
     its path's shapes (torch.profiler) beside its bound, its plain version
     and, where one PyTorch call computes the same function, that call; the
     histogram also on the path's own codes; cdf through the cdf path's
     (C, S) views, row-major, and at S=4096; the linear scan twice, at the
     prefill's shape (its launches in the prefill) and at the ingest
     block's (``linear_scan/ingest_block``, its launches in the ingest).

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
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak, same sheet
F32_FLOPS = 67e12                # float32 outside the tensor cores
B, R, P, C, BITS = 8, 64 * 64, 256, 64, 8
HIDDEN = 64                      # width of the BaF predictor
# The fused and fused=False restores run the same convolutions. With cuDNN's
# default algorithms two runs need not agree to the bit, so the restores of
# the main path are held at the CPU parity tests' 1e-4, and bit for bit when
# rerun with cudnn.deterministic. Card against CPU: 1e-3. Relative and
# absolute.
RESTORE_TOL = 1e-4
CPU_TOL = 1e-3
# Kernel against plain version: flash 2e-5 (f32) and 3e-2 (bf16), the JAX
# kernel tests' tolerances; the linear scan 1e-4 (float32 sums in another
# order over 16-step chunks); cdf exact; consolidate bit for bit, NaN where
# the plain version has NaN. Relative and absolute.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SCAN_TOL = 1e-4
# Full-width LMs. Each check runs twice. In float32 (the same weights
# upcast) two orders of the same arithmetic must agree to LM_F32_RTOL of
# the largest |logit|: these are the checks that test the algorithms. In
# bf16 no fixed bound is principled at 28-32 layers of random weights, so
# the bound is measured in the same run: two bf16 evaluations of one
# function (kernel and plain attention, prefill and cache fill, ingest and
# prefill) may lie at most as far apart as the plain bf16 evaluation lies
# from float32. That catches only a fault larger than bf16 rounding carried
# through the stack; the kernels' own bf16 cases above are held at 3e-2.
LM_F32_RTOL = 1e-3
LM_CPU_TOL = 1e-4                # smoke LMs in float32, card against CPU
QWEN_B, QWEN_PROMPT, GEN = 2, 512, 16
# The offline side: steps of each trainer, batches of the selection, the
# batch, and the steps timed after it.
TRAIN_STEPS, SELECT_BATCHES, OFFLINE_BATCH, TIMED_STEPS = 4, 2, 8, 5
RWKV_B, RWKV_PROMPT, RWKV_LONG, RWKV_BLOCK = 2, 512, 4096, 1024
# The serving gateway: the bank's C, the RD sweep's calibration images and
# bits, the single-tenant requests and micro-batch cap, the overload burst.
SERVE_BANK, SERVE_CALIB, SERVE_BITS = (16, 32, 64), 2, (4, 8)
SERVE_N, SERVE_MAX_BATCH, BURST = 16, 8, 48
GATEWAY_CPU_TOL = 1e-4           # smoke-scale gateway logits, card vs CPU


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


PROFILER_SESSIONS = 5


def _device_rows(run, activities):
    """Run ``run()`` under ``torch.profiler`` -> ([(device us, kernel
    name, count)], run's result). A session that records no device activity
    at all (seen in a few percent of sessions on the card, in this script
    and in its earlier versions alike) is run again, up to
    PROFILER_SESSIONS; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    for attempt in range(PROFILER_SESSIONS):
        with profile(activities=activities) as prof:
            out = run()
        rows = [(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)), e.key,
                 e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if sum(r[0] for r in rows) > 0:
            return rows, out
        print(f"torch.profiler recorded no CUDA device time (session "
              f"{attempt + 1} of {PROFILER_SESSIONS})")
    raise RuntimeError("torch.profiler recorded no CUDA device time")


def device_ms(fn, iters: int = 20) -> tuple[float, int]:
    """(device ms per call, device operations per call): the kernels,
    copies and memsets ``fn`` puts on the card, from ``torch.profiler``;
    host launch time is not in it. Each operation counts as its mean
    duration times the times it ran per call (its count over ``iters``,
    rounded): a session sometimes records one event fewer than ran (a
    count of 19 for 20 calls), which a plain sum over ``iters`` would
    read as a call 5% shorter."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for attempt in range(PROFILER_SESSIONS):
        rows, _ = _device_rows(run, [ProfilerActivity.CUDA])
        per_call = [(us / n, round(n / iters)) for us, _, n in rows if n]
        ops = sum(k for _, k in per_call)
        if ops:
            return sum(us * k for us, k in per_call) / 1e3, ops
        print(f"torch.profiler recorded too few device operations for "
              f"{iters} calls (session {attempt + 1} of {PROFILER_SESSIONS})")
    raise RuntimeError("torch.profiler recorded too few device operations")


def _numeric(t):
    """A tensor torch can subtract: uint16 codes widened through int32."""
    import torch
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype in (torch.float16, torch.uint16):
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_diff(pairs) -> float:
    """Largest |a - b| over (kernel, plain) tensor pairs, in float64; NaN
    where both are NaN counts as equal."""
    import torch
    out = 0.0
    for a, b in pairs:
        d = (_numeric(a).double() - _numeric(b).double()).abs()
        both_nan = torch.isnan(a.double()) & torch.isnan(b.double()) \
            if a.is_floating_point() else None
        if both_nan is not None:
            d = torch.where(both_nan, torch.zeros_like(d), d)
        out = max(out, float(d.max()))
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels.consolidate import (consolidate_fused,
                                                 consolidate_plain)
    from repro_torch.kernels.histogram import _plan as histogram_plan_of
    from repro_torch.kernels.quantize import (QuantizePlan, _launch,
                                              channel_order, quantize_fused,
                                              quantize_plain, quantize_plan)

    gen = torch.Generator().manual_seed(0)
    errs = {}

    def quantize_case(b, r, p, c, scale, offset, bits=BITS, every=False,
                      plan=None):
        """``plan``: one the wrapper would not pick, through _launch."""
        x = (torch.randn((b, r, p), generator=gen) * scale + offset).to(dev)
        x[0, :, 3] = offset                          # a constant channel
        sel = None if every else \
            torch.randperm(p, generator=gen)[:c].to(torch.int32).to(dev)
        got = quantize_fused(x, bits, sel) if plan is None else \
            _launch(x, bits, None if every else channel_order(sel), plan)
        want = quantize_plain(x, bits, None if every else sel.long())
        sync(dev)
        ok = all(bits_equal(g, w) for g, w in zip(got, want))
        plan = plan or quantize_plan(b, r, c)
        print(f"quantize B={b} R={r} P={p} C={c} scale={scale:g} "
              f"offset={offset:g} bits={bits}"
              f"{' sel_idx=None' if every else ''} (plan {tuple(plan)}): "
              f"{'bit-identical' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError("quantize kernel differs from plain version")
        return got, max_abs_diff(zip(got, want))

    (codes, _, _), err = quantize_case(1, R, P, C, 1.0, 0.0)   # main path
    errs["quantize"] = max(
        err,
        quantize_case(B, R, P, C, 1.0, 0.0)[1],               # slice shape
        quantize_case(B, R, P, C, 1e5, -1.0)[1],              # beyond fp16
        quantize_case(2, R, P, C, 1e-7, 0.5)[1],              # fp16 subnormal
        quantize_case(3, 1000, P, 40, 3.0, 0.5, bits=5)[1],   # ragged R, C
        quantize_case(B, R, P, C, 1.0, 0.0, bits=12)[1],      # uint16 codes
        quantize_case(1, 1, P, C, 1.0, 0.0)[1],
        quantize_case(1, 7, P, C, 1.0, 0.0)[1],
        quantize_case(1, 1, P, C, 1.0, 0.0,                    # R < cluster
                      plan=QuantizePlan(8, 16, 1, True))[1],
        quantize_case(1, 7, P, C, 1.0, 0.0,
                      plan=QuantizePlan(8, 16, 1, True))[1],
        quantize_case(1, R - 1, P, C, 1.0, 0.0)[1],  # R not a multiple
        quantize_case(1, 65536, P, C, 1.0, 0.0)[1],  # rows read twice
        quantize_case(2, R, P, 1, 1.0, 0.0)[1],               # C = 1
        quantize_case(2, R, P, 33, 1.0, 0.0, bits=12)[1],     # C=33
        quantize_case(2, R, P, 8, 1.0, 0.0)[1],               # C=8
        quantize_case(2, R, P, P, 1.0, 0.0, every=True)[1],   # sel_idx=None
        quantize_nan_case(dev, gen),
        quantize_zeros_case(dev, gen),
        quantize_table_out_of_range_case(dev, gen))

    big = torch.randint(0, 256, (B * R, C), generator=gen, dtype=torch.uint8)
    wide = torch.randint(-2, 4098, (4096, 64), generator=gen,
                         dtype=torch.int32)
    wide[::5] = 4096                                        # padding sentinel
    peaked = torch.from_numpy(np.minimum(
        np.random.default_rng(0).geometric(0.6, size=(1000, 5)) + 99, 4095)
        .astype(np.uint16))
    errs["histogram"] = max(
        histogram_case(dev, codes.view(R, C), 1 << BITS, "u8 main shape"),
        histogram_case(dev, big.to(dev), 256, "u8 slice"),
        histogram_case(dev, wide.to(dev), 4096, "i32 bits=12 with sentinels"),
        histogram_case(dev, torch.full((R, C), 17, dtype=torch.uint8,
                                       device=dev), 256, "u8 one symbol"),
        histogram_case(dev, torch.full((R, C), 4000, dtype=torch.int32,
                                       device=dev), 4096, "i32 one symbol"),
        histogram_case(dev, big[:3].to(dev), 256, "u8 few rows"),
        histogram_case(dev, big[:3].to(dev), 256, "u8 K < cluster",
                       plan=histogram_plan_of(3, 256, 4, 16)),
        histogram_case(dev, peaked.to(dev), 4096, "u16 peaked, C=5"))

    def consolidate_case(b, r, p, c, bits, nan=None, table=False):
        """``nan``: "z" puts NaN in the estimate (selected and unselected
        channels), "side" makes one (example, channel)'s min and max NaN,
        "both" does both. ``table``: the plan's channel table given."""
        z = torch.randn((b, r, p), generator=gen).to(dev)
        sel = torch.randperm(p, generator=gen)[:c].to(torch.int32).to(dev)
        codes, mins, maxs = quantize_plain(z, bits, sel.long())
        est = z + 0.3 * torch.randn((b, r, p), generator=gen).to(dev)
        if nan in ("z", "both"):
            est[0, 11, sel[2]] = float("nan")
            est[b - 1, :4, sel[c - 1]] = float("nan")
            est[0, 3, :] = float("nan")        # a whole row, all channels
        if nan in ("side", "both"):
            mins[b - 1, c // 2] = maxs[b - 1, c // 2] = float("nan")
        want = consolidate_plain(est.clone(), codes, mins, maxs, bits,
                                 sel.long())
        kw = {"order": channel_order(sel)} if table else {}
        got = consolidate_fused(est.clone(), codes, mins, maxs, bits, sel,
                                **kw)
        sync(dev)
        nans = torch.isnan(want)
        ok = bool(torch.equal(torch.isnan(got), nans)) and \
            bits_equal(got[~nans].view(torch.int32),
                       want[~nans].view(torch.int32)) and \
            (nan is None) == (int(nans.sum()) == 0)
        err = max_abs_diff([(got, want)])
        print(f"consolidate B={b} R={r} P={p} C={c} bits={bits}"
              f"{f' NaN in {nan}' if nan else ''}"
              f"{' with the channel table' if table else ''}: "
              f"{int(nans.sum())} NaN in the plain version, the kernel's at "
              f"the same places and the same bits elsewhere: "
              f"{'yes' if ok else 'NO'} (max abs diff {err!r})")
        if not ok:
            raise AssertionError("consolidate kernel differs from plain")
        return err

    errs["consolidate"] = max(consolidate_case(B, R, P, C, BITS),
                              consolidate_case(B, R, P, C, BITS, table=True),
                              consolidate_case(3, 1000, 40, 40, 3),
                              consolidate_case(2, R, P, C, 12),
                              consolidate_case(2, R, P, C, BITS, nan="z"),
                              consolidate_case(2, R, P, C, BITS, nan="side"),
                              consolidate_case(2, R, P, C, 12, nan="both",
                                               table=True))
    return errs


def histogram_case(dev, codes, nsym, label, plan=None) -> float:
    """The histogram kernel against its plain version: counts exact.
    ``plan``: one the wrapper would not pick, through _launch."""
    import torch
    from repro_torch.kernels.histogram import (_launch, histogram,
                                               histogram_plain, histogram_plan)
    got = histogram(codes, nsym) if plan is None else \
        _launch(codes, nsym, plan)
    want = histogram_plain(codes, nsym)
    sync(dev)
    ok = bool(torch.equal(got, want))
    k, c = codes.shape
    plan = plan or histogram_plan(k, c, nsym)
    print(f"histogram {label} K={k} C={c} nsym={nsym} (plan {tuple(plan)}): "
          f"{'exact' if ok else 'DIFFERS'}")
    if not ok:
        raise AssertionError("histogram kernel differs from plain version")
    return max_abs_diff([(got, want)])


def quantize_zeros_case(dev, gen) -> float:
    """Exact zeros of both signs in both orders: the kernel's side info and
    codes bit-identical to the plain version on the CPU (held to jnp.min /
    jnp.max by the CPU tests); -0.0 wins the min (fp16 0x8000)."""
    import torch
    from repro_torch.kernels.quantize import quantize_fused, quantize_plain
    x = torch.randn((2, R, P), generator=gen)
    x[:, :, 0] = 0.0
    x[:, 5::2, 0] = -0.0                          # +0 first, then -0
    x[:, :, 1] = -0.0
    x[:, 3::4, 1] = 0.0                           # -0 first
    x[:, :, 2] = 0.0                              # all +0
    x[:, :, 3] = -0.0                             # all -0
    sel = torch.tensor([0, 1, 2, 3] + list(range(100, 160)), dtype=torch.int32)
    got = quantize_fused(x.to(dev), BITS, sel.to(dev))
    want = quantize_plain(x, BITS, sel.long())
    sync(dev)
    mins = got[1].cpu().view(torch.int16).to(torch.int32) & 0xFFFF
    ok = all(bits_equal(g.cpu(), w) for g, w in zip(got, want)) and \
        bool((mins[:, :2] == 0x8000).all()) and \
        bool((mins[:, 2] == 0).all()) and bool((mins[:, 3] == 0x8000).all())
    print(f"quantize with signed zeros (+0 then -0, -0 then +0, all +0, all "
          f"-0): kernel vs plain on the CPU "
          f"{'bit-identical' if ok else 'DIFFERS'}; fp16 mins of those "
          f"channels {[hex(int(v)) for v in mins[0, :4]]}")
    if not ok:
        raise AssertionError("quantize kernel orders the zeros unlike jnp")
    return max_abs_diff(zip((g.cpu() for g in got), want))


def quantize_table_out_of_range_case(dev, gen) -> float:
    """The plan's channel table with one entry's output column (C, -1) or
    column of x (P, -1) out of range, at the main path's shape: the kernel
    skips that entry, and every other output column's codes and side info
    are bit-identical to the plain version's."""
    import torch
    from repro_torch.kernels.quantize import (channel_order, quantize_fused,
                                              quantize_plain)
    x = torch.randn((2, R, P), generator=gen).to(dev)
    sel = torch.randperm(P, generator=gen)[:C].to(torch.int32).to(dev)
    want = quantize_plain(x, BITS, sel.long())
    err = 0.0
    for field, value in ((0, C), (0, -1), (1, P), (1, -1)):
        order = channel_order(sel).clone()
        j0 = int(order[5, 0])
        order[5, field] = value
        got = quantize_fused(x, BITS, sel, order=order)
        sync(dev)
        keep = [j for j in range(C) if j != j0]
        pairs = [(g[..., keep], w[..., keep]) for g, w in zip(got, want)]
        ok = all(bits_equal(g, w) for g, w in pairs)
        print(f"quantize with table entry 5's "
              f"{('output column', 'column of x')[field]} set to {value}: "
              f"the other {C - 1} columns "
              f"{'bit-identical' if ok else 'DIFFER'}")
        if not ok:
            raise AssertionError("quantize kernel follows a table entry out "
                                 "of range")
        err = max(err, max_abs_diff(pairs))
    return err


def quantize_nan_case(dev, gen) -> float:
    """One NaN: its (example, channel) gets NaN fp16 side info and zero
    codes, as the plain version (torch.amin/amax, like jnp.min/max) gives;
    every other value bit-identical."""
    import torch
    from repro_torch.kernels.quantize import quantize_fused, quantize_plain
    x = torch.randn((2, R, P), generator=gen).to(dev)
    x[1, 77, 5] = float("nan")
    got = quantize_fused(x, BITS)
    want = quantize_plain(x, BITS)
    sync(dev)
    ok = bits_equal(got[0], want[0]) and not bool(got[0][1, :, 5].any())
    for g, w in zip(got[1:], want[1:]):
        nan = torch.isnan(w)
        ok = ok and torch.equal(torch.isnan(g), nan) and int(nan.sum()) == 1 \
            and bool(nan[1, 5]) and bits_equal(g[~nan], w[~nan])
    print(f"quantize with one NaN at (1, 77, 5): NaN side info at (1, 5) "
          f"only, zero codes there, the rest bit-identical: "
          f"{'yes' if ok else 'NO'}")
    if not ok:
        raise AssertionError("quantize kernel differs on NaN input")
    return max_abs_diff(zip(got, want))


def check_lm_kernels(dev) -> dict:
    """cdf, flash attention and the linear scan against their plain
    versions on the card."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.histogram import cdf, cdf_plain
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_plain

    gen = torch.Generator(device=dev).manual_seed(7)
    errs = {"cdf": 0.0, "flash_attention": 0.0, "linear_scan": 0.0}
    for bits, c in ((8, C), (12, C), (12, 5), (1, 3)):
        counts = torch.randint(0, 1 << 20, (1 << bits, c), generator=gen,
                               device=dev, dtype=torch.int32)
        want = cdf_plain(counts)
        # row-major (S, C) as the TPU kernel; the (S, C) view of a (C, S)
        # buffer as the histogram writes it, into a (C, S) buffer as
        # channel_histogram_cdf does
        cols = counts.t().contiguous().t()
        ok = bool(torch.equal(cdf(counts), want)) and bool(torch.equal(
            cdf(cols, out=torch.empty((c, 1 << bits), dtype=torch.int32,
                                      device=dev).t()), want))
        print(f"cdf S={1 << bits} C={c}, row-major and through (C, S) "
              f"views: {'exact' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError("cdf kernel differs from plain version")

    flash_cases = [
        # B, Sq, Sk, H, KH, hd, causal, window
        (QWEN_B, QWEN_PROMPT, QWEN_PROMPT, 28, 4, 128, True, None),  # path
        (1, 256, 256, 4, 4, 64, True, None),      # GQA g = 1, hd 64
        (2, 200, 200, 8, 2, 64, True, None),      # ragged S
        (1, 128, 128, 4, 2, 128, False, None),    # not causal
        (1, 300, 300, 14, 2, 128, True, 100),     # window, GQA 7
        (1, 64, 256, 7, 1, 128, True, None),      # Sq < Sk
        (2, 77, 131, 4, 2, 16, True, 33),         # ragged, window, Sq < Sk
    ]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for b, sq, sk, h, kh, hd, causal, window in flash_cases:
            q = torch.randn((b, sq, h, hd), generator=gen, device=dev)
            k = torch.randn((b, sk, kh, hd), generator=gen, device=dev)
            v = torch.randn((b, sk, kh, hd), generator=gen, device=dev)
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            sync(dev)
            err = max_abs_diff([(got, want)])
            tol = FLASH_TOL[name]
            ok = bool(torch.allclose(got.float(), want.float(), atol=tol,
                                     rtol=tol))
            print(f"flash {name} B={b} Sq={sq} Sk={sk} H={h} KH={kh} hd={hd} "
                  f"causal={causal} window={window}: max abs diff {err!r} "
                  f"(tolerance {tol})")
            if not ok:
                raise AssertionError("flash kernel differs from plain")
            errs["flash_attention"] = max(errs["flash_attention"], err)
    # bf16 q, k, v sliced from one fused qkv tensor: read through strides
    qkv = torch.randn((2, 130, 8 + 2 + 2, 128), generator=gen,
                      device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    sync(dev)
    err = max_abs_diff([(got, want)])
    tol = FLASH_TOL["bfloat16"]
    print(f"flash bfloat16 strided q, k, v from one (2, 130, 12, 128) qkv "
          f"tensor, strides {q.stride()}: max abs diff {err!r} (tolerance "
          f"{tol})")
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError("flash kernel differs on strided inputs")
    errs["flash_attention"] = max(errs["flash_attention"], err)

    scan_cases = [
        # B, S, H, dk, dv, chunk, mode, per-channel, bonus, initial state
        (RWKV_B, RWKV_PROMPT, 40, 64, 64, 16, "rwkv", True, True, False),
        (RWKV_B, RWKV_BLOCK, 40, 64, 64, 16, "rwkv", True, True, True),
        (2, 128, 4, 64, 64, 16, "ssm", False, False, True),
        (2, 128, 4, 64, 64, 16, "ssm", True, False, False),
        (1, 96, 3, 32, 48, 16, "rwkv", False, True, False),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for b, s_, h, dk, dv, chunk, mode, per_ch, bonus, init in scan_cases:
            def rnd(*shape, scale=0.5):
                return torch.randn(shape, generator=gen, device=dev) * scale
            q, k = rnd(b, s_, h, dk).to(dtype), rnd(b, s_, h, dk).to(dtype)
            v = rnd(b, s_, h, dv, scale=1.0).to(dtype)
            ld = -torch.exp(rnd(b, s_, h, dk if per_ch else 1) - 1.0)
            u = rnd(h, dk) if bonus else None
            s0 = rnd(b, h, dk, dv) if init else None
            got = linear_scan(q, k, v, ld, bonus=u, initial_state=s0,
                              chunk=chunk, mode=mode)
            want = linear_scan_plain(q, k, v, ld, bonus=u, initial_state=s0,
                                     chunk=chunk, mode=mode)
            sync(dev)
            err = max_abs_diff(zip(got, want))
            ok = all(torch.allclose(g, w, atol=SCAN_TOL, rtol=SCAN_TOL)
                     for g, w in zip(got, want))
            print(f"linear scan {str(dtype).split('.')[1]} B={b} S={s_} "
                  f"H={h} dk={dk} dv={dv} chunk={chunk} {mode} "
                  f"per-channel={per_ch} bonus={bonus} initial={init}: max "
                  f"abs diff {err!r} (tolerance {SCAN_TOL})")
            if not ok:
                raise AssertionError("linear-scan kernel differs from plain")
            errs["linear_scan"] = max(errs["linear_scan"], err)
    errs["linear_scan"] = max(errs["linear_scan"], scan_overflow_case(dev))
    return errs


def scan_overflow_case(dev) -> float:
    """chunk 32 with every decay at the clamp (-4): exp(-la) overflows and
    exp(la) underflows. The factorisation is kept, so the kernel's NaNs
    stand exactly where the plain version's do; the rest within SCAN_TOL."""
    import torch
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_plain
    gen = torch.Generator(device=dev).manual_seed(8)
    b, s_, h, dk, dv = 2, 128, 4, 64, 64
    q, k = (torch.randn((b, s_, h, dk), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn((b, s_, h, dv), generator=gen, device=dev) \
        .to(torch.bfloat16)
    ld = torch.full((b, s_, h, dk), -4.0, device=dev)
    u = torch.randn((h, dk), generator=gen, device=dev) * 0.5
    got = linear_scan(q, k, v, ld, bonus=u, chunk=32)
    want = linear_scan_plain(q, k, v, ld, bonus=u, chunk=32)
    sync(dev)
    nan = torch.isnan(want[0])
    same_nan = bool(torch.equal(torch.isnan(got[0]), nan))
    ok = same_nan and int(nan.sum()) > 0 and all(
        torch.allclose(g, w, atol=SCAN_TOL, rtol=SCAN_TOL, equal_nan=True)
        for g, w in zip(got, want))
    err = max_abs_diff(zip(got, want))
    print(f"linear scan chunk 32 at the decay clamp: {int(nan.sum())} NaN "
          f"of {nan.numel()} outputs in the plain version, kernel's NaN at "
          f"the same positions: {same_nan}; max abs diff elsewhere {err!r} "
          f"(tolerance {SCAN_TOL})")
    if not ok:
        raise AssertionError("linear-scan kernel differs on overflow")
    return err


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


def check_consolidate_on_path(dev, model, baf, sel_idx, decoded, *,
                              bits: int = BITS) -> float:
    """The consolidate kernel against its plain version on a path's own
    estimate: one z~ of the decoded batch, before eq. (6), clipped by each
    on its own copy. Bit for bit."""
    import torch
    from repro_torch.core.split import restore_codes
    from repro_torch.kernels.consolidate import (consolidate_fused,
                                                 consolidate_plain)
    from repro_torch.kernels.quantize import channel_order

    sel = torch.as_tensor(np.asarray(sel_idx, np.int32), device=dev)
    order = channel_order(sel)                  # as the plan holds it
    codes = torch.from_numpy(np.ascontiguousarray(decoded.codes)).to(dev)
    mins = torch.from_numpy(decoded.mins).to(dev)
    maxs = torch.from_numpy(decoded.maxs).to(dev)
    est = restore_codes(baf, model.split, sel, codes, mins, maxs, bits=bits,
                        consolidation=False).contiguous()
    n, h, w, p = est.shape
    c = codes.shape[-1]
    flat = est.view(n, h * w, p)
    args = (codes.view(n, h * w, c), mins.view(n, c), maxs.view(n, c), bits)
    got = consolidate_fused(flat.clone(), *args, sel, order=order)
    want = consolidate_plain(flat.clone(), *args, sel.long())
    sync(dev)
    ok = bits_equal(got, want)
    err = max_abs_diff([(got, want)])
    print(f"consolidate on the path's z~ {tuple(est.shape)}, C={c}, {bits} "
          f"bits: kernel vs plain {'bit-identical' if ok else 'DIFFERS'} "
          f"(max abs diff {err!r})")
    if not ok:
        raise AssertionError("consolidate kernel differs on the path")
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
    path_codes, hist_err = histogram_on_path_codes(dev, model, spec, imgs)
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
                consolidate_err=cons_err, decoded=decoded,
                path_codes=path_codes, histogram_err=hist_err)


def histogram_on_path_codes(dev, model, spec, imgs):
    """The quantize kernel's codes of request 0's z, as the plan hands them
    to the histogram -> ((K, C) codes on the card, the histogram kernel's
    error against its plain version on them). Printed beside: the mean
    share of a channel's codes on its most frequent symbol, how peaked they
    are (1/256 for uniform codes)."""
    import torch
    from repro_torch.kernels.quantize import quantize_fused
    z = model.edge(imgs[:1].to(dev))[1].contiguous()
    n, h, w, p = z.shape
    sel = torch.as_tensor(np.asarray(spec.sel_idx, np.int32), device=dev)
    codes = quantize_fused(z.view(n, h * w, p), BITS, sel)[0].view(h * w, C)
    err = histogram_case(dev, codes, 1 << BITS, "u8 the path's own codes")
    counts = codes.cpu().numpy()
    top = np.mean([np.bincount(counts[:, c]).max() / counts.shape[0]
                   for c in range(C)])
    print(f"the path's codes: mean share of a channel's most frequent "
          f"symbol {float(top)!r}")
    return codes, err


def cdf_path(dev, decoded) -> dict:
    """``channel_histogram_cdf`` on each request's decoded codes, on the
    card: the histogram and cdf kernels, exact against numpy. Then the
    device operations of one request, from the profiler: the two kernels
    and the copies (codes up, counts and CDF down), nothing else."""
    from torch.profiler import ProfilerActivity

    from repro_torch.kernels import _build
    from repro_torch.kernels.histogram import channel_histogram_cdf

    _build.reset_launches()
    n = decoded.codes.shape[0]
    outs = [channel_histogram_cdf(decoded.codes[i], BITS, device=dev)
            for i in range(n)]
    launches = {k.name: k.launches for k in _build.KERNELS}
    print(f"cdf path launches ({n} requests): {launches}")
    if launches["cdf"] != n or launches["histogram"] != n:
        raise AssertionError(f"cdf path did not run its kernels: {launches}")
    for i, (counts, cum) in enumerate(outs):
        flat = decoded.codes[i].reshape(-1, C).astype(np.int64)
        want = np.stack([np.bincount(flat[:, c], minlength=1 << BITS)
                         for c in range(C)])
        if not (np.array_equal(counts, want)
                and np.array_equal(cum, np.cumsum(want, 1) - want)):
            raise AssertionError(f"request {i}: counts or CDF differ")
    print("cdf path: counts and exclusive CDF equal numpy's for every "
          "request: yes")

    def one():
        channel_histogram_cdf(decoded.codes[0], BITS, device=dev)
        sync(dev)
    one()
    rows, _ = _device_rows(one, [ProfilerActivity.CUDA])
    copies = [(k, n) for _, k, n in rows if k.startswith("Memcpy")]
    others = [(k, n) for _, k, n in rows if not k.startswith("Memcpy")]
    n_ops = sum(n for _, _, n in rows)
    print(f"cdf path device operations per request: {n_ops} (kernels "
          f"{others}; copies {copies})")
    kernels_ok = sorted(n for _, n in others) == [1, 1] and \
        any("hist" in k for k, _ in others) and \
        any("cdf" in k for k, _ in others)
    if not (kernels_ok and sum(n for _, n in copies) == 3):
        raise AssertionError("the cdf path is not two kernels and three "
                             f"copies a request: {rows}")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: the offline side of the BaF path at full width
# ---------------------------------------------------------------------------

def launch_counts() -> dict:
    from repro_torch.kernels import _build
    return {k.name: k.launches for k in _build.KERNELS}


def offline_path(dev, smi: str) -> None:
    """pretrain_cnn -> compute_channel_order -> train_baf -> eight requests
    through SplitInferenceEngine, at the paper's full width, each with the
    kernels' counts read over it alone; then the steps' times, the
    selection time and the phase's peak memory."""
    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch.configs.yolo_baf import full_config
    from repro_torch.core.split import SplitInferenceEngine
    from repro_torch.data.synthetic import ShapesDatasetConfig, shapes_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import (channel_order, quantize_fused,
                                              quantize_plain)
    from repro_torch.optim import adamw_init
    from repro_torch.train import baf_trainer as bt

    cfg = full_config()
    data = ShapesDatasetConfig(image_size=cfg.input_size, num_classes=8,
                               batch_size=OFFLINE_BATCH)
    print(f"offline side: {cfg}, {data}, {TRAIN_STEPS} pretrain steps, "
          f"selection over {SELECT_BATCHES} batches, {TRAIN_STEPS} BaF "
          f"steps at C={C}, {BITS} bits, hidden {HIDDEN}")
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    _build.reset_launches()
    model, hist = bt.pretrain_cnn(cfg, data, steps=TRAIN_STEPS, log_every=1,
                                  verbose=False, device=dev)
    sync(dev)
    counts = {"pretrain_cnn": launch_counts()}

    _build.reset_launches()
    t0 = time.perf_counter()
    sel = bt.compute_channel_order(model, data, batches=SELECT_BATCHES,
                                   device=dev)          # ends on the host
    select_s = time.perf_counter() - t0
    counts["compute_channel_order"] = launch_counts()
    order = sel.order[:C]
    print(f"channel order (best-first): {order[:10].tolist()}...; rho "
          f"{sel.rho.shape}, top score {float(sel.scores[0])!r}")

    before = {k: v.clone() for k, v in model.state_dict().items()}
    _build.reset_launches()
    res = bt.train_baf(model, cfg, data, order, bits=BITS, hidden=HIDDEN,
                       steps=TRAIN_STEPS, log_every=1, verbose=False,
                       device=dev)
    sync(dev)
    counts["train_baf"] = launch_counts()

    _build.reset_launches()
    eng = SplitInferenceEngine(model, res.baf_params, res.sel_idx, bits=BITS,
                               backend="rans", device=dev)
    imgs, labels = shapes_batch(data._replace(batch_size=8), 10_000, 0, dev)
    logits = torch.cat([eng(imgs[i:i + 1])[0] for i in range(8)])
    sync(dev)
    counts["serve"] = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for name, c in counts.items():
        print(f"offline side launches, {name}: {c}")

    # checks, after the counts were read
    losses = [v for _, v, _ in hist] + [v for _, v in res.losses]
    print(f"pretrain losses {[v for _, v, _ in hist]!r}, BaF losses "
          f"{[v for _, v in res.losses]!r}")
    if not all(np.isfinite(losses)) or len(losses) != 2 * TRAIN_STEPS:
        raise AssertionError(f"offline losses not finite: {losses}")
    frozen = all(torch.equal(v, before[k])
                 for k, v in model.state_dict().items()) and \
        all(q.grad is None for q in model.parameters())
    print(f"the CNN's weights and BN stats bit-identical before and after "
          f"train_baf, no gradient on them: {'yes' if frozen else 'NO'}")
    if not frozen:
        raise AssertionError("train_baf changed the frozen CNN")
    want = {"pretrain_cnn": {}, "compute_channel_order": {},
            "train_baf": {"quantize": TRAIN_STEPS},
            "serve": {"quantize": 8, "histogram": 8}}
    for name, c in counts.items():
        if {k: v for k, v in c.items() if v} != want[name]:
            raise AssertionError(f"{name} launched {c}, not {want[name]}")
    # the first BaF step's z: train_baf's stream is seed + 7, its step 0
    img0, _ = shapes_batch(data, 42 + 7, 0, dev)
    z = model.edge(img0)[1].contiguous()
    b, h, w, p = z.shape
    sel_t = torch.as_tensor(order.astype(np.int32), device=dev)
    got = quantize_fused(z.view(b, h * w, p), BITS, sel_t,
                         order=channel_order(sel_t))
    plain = quantize_plain(z.view(b, h * w, p), BITS, sel_t.long())
    sync(dev)
    same = all(bits_equal(g, q) for g, q in zip(got, plain))
    print(f"quantize kernel on the first BaF step's z {tuple(z.shape)}: "
          f"codes and side info vs plain {'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("quantize kernel differs on the training path")
    if tuple(logits.shape) != (8, cfg.num_classes) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    print(f"eight requests through SplitInferenceEngine with the trained "
          f"weights: logits {tuple(logits.shape)} finite: yes")

    # times: the trainers' own steps, on the trained weights
    img, lbl = shapes_batch(data, 1, 0, dev)
    model.requires_grad_(True)
    opt = adamw_init(bt.trainable(model))
    lr = torch.tensor(3e-3)

    def pre():
        nonlocal opt
        opt = bt.pretrain_step(model, opt, lr, img, lbl, bt.PRETRAIN_ADAMW)[0]
        sync(dev)
    baf = res.baf_params.requires_grad_(True)
    bopt = adamw_init(bt.trainable(baf))
    loss_fn = bt.make_baf_loss(model, order, BITS, device=dev)
    zb = model.edge(img)[1]

    def baf_one():
        nonlocal bopt
        bopt = bt.baf_step(baf, bopt, lr, zb, loss_fn, bt.BAF_ADAMW)[0]
        sync(dev)
    pre_ms, baf_ms = host_ms(pre), host_ms(baf_one)
    t0 = time.perf_counter()
    bt.compute_channel_order(model, data, batches=SELECT_BATCHES, device=dev)
    select_warm_s = time.perf_counter() - t0
    profile_top(dev, "pretrain step", pre)
    profile_top(dev, "BaF step", baf_one)
    profile_top(dev, "selection", lambda: bt.compute_channel_order(
        model, data, batches=SELECT_BATCHES, device=dev))
    rows, _ = _device_rows(baf_one, [ProfilerActivity.CUDA])
    quant = [(us, n) for us, k, n in rows if "quantize_kernel" in k]
    if [n for _, n in quant] != [1]:
        raise AssertionError(f"a BaF step ran the quantize kernel "
                             f"{quant} times")
    quant_ms = quant[0][0] / 1e3
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    model.requires_grad_(False)
    baf.requires_grad_(False)
    print(f"offline times ({smi}): pretrain step {pre_ms!r} ms, BaF step "
          f"{baf_ms!r} ms (host clock around synchronised steps, mean of "
          f"{TIMED_STEPS}); the quantize kernel {quant_ms!r} ms of device "
          f"time within a BaF step (device busy {busy_ms!r} ms); selection "
          f"over {SELECT_BATCHES} batches {select_s * 1e3!r} ms, again "
          f"{select_warm_s * 1e3!r} ms; peak memory {peak / 1e9!r} GB")
    train_card_vs_cpu(dev)


def host_ms(fn) -> float:
    """Mean ms of ``fn`` (which ends in a sync) over TIMED_STEPS calls
    after one warm-up, on the host clock."""
    fn()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        fn()
    return (time.perf_counter() - t0) / TIMED_STEPS * 1e3


def train_card_vs_cpu(dev) -> None:
    """At smoke scale, one pretraining step and one BaF step on the card
    against the same steps on the CPU, from the same weights (the seeded
    initialisers draw on the CPU), the same batch and, for the BaF step,
    the same z (so the same codes), at the trainers' peak learning rates.
    Gradients and the optimizer are held apart: Adam's first step is about
    lr * sign(g), so a last-bit difference in a gradient near 0 can move a
    weight by up to 2 lr. Held within CPU_TOL, relative and absolute: the
    losses, the BN running stats the step leaves, the gradients (absolute
    tolerance CPU_TOL times the leaf's largest |g|), and the weights
    AdamW's step on the card gives from the CPU's gradients against the
    CPU's step. The weights after the whole step on each are printed."""
    import torch
    from repro_torch.configs.yolo_baf import smoke_config, smoke_data_config
    from repro_torch.core.baf import BaFConv, BaFConvConfig
    from repro_torch.data.synthetic import shapes_batch
    from repro_torch.models.cnn import CNN
    from repro_torch.optim import adamw_init
    from repro_torch.train import baf_trainer as bt

    cpu = torch.device("cpu")
    cfg = smoke_config()
    c = cfg.split_p // 4
    img, lbl = shapes_batch(smoke_data_config()._replace(batch_size=8), 0, 0,
                            cpu)
    z = CNN(cfg, seed=0, device=cpu).edge(img)[1]
    sel = np.random.default_rng(5).permutation(cfg.split_p)[:c]

    def grads(d):
        """-> the two steps' halves on ``d``: (losses, gradients, BN
        stats, the modules)."""
        model = CNN(cfg, seed=0, device=d).requires_grad_(True)
        loss, _, g = bt.cnn_grads(model, img.to(d), lbl.to(d))
        baf = BaFConv(BaFConvConfig(c=c, q=cfg.split_q, hidden=16), seed=1,
                      device=d).requires_grad_(True)
        frozen = CNN(cfg, seed=0, device=d)
        bloss, bg = bt.baf_grads(baf, z.to(d), bt.make_baf_loss(
            frozen, sel, BITS, device=d))
        return [loss, bloss], [g, bg], list(model.buffers()), [model, baf]

    def steps(mods, gs, lrs):
        """AdamW's first step of both modules from gradients ``gs``."""
        for mod, g, lr, ocfg in zip(mods, gs, lrs,
                                    (bt.PRETRAIN_ADAMW, bt.BAF_ADAMW)):
            params = bt.trainable(mod)
            bt.apply_adamw(params, {k: v.to(next(iter(params.values()))
                                              .device) for k, v in g.items()},
                           adamw_init(params), lr, ocfg)
        return [q.detach().cpu() for m in mods for q in m.parameters()]

    lrs = (torch.tensor(3e-3), torch.tensor(2e-3))
    card_loss, card_g, card_bn, card_mods = grads(dev)
    cpu_loss, cpu_g, cpu_bn, cpu_mods = grads(cpu)
    ok = all(torch.allclose(a.cpu(), b, rtol=CPU_TOL, atol=CPU_TOL)
             for a, b in zip(card_loss + card_bn, cpu_loss + cpu_bn))
    worst_g = 0.0
    for ga, gb in zip(card_g, cpu_g):
        for k, b in gb.items():
            a, scale = ga[k].cpu(), float(b.abs().max())
            ok = ok and torch.allclose(a, b, rtol=CPU_TOL,
                                       atol=CPU_TOL * scale)
            worst_g = max(worst_g, float((a - b).abs().max()) / scale)
    # the optimizer: card and CPU from the CPU's gradients
    card_w = steps(card_mods, cpu_g, lrs)
    cpu_w = steps(cpu_mods, cpu_g, lrs)
    opt_err = max_abs_diff(zip(card_w, cpu_w))
    ok = ok and all(torch.allclose(a, b, rtol=CPU_TOL, atol=CPU_TOL)
                    for a, b in zip(card_w, cpu_w))
    # the whole steps, each device from its own gradients
    whole = [steps(r[3], r[1], lrs) for r in (grads(dev), grads(cpu))]
    moved = [(a - b).abs() for a, b in zip(*whole)]
    far = sum(int((m > CPU_TOL).sum()) for m in moved)
    print(f"smoke scale, one pretraining step and one BaF step, card vs CPU "
          f"(tolerance {CPU_TOL} relative and absolute): losses "
          f"{[float(v) for v in card_loss]!r} vs "
          f"{[float(v) for v in cpu_loss]!r}; largest gradient difference "
          f"{worst_g!r} of the leaf's largest |g|; BN stats max abs diff "
          f"{max_abs_diff(zip((b.cpu() for b in card_bn), cpu_bn))!r}; "
          f"AdamW on the card vs the CPU from the same gradients: max abs "
          f"diff {opt_err!r}; whole steps, each from its own gradients: max "
          f"abs diff {max(float(m.max()) for m in moved)!r}, {far} of "
          f"{sum(m.numel() for m in moved)} weights beyond the tolerance "
          f"(Adam's first step on a gradient near 0)")
    if not ok:
        raise AssertionError("training steps disagree between card and CPU")


# ---------------------------------------------------------------------------
# Phase 6: the serving gateway at full width
# ---------------------------------------------------------------------------

def serving_system(dev, cfg, bank_c, hidden: int, seed: int = 0):
    """The CNN and a BaF bank {c: (BaFConv, first c of one channel order)},
    seeded (the initialisers draw on the CPU, so every device gets the same
    weights)."""
    from repro_torch.core.baf import BaFConv, BaFConvConfig
    from repro_torch.models.cnn import CNN

    model = CNN(cfg, seed=seed, device=dev).eval()
    order = np.random.default_rng(seed + 2).permutation(cfg.split_p)
    bank = {c: (BaFConv(BaFConvConfig(c=c, q=cfg.split_q, hidden=hidden),
                        seed=seed + 1 + k, device=dev).eval(), order[:c])
            for k, c in enumerate(bank_c)}
    return model, bank


def serving_images(cfg, n: int, seed: int) -> np.ndarray:
    """n synthetic-shapes images at the config's size, as host numpy (the
    gateway's input)."""
    import torch
    from repro_torch.data.synthetic import ShapesDatasetConfig, shapes_batch
    data = ShapesDatasetConfig(image_size=cfg.input_size,
                               num_classes=cfg.num_classes, batch_size=n)
    return shapes_batch(data, seed, 0, torch.device("cpu"))[0].numpy()


def watch_batches(executor) -> list:
    """Record each micro-batch the executor runs: (batch, padded logits)."""
    seen = []
    submit = executor.submit

    def watched(batch, t_ready, *, run_fn=None):
        ticket = submit(batch, t_ready, run_fn=run_fn)
        seen.append((batch, np.asarray(ticket.logits)))
        return ticket
    executor.submit = watched
    return seen


def serving_path(dev, smi: str) -> None:
    """The BaF serving gateway at the paper's full width: the RD sweep, a
    single-tenant ServingGateway under rate control, the multi-tenant
    overload of gateway_demo part 7, then the gateway on the card against
    the CPU at smoke scale."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch.configs.yolo_baf import full_config
    from repro_torch.kernels import _build
    from repro_torch.obs import MetricsRegistry, hooks
    from repro_torch.serve import (ChannelConfig, RateController,
                                   ServingGateway, SimulatedChannel,
                                   build_rd_table, load_or_build_rd_table,
                                   rd_grid, rd_table_to_json)

    cfg = full_config()
    model, bank = serving_system(dev, cfg, SERVE_BANK, HIDDEN)
    print(f"serving: {cfg}, bank C={SERVE_BANK} (hidden {HIDDEN}), RD sweep "
          f"over {SERVE_CALIB} calibration images at bits {SERVE_BITS}, rans; "
          f"{SERVE_N} requests, max_batch {SERVE_MAX_BATCH}")
    calib = serving_images(cfg, SERVE_CALIB, 31)
    ops = rd_grid(bank, SERVE_BITS, "rans")
    key = {"calib": SERVE_CALIB, "input": cfg.input_size}
    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp) / "rd_cache.json"
        _build.reset_launches()
        t0 = time.perf_counter()
        table = load_or_build_rd_table(
            cache, key,
            lambda: build_rd_table(model, bank, calib, ops=ops, device=dev),
            ops=ops)
        sweep_s = time.perf_counter() - t0
        sweep = launch_counts()
        hit = json.dumps(rd_table_to_json(load_or_build_rd_table(
            cache, key, lambda: None, ops=ops))) == \
            json.dumps(rd_table_to_json(table))
    print(f"RD sweep: {sweep_s!r} s, launches {sweep} (apart from the "
          f"serve's); the cache read back gives the same table: {hit}")
    for p in table:
        print(f"  C={p.op.c:<3} bits={p.op.bits}: {p.bits_per_example!r} "
              f"wire bits/image, PSNR {p.psnr_db!r} dB, KL {p.kl!r}")
    if len(table) != len(ops) or not hit or not all(
            np.isfinite([p.psnr_db, p.kl, p.bits_per_example]).all()
            for p in table):
        raise AssertionError("RD sweep failed")
    if sweep["quantize"] < len(ops) * SERVE_CALIB or \
            sweep["histogram"] != sweep["quantize"]:
        raise AssertionError(f"the RD sweep's encodes skipped a kernel: "
                             f"{sweep}")

    floor = float(np.median([p.psnr_db for p in table]))
    budget = int(np.median([p.bits_per_example for p in table]) * 3)
    imgs = serving_images(cfg, SERVE_N, 41)
    times = [0.01 * i for i in range(SERVE_N)]
    gw = ServingGateway(
        model, bank, controller=RateController(table, quality_floor_db=floor),
        channel=SimulatedChannel(ChannelConfig(
            bandwidth_bps=100e6, base_latency_s=0.01, tick_s=0.05,
            budget_bits_per_tick=budget)),
        max_batch=SERVE_MAX_BATCH, device=dev)
    gw.serve(imgs, submit_times=times)           # warm-up, same shapes
    gw.channel.reset()
    seen = watch_batches(gw.executor)
    registry = MetricsRegistry()
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    _build.reset_launches()
    with hooks.active(registry):
        t0 = time.perf_counter()
        resp, tel = gw.serve(imgs, submit_times=times)
        wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_batches = round(sum(1.0 / r.batch_size for r in tel.records))
    print(f"single-tenant serve launches: {launches}; micro-batches in the "
          f"telemetry {n_batches}, executor tickets {len(seen)}, sizes "
          f"{[(len(b.requests), b.padded_size) for b, _ in seen]}")
    want = {"quantize": SERVE_N, "histogram": SERVE_N,
            "consolidate": n_batches}
    if {k: v for k, v in launches.items() if v} != want or \
            n_batches != len(seen):
        raise AssertionError(f"the serve launched {launches}, not {want}")

    # checks, after the counts were read
    summ = tel.summary(wall_s=wall)
    stages = {}
    for name, labels, m in registry.collect():
        if name == "stage_seconds":
            stages[labels["stage"]] = (m.count, m.total)
    print(f"single tenant ({smi}): {SERVE_N} requests in {wall!r} s wall, "
          f"{SERVE_N / wall!r} requests/s; telemetry p50 "
          f"{summ['p50_latency_s'] * 1e3!r} ms, p99 "
          f"{summ['p99_latency_s'] * 1e3!r} ms (virtual clock: channel plus "
          f"measured compute), p50 compute {summ['p50_compute_s'] * 1e3!r} "
          f"ms; operating points {summ['operating_points']}; mean wire "
          f"bits {summ['mean_bits_on_wire']!r}; peak memory "
          f"{peak / 1e9!r} GB, of which {(peak - held) / 1e9!r} GB above "
          f"what earlier phases still held")
    for stage, (count, total) in sorted(stages.items()):
        print(f"  hooked stage {stage}: {count} calls, {total * 1e3!r} ms "
              f"host clock in all, {total / count * 1e3!r} ms a call")
    check_served(resp, seen, cfg.num_classes, SERVE_N)
    check_batch_on_path(dev, gw, seen, imgs)

    def run():
        t0 = time.perf_counter()
        gw.serve(imgs, submit_times=times)
        sync(dev)
        return time.perf_counter() - t0
    gw.channel.reset()
    rows, pwall = _device_rows(run, [ProfilerActivity.CUDA])
    busy = sum(r[0] for r in rows) / 1e6
    rows.sort(reverse=True)
    print(f"single-tenant serve under the profiler: device busy {busy * 1e3!r}"
          f" ms of {pwall * 1e3!r} ms wall (busy share {busy / pwall!r}); "
          f"top: " + "; ".join(f"{k[:50]} {us / 1e3!r} ms"
                               for us, k, _ in rows[:6]))
    overload_path(dev, model, bank, cfg)
    gateway_card_vs_cpu(dev)


def check_served(resp, seen, num_classes: int, n: int) -> None:
    """Every request answered once, with its own row of its micro-batch's
    logits (padding rows dropped), finite, of the model's width."""
    rows = {}
    for batch, logits in seen:
        if logits.shape[0] != batch.padded_size:
            raise AssertionError(f"batch of {len(batch.requests)} padded to "
                                 f"{batch.padded_size} gave {logits.shape}")
        for i, r in enumerate(batch.requests):
            rows[r.req_id] = logits[i]
    if len(resp) != n or sorted(rows) != list(range(n)):
        raise AssertionError("a request was not answered exactly once")
    for r in resp:
        if r.logits.shape != (num_classes,) or \
                not np.isfinite(r.logits).all() or \
                not np.array_equal(r.logits, rows[r.req_id]):
            raise AssertionError(f"request {r.req_id}: bad logits")
    print(f"{n} responses, one each, logits ({num_classes},) finite, each its "
          f"micro-batch's own row; padded rows dropped: yes")


def check_batch_on_path(dev, gw, seen, imgs) -> None:
    """The most padded micro-batch of the serve, again: its fused restore
    against the fused=False plan's (RESTORE_TOL), the consolidate kernel
    bit for bit against its plain version on its own estimate, and the
    quantize and histogram kernels on its first request's z."""
    import torch
    from repro_torch import pipeline
    from repro_torch.kernels.histogram import histogram, histogram_plain
    from repro_torch.kernels.quantize import quantize_fused, quantize_plain

    batch = max((b for b, _ in seen), key=lambda b: b.pad)
    op = batch.key.op
    plan = gw.plan_for(op)
    spec = gw._specs[op.c]
    ref = pipeline.compile(op, spec, fused=False, device=dev)
    decoded = plan.decode_batch([r.blob for r in batch.requests]) \
        .pad_to(batch.padded_size)
    got, want = plan.restore(decoded), ref.restore(decoded)
    diff = float((got - want).abs().max())
    baf, sel = gw.baf_bank[op.c]
    err = check_consolidate_on_path(dev, gw.params, baf, sel, decoded,
                                    bits=op.bits)
    print(f"micro-batch of {len(batch.requests)} padded to "
          f"{batch.padded_size} at {op}: fused vs fused=False restore max abs "
          f"diff {diff!r}; consolidate kernel vs plain max abs diff {err!r}")
    if not torch.allclose(got, want, rtol=RESTORE_TOL, atol=RESTORE_TOL):
        raise AssertionError("fused and plain restore disagree")
    z = gw._edge_fn(gw._to_device(imgs[batch.requests[0].req_id]))
    n, h, w, p = z.shape
    sel_t = torch.as_tensor(np.asarray(sel, np.int32), device=dev)
    q = quantize_fused(z.contiguous().view(n, h * w, p), op.bits, sel_t)
    qp = quantize_plain(z.contiguous().view(n, h * w, p), op.bits,
                        sel_t.long())
    codes = q[0].view(h * w, op.c)
    hk, hp = histogram(codes, 1 << op.bits), histogram_plain(codes,
                                                             1 << op.bits)
    sync(dev)
    same = all(bits_equal(a, b) for a, b in zip(q, qp)) and \
        bool(torch.equal(hk, hp))
    print(f"quantize and histogram kernels on a served request's z at {op}: "
          f"{'identical to' if same else 'DIFFER from'} their plain versions")
    if not same:
        raise AssertionError("kernels differ on the serving path")


def overload_path(dev, model, bank, cfg) -> None:
    """gateway_demo part 7 at full width: gold/silver/bronze, a 3x burst
    against two queues on a deterministic cost model, queue-depth admission
    by priority. Every request ends served or shed; the scheduler's grants
    are the containers' bits; a second run replays the telemetry; a traced
    run gives the same telemetry, spans that sum to each latency and a
    valid Chrome trace. A full-width container is ~300x the demo's 32x32
    one, so each tenant's link runs at 1 Gbit/s, not the demo's 50 Mbit/s:
    the burst then overloads the cloud, as in the demo, and not the
    links."""
    from repro_torch.obs import Tracer, reconcile_trace, validate_chrome_trace
    from repro_torch.pipeline import OperatingPoint
    from repro_torch.serve import (ChannelConfig, LinearCostModel,
                                   MultiQueueExecutor, MultiTenantGateway,
                                   QueueDepthAdmission, TenantRequest,
                                   TenantSpec, priority_depth_limits)

    tiers = [TenantSpec("gold", weight=2.0, priority=2),
             TenantSpec("silver", priority=1),
             TenantSpec("bronze", priority=0)]
    gw = MultiTenantGateway(
        model, bank, tenants=tiers,
        channel_cfg=ChannelConfig(bandwidth_bps=1e9, base_latency_s=0.001),
        default_op=OperatingPoint(c=min(bank), bits=8, backend="rans"),
        max_batch=4, batch_window_s=0.002,
        executor=MultiQueueExecutor(2, cost=LinearCostModel(
            base_s=0.004, per_item_s=0.001)),
        admission=QueueDepthAdmission(2, per_priority=priority_depth_limits(
            2, [0, 1, 2], headroom=2)), device=dev)
    stream = serving_images(cfg, 8, 7)
    burst = [TenantRequest(("gold", "silver", "bronze")[i % 3],
                           stream[i % len(stream)], t_submit=i / 3000.0)
             for i in range(BURST)]
    t0 = time.perf_counter()
    resp, tel = gw.serve_tenants(burst)
    wall = time.perf_counter() - t0
    served = {t: sum(not r.shed for r in rs) for t, rs in resp.items()}
    shed = tel.shed_by_tenant()
    sched = gw.last_scheduler
    grants = {t: q.granted_bits for t, q in sched.tenants.items()}
    wire = {t: sum(r.bits_on_wire for r in tel.records if r.tenant == t)
            for t in grants}
    print(f"overload ({BURST}-request burst, {wall!r} s wall): served "
          f"{served}, shed {shed}; scheduler grants {grants} bits, the "
          f"served containers {wire} bits")
    print(tel.format_summary())
    if sum(served.values()) + len(tel.shed) != BURST or grants != wire or \
            shed.get("bronze", 0) < shed.get("gold", 0) or not tel.shed:
        raise AssertionError("overload: a silent drop, a grant that is not "
                             "the container's bits, or no brown-out")
    again = gw.serve_tenants(burst)[1]
    gw.tracer = Tracer()
    traced = gw.serve_tenants(burst)[1]
    err = reconcile_trace(gw.tracer, traced)
    events = validate_chrome_trace(gw.tracer.to_chrome())
    gw.tracer.validate()
    same = again.records == tel.records and again.shed == tel.shed and \
        traced.records == tel.records and traced.shed == tel.shed
    print(f"overload replayed: telemetry identical {same}; traced run: "
          f"{len(gw.tracer)} spans, {events} Chrome trace events (valid), "
          f"span sums against latencies max error {err!r} s")
    if not same or err > 1e-9:
        raise AssertionError("overload replay or trace check failed")


def gateway_card_vs_cpu(dev) -> None:
    """At smoke scale the same gateway on the card and on the CPU: both
    edges pinned to the CPU's z, LinearCostModel, a rate controller over
    a table swept on the CPU. Wire bytes and RequestRecords identical,
    logits within GATEWAY_CPU_TOL."""
    import torch
    from repro_torch.configs.yolo_baf import smoke_config
    from repro_torch.serve import (ChannelConfig, LinearCostModel,
                                   RateController, SerialExecutor,
                                   ServingGateway, SimulatedChannel,
                                   build_rd_table)

    cpu = torch.device("cpu")
    cfg = smoke_config()._replace(input_size=64)
    imgs = serving_images(cfg, 8, 53)
    cmodel, cbank = serving_system(cpu, cfg, (4, 8), 16)
    zs = {im.tobytes(): cmodel.edge(torch.from_numpy(im[None]))[1]
          for im in imgs}
    table = build_rd_table(cmodel, cbank, imgs[:2], bits_sweep=(4, 8),
                           backend="rans", device=cpu)
    budget = int(sorted(p.bits_per_example for p in table)[2])
    runs = []
    for d in (dev, cpu):
        model, bank = (cmodel, cbank) if d == cpu else \
            serving_system(d, cfg, (4, 8), 16)
        gw = ServingGateway(
            model, bank, max_batch=4, device=d,
            controller=RateController(table, quality_floor_db=0.0),
            channel=SimulatedChannel(ChannelConfig(
                bandwidth_bps=2e6, tick_s=0.004,
                budget_bits_per_tick=budget)),
            executor=SerialExecutor(cost=LinearCostModel()))
        gw._edge_fn = lambda img, d=d: zs[img.cpu().numpy().tobytes()].to(d)
        seen = watch_batches(gw.executor)
        resp, tel = gw.serve(imgs, submit_times=[0.002 * i for i in range(8)])
        runs.append(([r.blob.data for b, _ in seen for r in b.requests],
                     tel.records, np.stack([r.logits for r in resp])))
    (wire, recs, logits), (cwire, crecs, clogits) = runs
    diff = float(np.abs(logits - clogits).max())
    ops = sorted({(r.c, r.bits) for r in recs})
    print(f"gateway card vs CPU at smoke scale ({cfg.input_size}x"
          f"{cfg.input_size}, C 4 and 8, 8 requests, operating points "
          f"{ops}): wire bytes identical {wire == cwire}, RequestRecords "
          f"identical {recs == crecs}; logits max abs diff {diff!r} "
          f"(tolerance {GATEWAY_CPU_TOL} relative and absolute)")
    if wire != cwire or recs != crecs or not np.allclose(
            logits, clogits, rtol=GATEWAY_CPU_TOL, atol=GATEWAY_CPU_TOL):
        raise AssertionError("the gateway disagrees between card and CPU")


# ---------------------------------------------------------------------------
# Phases 7-9: the LM serving path at full width
# ---------------------------------------------------------------------------

def _argmax_tokens(logits):
    import torch
    return torch.argmax(logits.float(), dim=-1)


def _dist(a, b) -> float:
    return max_abs_diff([(a.float(), b.float())])


def _logit_check(label, got, want, tol, why) -> float:
    """max |got - want| <= tol, with the argmax agreement; raises."""
    err = _dist(got, want)
    agree = float((_argmax_tokens(got) == _argmax_tokens(want)).float()
                  .mean())
    print(f"{label}: max abs diff {err!r}, max |logit| "
          f"{float(want.float().abs().max())!r}, tolerance {tol!r} ({why}); "
          f"argmax agreement {agree!r}")
    if not (err <= tol and torch_isfinite(got)):
        raise AssertionError(f"{label}: logits disagree")
    return err


def _f32_checks(label, pairs32, noise, pairs16):
    """pairs32: (name, a, b) in float32, held to LM_F32_RTOL of max |b|;
    pairs16: (name, a, b) in bf16, held to ``noise``, the plain bf16
    evaluation's distance from float32."""
    errs = {}
    for name, a, b in pairs32:
        tol = LM_F32_RTOL * float(b.float().abs().max())
        errs[name + " f32"] = _logit_check(
            f"{label} float32, {name}", a, b, tol,
            f"{LM_F32_RTOL} of max |logit|")
    for name, a, b in pairs16:
        errs[name + " bf16"] = _logit_check(
            f"{label} bf16, {name}", a, b, noise,
            "the plain bf16 path's distance from float32")
    return errs


def _f32_copy(model):
    """The same LM with every weight upcast to float32, computing in it."""
    import copy
    import torch
    m = copy.deepcopy(model).float()
    m.cfg = model.cfg.with_(dtype=torch.float32)
    return m


def torch_isfinite(t) -> bool:
    import torch
    return bool(torch.isfinite(t.float()).all())


def _timed(dev, fn):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def qwen_path(dev) -> dict:
    """qwen2-7b, full config: prefill (flash kernel), token-by-token cache
    fill, greedy decode, checks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import param_count_dense
    from repro_torch.kernels import _build
    from repro_torch.models.lm import init_decode_cache, init_lm, lm_forward
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg = get_config("qwen2_7b")
    torch.cuda.reset_peak_memory_stats(dev)
    (model, t_init) = _timed(dev, lambda: init_lm(cfg, seed=0, device=dev))
    nparams = sum(p.numel() for p in model.parameters())
    print(f"qwen2-7b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads of {cfg.hd}, "
          f"{nparams} parameters held ({param_count_dense(cfg)} by the "
          f"config's count, which leaves out norms and biases), weights in "
          f"{cfg.dtype}; initialised on the card in {t_init!r} s")
    gen = torch.Generator(device=dev).manual_seed(10)
    tokens = torch.randint(0, cfg.vocab, (QWEN_B, QWEN_PROMPT), generator=gen,
                           device=dev)
    prefill = make_prefill_step(cfg)
    step = make_decode_step(cfg)
    batch = {"tokens": tokens}
    prefill(model, batch)                                   # warm-up
    # the counted run: prefill, cache fill, decode
    _build.reset_launches()
    logits, t_prefill = _timed(dev, lambda: prefill(model, batch))
    after_prefill = {k.name: k.launches for k in _build.KERNELS}
    # room for the prompt, the decode and one profiled step
    cache = init_decode_cache(cfg, QWEN_B, QWEN_PROMPT + GEN + 1, device=dev)

    def fill():
        nonlocal cache
        out = None
        for t in range(QWEN_PROMPT):
            out, cache = step(model, cache, tokens[:, t])
        return out
    last, t_fill = _timed(dev, fill)
    tok = _argmax_tokens(logits[:, -1])
    generated = [tok]

    def decode():
        nonlocal cache, tok
        for _ in range(GEN):
            lt, cache = step(model, cache, tok)
            tok = _argmax_tokens(lt)
            generated.append(tok)
        return lt
    last_decode, t_decode = _timed(dev, decode)
    launches = {k.name: k.launches for k in _build.KERNELS}
    print(f"qwen2-7b launches: after prefill {after_prefill}; after cache "
          f"fill and decode {launches}")
    if launches["flash_attention"] != cfg.n_layers or \
            after_prefill["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"qwen2-7b prefill launched flash "
                             f"{launches['flash_attention']} times, expected "
                             f"{cfg.n_layers}")
    peak = torch.cuda.max_memory_allocated(dev)

    if tuple(logits.shape) != (QWEN_B, QWEN_PROMPT, cfg.vocab) or \
            not torch_isfinite(logits) or not torch_isfinite(last_decode):
        raise AssertionError("qwen2-7b logits have the wrong shape or are "
                             "not finite")
    # the same model with the plain attention in place of the kernel
    plain = lm_forward(model, tokens=tokens, attention="blocked")[0]
    # the same weights in float32: prefill with the kernel and with plain
    # attention, and the cache fill
    m32 = _f32_copy(model)
    logits32 = prefill(m32, batch)
    plain32 = lm_forward(m32, tokens=tokens, attention="blocked")[0]
    cache32 = init_decode_cache(m32.cfg, QWEN_B, QWEN_PROMPT, device=dev)
    for t in range(QWEN_PROMPT):
        last32, cache32 = step(m32, cache32, tokens[:, t])
    del m32, cache32
    noise = _dist(plain, plain32)
    checks = _f32_checks("qwen2-7b", [
        ("prefill: flash kernel vs plain attention", logits32, plain32),
        ("last prompt position: prefill vs cache fill (decode attention)",
         last32, logits32[:, -1])], noise, [
        ("prefill: flash kernel vs plain attention", logits, plain),
        ("last prompt position: prefill vs cache fill (decode attention)",
         last, logits[:, -1])])
    print(f"qwen2-7b bf16 against float32 of the same weights: prefill with "
          f"the kernel {_dist(logits, logits32)!r}, with plain attention "
          f"{noise!r}, cache fill {_dist(last, last32)!r} (max abs)")
    del logits32, plain32
    rows = [[int(t[i]) for t in generated] for i in range(QWEN_B)]
    print(f"qwen2-7b greedy tokens: {rows}")
    times = dict(prefill_ms=t_prefill * 1e3,
                 cache_fill_ms_per_token=t_fill * 1e3 / QWEN_PROMPT,
                 decode_ms_per_token=t_decode * 1e3 / GEN,
                 peak_gb=peak / 1e9)
    print(f"qwen2-7b times (host clock, synchronised): prefill of "
          f"{QWEN_B}x{QWEN_PROMPT} tokens {times['prefill_ms']!r} ms; cache "
          f"fill {times['cache_fill_ms_per_token']!r} ms per step; decode "
          f"{times['decode_ms_per_token']!r} ms per step of {QWEN_B} tokens; "
          f"peak memory {times['peak_gb']!r} GB")
    profile_top(dev, "qwen2-7b prefill", lambda: prefill(model, batch))
    profile_top(dev, "qwen2-7b decode step", lambda: step(model, cache, tok))
    del model, cache, logits, plain
    torch.cuda.empty_cache()
    return dict(launches=launches, times=times, checks=checks)


def rwkv_path(dev) -> dict:
    """rwkv6-3b, full config: prefill, long ingest, decode from the ingest
    state; ingest against one long prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import param_count_dense
    from repro_torch.kernels import _build
    from repro_torch.models.lm import DecodeCache, init_lm
    from repro_torch.serve.engine import (make_decode_step, make_long_ingest,
                                          make_prefill_step)

    cfg = get_config("rwkv6_3b")
    torch.cuda.reset_peak_memory_stats(dev)
    (model, t_init) = _timed(dev, lambda: init_lm(cfg, seed=1, device=dev))
    nparams = sum(p.numel() for p in model.parameters())
    print(f"rwkv6-3b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.d_model // cfg.ssm.head_dim} heads of {cfg.ssm.head_dim}, "
          f"chunk {cfg.ssm.chunk}, {nparams} parameters held "
          f"({param_count_dense(cfg)} by the config's count); initialised on "
          f"the card in {t_init!r} s")
    gen = torch.Generator(device=dev).manual_seed(11)
    prompt = torch.randint(0, cfg.vocab, (RWKV_B, RWKV_PROMPT), generator=gen,
                           device=dev)
    long_toks = torch.randint(0, cfg.vocab, (RWKV_B, RWKV_LONG),
                              generator=gen, device=dev)
    prefill = make_prefill_step(cfg)
    ingest = make_long_ingest(cfg, block=RWKV_BLOCK)
    step = make_decode_step(cfg)
    prefill(model, {"tokens": prompt})                       # warm-up
    _build.reset_launches()
    logits, t_prefill = _timed(dev, lambda: prefill(model,
                                                    {"tokens": prompt}))
    n_prefill = _build.LINEAR_SCAN.launches
    (last, state), t_ingest = _timed(dev, lambda: ingest(model, long_toks))
    n_ingest = _build.LINEAR_SCAN.launches - n_prefill
    cache = DecodeCache(rwkv=state.layer_states)
    tok = _argmax_tokens(last)
    generated = [tok]

    def decode():
        nonlocal cache, tok
        for _ in range(GEN):
            lt, cache = step(model, cache, tok)
            tok = _argmax_tokens(lt)
            generated.append(tok)
        return lt
    last_decode, t_decode = _timed(dev, decode)
    launches = {k.name: k.launches for k in _build.KERNELS}
    print(f"rwkv6-3b linear-scan launches: prefill {n_prefill} (expected "
          f"{cfg.n_layers}), ingest {n_ingest} (expected {cfg.n_layers} x "
          f"{RWKV_LONG // RWKV_BLOCK}); all launches over the path {launches}")
    if n_prefill != cfg.n_layers or \
            n_ingest != cfg.n_layers * (RWKV_LONG // RWKV_BLOCK):
        raise AssertionError("rwkv6-3b did not run the scan kernel per layer")
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(logits.shape) != (RWKV_B, RWKV_PROMPT, cfg.vocab) or \
            not torch_isfinite(logits) or not torch_isfinite(last_decode):
        raise AssertionError("rwkv6-3b logits have the wrong shape or are "
                             "not finite")
    full, t_full = _timed(dev, lambda: prefill(model, {"tokens": long_toks}))
    full = full[:, -1]
    m32 = _f32_copy(model)
    last32, _ = make_long_ingest(m32.cfg, block=RWKV_BLOCK)(m32, long_toks)
    full32 = prefill(m32, {"tokens": long_toks})[:, -1]
    del m32
    noise = _dist(full, full32)
    label = (f"last position: ingest of {RWKV_LONG} tokens in blocks of "
             f"{RWKV_BLOCK} vs one {RWKV_LONG}-token prefill")
    checks = _f32_checks("rwkv6-3b", [(label, last32, full32)], noise,
                         [(label, last, full)])
    print(f"rwkv6-3b bf16 against float32 of the same weights, last "
          f"position: {RWKV_LONG}-token prefill {noise!r}, ingest "
          f"{_dist(last, last32)!r} (max abs)")
    rows = [[int(t[i]) for t in generated] for i in range(RWKV_B)]
    print(f"rwkv6-3b greedy tokens after the ingest: {rows}")
    times = dict(prefill_ms=t_prefill * 1e3, ingest_ms=t_ingest * 1e3,
                 long_prefill_ms=t_full * 1e3,
                 decode_ms_per_token=t_decode * 1e3 / GEN,
                 peak_gb=peak / 1e9)
    print(f"rwkv6-3b times (host clock, synchronised): prefill of "
          f"{RWKV_B}x{RWKV_PROMPT} tokens {times['prefill_ms']!r} ms; ingest "
          f"of {RWKV_B}x{RWKV_LONG} {times['ingest_ms']!r} ms; one "
          f"{RWKV_LONG}-token prefill {times['long_prefill_ms']!r} ms; decode "
          f"{times['decode_ms_per_token']!r} ms per step of {RWKV_B} tokens; "
          f"peak memory {times['peak_gb']!r} GB (the one long prefill "
          f"included)")
    profile_top(dev, "rwkv6-3b prefill", lambda: prefill(model,
                                                         {"tokens": prompt}))
    profile_top(dev, f"rwkv6-3b ingest of {RWKV_LONG} tokens",
                lambda: ingest(model, long_toks))
    profile_top(dev, "rwkv6-3b decode step", lambda: step(model, cache, tok))
    del model, cache, logits, full
    torch.cuda.empty_cache()
    return dict(launches=launches, times=times, checks=checks,
                n_prefill=n_prefill, n_ingest=n_ingest)


def profile_top(dev, label: str, fn, top: int = 8) -> None:
    """Device time of one call by kernel name, and the device's busy share
    of the call's wall time."""
    from torch.profiler import ProfilerActivity
    sync(dev)

    def run():
        t0 = time.perf_counter()
        fn()
        sync(dev)
        return time.perf_counter() - t0
    rows, wall = _device_rows(run, [ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    print(f"{label}: device busy {busy / 1e3!r} ms of {wall * 1e3!r} ms wall "
          f"under the profiler (busy share {busy / 1e6 / wall!r}); top "
          f"kernels: " + "; ".join(f"{k[:60]} {us / 1e3!r} ms"
                                   for us, k, _ in rows[:top]))


def lms_card_vs_cpu(dev) -> float:
    """Smoke-scale LMs in float32 from one seed: kernels on the card against
    the plain versions on the CPU (prefill, 3 decode steps, rwkv ingest)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import init_decode_cache, init_lm
    from repro_torch.serve.engine import (make_decode_step, make_long_ingest,
                                          make_prefill_step)

    cpu = torch.device("cpu")
    worst = 0.0
    for arch in ("qwen2_7b", "rwkv6_3b"):
        cfg = get_smoke_config(arch).with_(dtype=torch.float32)
        ref = init_lm(cfg, seed=5, device=cpu)
        card = init_lm(cfg, seed=5, device=cpu).to(dev)
        toks = torch.randint(0, cfg.vocab, (2, 128),
                             generator=torch.Generator().manual_seed(6))
        pairs = [(make_prefill_step(cfg)(card, {"tokens": toks.to(dev)}),
                  make_prefill_step(cfg)(ref, {"tokens": toks}))]
        step = make_decode_step(cfg)
        cc = init_decode_cache(cfg, 2, 8, device=dev)
        rc = init_decode_cache(cfg, 2, 8, device=cpu)
        for t in range(3):
            lc, cc = step(card, cc, toks[:, t].to(dev))
            lr, rc = step(ref, rc, toks[:, t])
            pairs.append((lc, lr))
        if cfg.family == "ssm":
            ingest = make_long_ingest(cfg, block=32)
            (lc, sc), (lr, sr) = ingest(card, toks.to(dev)), ingest(ref, toks)
            pairs.append((lc, lr))
            pairs += [(a.wkv, b.wkv) for a, b in zip(sc.layer_states,
                                                     sr.layer_states)]
        pairs = [(a.cpu(), b) for a, b in pairs]
        err = max_abs_diff(pairs)
        ok = all(torch.allclose(a, b, atol=LM_CPU_TOL, rtol=LM_CPU_TOL)
                 for a, b in pairs)
        print(f"{arch} smoke config in float32, card (kernels) vs CPU (plain "
              f"versions): prefill, 3 decode steps"
              f"{', ingest and its states' if cfg.family == 'ssm' else ''}: "
              f"max abs diff {err!r} (tolerance {LM_CPU_TOL} relative and "
              f"absolute)")
        if not ok:
            raise AssertionError(f"{arch}: card and CPU disagree")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Phase 10: kernel times
# ---------------------------------------------------------------------------

def timed(fn):
    """(device ms per call from the profiler, ms per call between CUDA
    events, device operations per call)."""
    ms, ops = device_ms(fn)
    return ms, event_ms(fn), ops


def time_kernels(dev, errs: dict, launches: dict, path_codes) -> list:
    import torch
    from repro_torch.kernels.consolidate import (consolidate_fused,
                                                 consolidate_plain)
    from repro_torch.kernels.histogram import histogram, histogram_plain
    from repro_torch.kernels.quantize import (channel_order, quantize_fused,
                                              quantize_plain)

    gen = torch.Generator().manual_seed(1)
    rows = []

    def row(name, src, replaces, kernel, plain, nbytes, library, note,
            flops=0.0, peak=F32_FLOPS):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / peak * 1e3
        bound = max(by_bytes, by_ops)
        lib = None if library is None else library[0]
        print(f"time {name} ({note}): device time per call, from the "
              f"profiler: kernel {kernel[0]!r} ms, plain {plain[0]!r} ms, "
              f"library {lib!r} ms; bound {bound!r} ms ({nbytes} bytes -> "
              f"{by_bytes!r} ms; {flops!r} flops at {peak:g}/s -> {by_ops!r} "
              f"ms); per call between CUDA events, launch included: kernel "
              f"{kernel[1]!r} ms, plain {plain[1]!r} ms, library "
              f"{None if library is None else library[1]!r} ms; device "
              f"operations per call: kernel {kernel[2]!r}, plain "
              f"{plain[2]!r}, library "
              f"{None if library is None else library[2]!r}")
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches[name], max_abs_err=errs[name],
                    ms=kernel[0], plain_ms=plain[0], bound_ms=bound,
                    bound_by="bytes" if by_bytes >= by_ops else "operations",
                    library_ms=lib)

    def quantize_times(b):
        x = torch.randn((b, R, P), generator=gen).to(dev)
        sel = torch.randperm(P, generator=gen)[:C].to(torch.int32).to(dev)
        sel64 = sel.long()
        order = channel_order(sel)      # once per selection, as the plan
        ms = timed(lambda: quantize_fused(x, BITS, sel, order=order))
        plain = timed(lambda: quantize_plain(x, BITS, sel64))
        # selected elements read once, codes and fp16 side info written once
        nbytes = b * R * C * 4 + C * 4 + b * R * C + 2 * b * C * 2
        # 32-byte sectors of x that the gather touches
        sectors = len(set((sel.cpu().numpy() * 4 // 32).tolist()))
        return ms, plain, nbytes, b * R * sectors * 32

    def histogram_times(codes):
        offs = torch.arange(C, device=dev) * 256
        ms = timed(lambda: histogram(codes, 256))
        plain = timed(lambda: histogram_plain(codes, 256))
        lib = timed(lambda: torch.bincount(
            (codes.long() + offs).view(-1), minlength=C * 256))
        return ms, plain, lib, codes.numel() + C * 256 * 4

    def uniform(k):
        return torch.randint(0, 256, (k, C), generator=gen,
                             dtype=torch.uint8).to(dev)

    def consolidate_times(b):
        z = torch.randn((b, R, P), generator=gen).to(dev)
        sel = torch.randperm(P, generator=gen)[:C].to(torch.int32).to(dev)
        order = channel_order(sel)      # once per selection, as the plan
        codes, mins, maxs = quantize_fused(z, BITS, sel, order=order)
        est = z + 0.3 * torch.randn((b, R, P), generator=gen).to(dev)
        sel64 = sel.long()
        ms = timed(lambda: consolidate_fused(est, codes, mins, maxs, BITS,
                                             sel, order=order))
        plain = timed(lambda: consolidate_plain(est, codes, mins, maxs,
                                                BITS, sel64))
        # selected elements of z read and written once, codes, side info
        # and sel read once
        nbytes = 2 * b * R * C * 4 + b * R * C + 2 * b * C * 2 + C * 4
        # 32-byte sectors of z that hold a selected channel, read and
        # written
        sectors = len(set((sel.cpu().numpy() * 4 // 32).tolist()))
        return ms, plain, nbytes, 2 * b * R * sectors * 32

    q1 = quantize_times(1)
    q8 = quantize_times(B)
    h1 = histogram_times(uniform(R))
    h8 = histogram_times(uniform(B * R))
    hp = histogram_times(path_codes)
    c8 = consolidate_times(B)
    rows.append(row("quantize", "src/repro_torch/csrc/quantize.cu",
                    "src/repro/kernels/quantize.py:48", q1[0], q1[1], q1[2],
                    None, f"main path B=1 R={R} P={P} C={C}; the gather "
                    f"touches {q1[3]} bytes of 32-byte sectors"))
    row("quantize", "", "", q8[0], q8[1], q8[2], None,
        f"slice B={B} R={R} P={P} C={C}; the gather touches {q8[3]} bytes "
        f"of 32-byte sectors")
    rows.append(row("histogram", "src/repro_torch/csrc/histogram.cu",
                    "src/repro/kernels/histogram.py:61", h1[0], h1[1], h1[3],
                    h1[2], f"main path K={R} C={C} nsym=256, uniform codes"))
    row("histogram", "", "", h8[0], h8[1], h8[3], h8[2],
        f"slice K={B * R} C={C} nsym=256, uniform codes")
    row("histogram", "", "", hp[0], hp[1], hp[3], hp[2],
        f"main path K={R} C={C} nsym=256, the quantize kernel's codes of "
        f"the edge CNN's z")
    rows.append(row("consolidate", "src/repro_torch/csrc/consolidate.cu",
                    "src/repro/kernels/consolidate.py:37", c8[0], c8[1],
                    c8[2], None, f"main path B={B} R={R} P={P} C={C}, the "
                    f"plan's channel table; the kernel reads and writes "
                    f"{c8[3]} bytes of 32-byte sectors of z"))
    rows += time_cdf(dev, row, gen)
    rows += time_lm_kernels(dev, row, gen)
    return rows


def time_cdf(dev, row, gen) -> list:
    """cdf at the cdf path's shape and layout, row-major, and at 12 bits."""
    import torch
    from repro_torch.kernels.histogram import cdf, cdf_plain

    out = []
    nsym = 1 << BITS
    counts = torch.randint(0, 64, (nsym, C), generator=gen,
                           dtype=torch.int32).to(dev)
    # the cdf path's layout: the (S, C) view of the histogram's (C, S)
    # counts, into the (S, C) view of a (C, S) buffer
    cols = counts.t().contiguous().t()
    dst = torch.empty_like(cols)
    out.append(row("cdf", "src/repro_torch/csrc/cdf.cu",
                   "src/repro/kernels/histogram.py:104",
                   timed(lambda: cdf(cols, out=dst)),
                   timed(lambda: cdf_plain(cols)), 2 * nsym * C * 4,
                   timed(lambda: torch.cumsum(cols, dim=0)),
                   f"cdf path S={nsym} C={C} through (C, S) views, library "
                   f"torch.cumsum"))
    row("cdf", "", "", timed(lambda: cdf(counts)),
        timed(lambda: cdf_plain(counts)), 2 * nsym * C * 4,
        timed(lambda: torch.cumsum(counts, dim=0)),
        f"S={nsym} C={C} row-major (S, C), library torch.cumsum")
    big = torch.randint(0, 64, (4096, C), generator=gen,
                        dtype=torch.int32).to(dev).t().contiguous().t()
    row("cdf", "", "", timed(lambda: cdf(big)),
        timed(lambda: cdf_plain(big)), 2 * 4096 * C * 4,
        timed(lambda: torch.cumsum(big, dim=0)),
        f"S=4096 (12 bits) C={C} through (C, S) views, library "
        f"torch.cumsum")
    return out


def time_lm_kernels(dev, row, gen) -> list:
    """flash at the qwen2-7b prefill's shape, the linear scan at the
    rwkv6-3b prefill's and ingest block's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.linear_scan import (_scratch_floats, linear_scan,
                                                 linear_scan_plain)

    out = []

    b, s, h, kh, hd = QWEN_B, QWEN_PROMPT, 28, 4, 128
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((b, s, h, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, kh, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, kh, hd), generator=g, device=dev).to(torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = s * (s + 1) // 2                      # unmasked (q, k), causal
    flops = 4.0 * b * h * hd * pairs
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())   # bf16 q,k,v,o
    out.append(row(
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:81",
        timed(lambda: flash_attention(q, k, v, causal=True)),
        timed(lambda: flash_attention_plain(q, k, v, causal=True)), nbytes,
        timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        f"qwen2-7b prefill B={b} S={s} H={h} KH={kh} hd={hd} bf16 causal; "
        f"library F.scaled_dot_product_attention(enable_gqa=True) on "
        f"(B, H, S, hd) copies", flops=flops, peak=BF16_FLOPS))

    for name, s_, init in (("linear_scan", RWKV_PROMPT, False),
                           ("linear_scan/ingest_block", RWKV_BLOCK, True)):
        b, h, dk, dv, L = RWKV_B, 40, 64, 64, 16
        qs = torch.randn((b, s_, h, dk), generator=g, device=dev) * 0.5
        ks = torch.randn((b, s_, h, dk), generator=g, device=dev) * 0.5
        vs = torch.randn((b, s_, h, dv), generator=g, device=dev)
        qs, ks, vs = (t.to(torch.bfloat16) for t in (qs, ks, vs))
        ld = -torch.exp(torch.randn((b, s_, h, dk), generator=g,
                                    device=dev) - 1.0)
        u = torch.randn((h, dk), generator=g, device=dev) * 0.1
        s0 = torch.randn((b, h, dk, dv), generator=g, device=dev) \
            if init else None
        kw = dict(bonus=u, initial_state=s0, chunk=L, mode="rwkv")
        # bf16 q, k, v and f32 decay read once; f32 y and state written once
        nbytes = b * s_ * h * (2 * dk * 2 + dv * 2 + dk * 4 + dv * 4) \
            + h * dk * 4 + (2 if init else 1) * b * h * dk * dv * 4
        nc = s_ // L
        # the intra-chunk products over the (t, s) pairs the rwkv mask keeps
        # (s < t; s <= t in ssm mode), the carried state in and out, and
        # the elementwise decay and bonus terms
        pairs = L * (L - 1) // 2 if kw["mode"] == "rwkv" else L * (L + 1) // 2
        per_chunk = (2 * pairs * dk + 2 * pairs * dv + 2 * L * dk * dv
                     + 2 * L * dk * dv + 3 * L * dk + 5 * L * dk)
        flops = float(b * h * nc * per_chunk)
        out.append(row(
            name, "src/repro_torch/csrc/linear_scan.cu",
            "src/repro/kernels/linear_scan.py:80",
            timed(lambda: linear_scan(qs, ks, vs, ld, **kw)),
            timed(lambda: linear_scan_plain(qs, ks, vs, ld, **kw)),
            nbytes, None,
            f"rwkv6-3b {'ingest block' if init else 'prefill'} B={b} "
            f"S={s_} H={h} dk=dv={dk} chunk {L}, rwkv with bonus"
            f"{', initial state' if init else ''}; scratch "
            f"{_scratch_floats(b, h, nc, L, dk, dv) * 4} bytes",
            flops=flops))
    return out


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
    errs.update(check_lm_kernels(dev))
    cfg = full_config()
    print(f"main path: {cfg}, split {cfg.split_hw}x{cfg.split_hw}x"
          f"{cfg.split_p}, Q={cfg.split_q}, C={C}, bits={BITS}, rans, fused")
    res = main_path(dev, cfg)
    errs["consolidate"] = max(errs["consolidate"], res["consolidate_err"])
    errs["histogram"] = max(errs["histogram"], res["histogram_err"])
    for k, v in res["times"].items():
        print(f"stage {k}: {v * 1e3!r} ms per request")
    launches = dict(res["launches"])
    launches["cdf"] = cdf_path(dev, res["decoded"])["cdf"]
    offline_path(dev, smi)
    serving_path(dev, smi)
    qwen = qwen_path(dev)
    rwkv = rwkv_path(dev)
    launches["flash_attention"] = qwen["launches"]["flash_attention"]
    # the scan's two rows: its launches in the prefill and in the ingest
    launches["linear_scan"] = rwkv["n_prefill"]
    launches["linear_scan/ingest_block"] = rwkv["n_ingest"]
    lms_card_vs_cpu(dev)
    errs["linear_scan/ingest_block"] = errs["linear_scan"]
    rows = time_kernels(dev, errs, launches, res["path_codes"])
    print(f"total {time.perf_counter() - t_start!r} s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
