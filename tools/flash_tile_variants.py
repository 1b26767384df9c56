#!/usr/bin/env python3
"""Time tile-shape variants of the bf16 flash-attention kernel on the card.

    python3 tools/flash_tile_variants.py

Needs one CUDA device and nvcc. Each variant is the source
``src/repro_torch/csrc/flash_attention.cu`` with the tensor-core kernel's
q rows per block (BQ: 128 = two warpgroups, 64 = one) and its minimum
resident blocks per SM (``__launch_bounds__``, which caps the registers)
edited, built with the port's own nvcc flags into ``build/repro_torch/
variants/``. At the qwen2-7b prefill's shape (B=2, S=512, 28 q / 4 kv heads,
hd 128, causal) every variant and ``scaled_dot_product_attention`` are timed
in turns, two rounds, with CUDA events over back-to-back calls, and each
variant is held against the plain version at the kernel tests' 3e-2.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (q rows per block, threads, minimum blocks per SM); the first is the
# source as committed
VARIANTS = ((128, 256, 2), (128, 256, 1), (64, 128, 2), (64, 128, 3),
            (64, 128, 4))


def variant_source(src: str, bq: int, nt: int, min_blocks: int) -> str:
    head, tc = src.split("namespace tc {", 1)
    for old, new in (("constexpr int BQ = 128;", f"constexpr int BQ = {bq};"),
                     ("constexpr int NT = 256;", f"constexpr int NT = {nt};"),
                     ("__launch_bounds__(NT, 2)",
                      f"__launch_bounds__(NT, {min_blocks})")):
        if old not in tc:
            raise SystemExit(f"flash_attention.cu no longer holds {old!r}")
        tc = tc.replace(old, new, 1)
    return head + "namespace tc {" + tc


def build(out_dir: Path, nvcc_flags) -> dict:
    from repro_torch.kernels import _build
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for bq, nt, mb in VARIANTS:
        name = f"bq{bq}_minblocks{mb}"
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, bq, nt, mb))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *nvcc_flags, "-Xptxas", "-v", "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: registers by instantiation {regs}, spill stores "
              f"{spills} bytes")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).flash_attention_bf16
        fn.argtypes = _build._FLASH_ARGS
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def event_us(fn, iters: int = 200) -> float:
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}")
    fns = build(_build.BUILD_DIR / "variants", _build.NVCC_FLAGS)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    b, s, h, kh, hd = 2, 512, 28, 4, 128
    q = torch.randn((b, s, h, hd), generator=g, device=dev).bfloat16()
    k = torch.randn((b, s, kh, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((b, s, kh, hd), generator=g, device=dev).bfloat16()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    want = flash_attention_plain(q, k, v, causal=True).float()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, s, h, kh, hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], 1, 0, 0, stream)
        if err:
            raise SystemExit(f"launch returned cudaError_t {err}")

    for rnd in range(2):
        for name, fn in fns.items():
            call(fn)
            torch.cuda.synchronize()
            err = float((out.float() - want).abs().max())
            if not err <= 3e-2:
                raise SystemExit(f"{name} differs from plain: {err}")
            print(f"round {rnd} {name}: {event_us(lambda: call(fn))!r} us "
                  f"per call (CUDA events, back to back); max abs diff "
                  f"{err!r}")
        sdpa = event_us(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        print(f"round {rnd} scaled_dot_product_attention: {sdpa!r} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
