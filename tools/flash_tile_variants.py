#!/usr/bin/env python3
"""Time tile-shape variants of the flash-attention kernels on the card.

    python3 tools/flash_tile_variants.py [--f32]

Needs one CUDA device and nvcc. Each variant is the source
``src/repro_torch/csrc/flash_attention.cu`` with one kernel's block shape
edited, built with the port's own nvcc flags and ``-Xptxas -v`` into
``build/repro_torch/variants/``; every variant and
``scaled_dot_product_attention`` are timed in turns, two rounds, with CUDA
events over back-to-back calls, and each variant is held against the plain
version at the kernel tests' tolerance first.

bf16 (default): the tensor-core kernel's q rows per block (BQ: 128 = two
warpgroups, 64 = one) and its minimum resident blocks per SM
(``__launch_bounds__``, which caps the registers), at the qwen2-7b
prefill's shape (B=2, S=512, 28 q / 4 kv heads, hd 128, causal), 3e-2.

``--f32``: the float32 kernel's warps per block (each owns 16 q rows), its
minimum resident blocks per SM below head dim 128 and its keys a kv tile
at head dims up to 32, at the detect
head's shape (B=8, S=4096, 2 heads, hd 16, not causal) and at qwen2-7b's
prefill shape in float32, 2e-5. ptxas's registers, spills and static
shared memory are printed for every instantiation (the float32 kernel's
shared memory is dynamic: ``Tiles<HD>::WORDS`` words, in the source).

``--f32-probes``: the committed float32 kernel beside probes of it, each
built with one part taken out or replaced (their outputs are wrong; they
only split the time), at the detect head's shape; and the opcode counts of
the committed kernel's SASS at hd 16 (``cuobjdump -sass``).
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# bf16: (q rows per block, threads, minimum blocks per SM); the first is
# the source as committed
VARIANTS = ((128, 256, 2), (128, 256, 1), (64, 128, 2), (64, 128, 3),
            (64, 128, 4))
# float32: (warps per block, minimum blocks per SM, keys a kv tile up to
# hd 32); the first as committed
F32_VARIANTS = ((8, 2, 32), (8, 2, 64), (8, 2, 16), (8, 3, 32), (4, 4, 32))


# Probes of the float32 kernel: (old, new) edits of its source
_QK_MMA = ("mma_tf32(small, ql[kk], bh);\n"
           "            mma_tf32(small, qh[kk], bl);\n"
           "            mma_tf32(big, qh[kk], bh);")
_PV_MMA = "mma_3xtf32(pv[j % OSETS][n], ph, pl, bh, bl);"
_P_SPLIT = "for (int e = 0; e < 4; ++e) split_p(pa[e], ph[e], pl[e]);"
F32_PROBES = {
    "1xTF32 (the small terms' mma dropped)": [
        (_QK_MMA, "mma_tf32(big, qh[kk], bh);"),
        (_PV_MMA, "mma_tf32(pv[j % OSETS][n], ph, bh);")],
    "no Q.K^T mma (K's fragments still read)": [
        (_QK_MMA, "small[0] += __uint_as_float((ql[kk][0] ^ qh[kk][1]) & "
                  "(f.x ^ f.z));\n            big[1] += "
                  "__uint_as_float(f.y & f.w);")],
    "no P.V mma (P split, V's fragments still read)": [
        (_PV_MMA, "pv[j % OSETS][n][0] += __uint_as_float((pl[0] ^ ph[1] "
                  "^ ph[2] ^ pl[3]) & f.x & f.z);")],
    "no exponentials": [
        ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = x;")],
    "P split: the high part rounded too (Veltkamp), not truncated": [
        (_P_SPLIT,
         "for (int e = 0; e < 4; ++e) {\n"
         "          const float t1 = pa[e] * 8193.0f;\n"
         "          const float h1 = t1 - (t1 - pa[e]);\n"
         "          const float r1 = pa[e] - h1;\n"
         "          const float t2 = r1 * 8193.0f;\n"
         "          ph[e] = __float_as_uint(h1);\n"
         "          pl[e] = __float_as_uint(t2 - (t2 - r1));\n"
         "        }")],
    "P not split (pl = 0)": [
        (_P_SPLIT, "for (int e = 0; e < 4; ++e) {\n"
                   "          ph[e] = __float_as_uint(pa[e]);\n"
                   "          pl[e] = 0u;\n        }")],
}


def edited(src: str, namespace: str, edits) -> str:
    """``src`` with each (old, new) of ``edits`` replaced once in the part
    of the file from ``namespace``'s opening on (tc: bf16, f32: float32)."""
    head, body = src.split(f"namespace {namespace} {{", 1)
    for old, new in edits:
        if old not in body:
            raise SystemExit(f"flash_attention.cu no longer holds {old!r}")
        body = body.replace(old, new, 1)
    return head + f"namespace {namespace} {{" + body


def sass_opcodes(so: Path, kernel: str) -> None:
    """Opcode counts of the SASS of the first function whose name holds
    ``kernel``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    for body in text.split("Function : ")[1:]:
        if kernel not in body.splitlines()[0]:
            continue
        counts = {}
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)", body):
            counts[op] = counts.get(op, 0) + 1
        top = sorted(counts.items(), key=lambda kv: -kv[1])
        print(f"SASS of {body.splitlines()[0].strip()}: {sum(counts.values())} "
              f"instructions; " + ", ".join(f"{k} {v}" for k, v in top))
        return
    print(f"no SASS function holds {kernel!r}")


def variant_source(src: str, bq: int, nt: int, min_blocks: int) -> str:
    return edited(src, "tc", (
        ("constexpr int BQ = 128;", f"constexpr int BQ = {bq};"),
        ("constexpr int NT = 256;", f"constexpr int NT = {nt};"),
        ("__launch_bounds__(NT, 2)", f"__launch_bounds__(NT, {min_blocks})")))


def f32_variant_source(src: str, warps: int, min_blocks: int,
                       bk: int) -> str:
    return edited(src, "f32", (
        ("constexpr int WARPS = 8;", f"constexpr int WARPS = {warps};"),
        ("constexpr int MIN_BLOCKS = 2;",
         f"constexpr int MIN_BLOCKS = {min_blocks};"),
        ("constexpr int BK_SMALL = 32;", f"constexpr int BK_SMALL = {bk};")))


def ptxas_report(name: str, log: str) -> None:
    """Registers, spills and static shared memory of each entry function."""
    for entry, body in re.findall(
            r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        kernel = re.search(r"(flash_\w+?_kernel)ILi(\d+)E", entry)
        regs = re.search(r"Used (\d+) registers", body)
        stores = re.search(r"(\d+) bytes spill stores", body)
        loads = re.search(r"(\d+) bytes spill loads", body)
        smem = re.search(r"(\d+) bytes smem", body)
        label = f"{kernel[1]}<{kernel[2]}>" if kernel else entry
        print(f"{name} {label}: {regs[1] if regs else '?'} registers, "
              f"spill stores {stores[1] if stores else 0} bytes, spill loads "
              f"{loads[1] if loads else 0} bytes, static shared memory "
              f"{smem[1] if smem else 0} bytes")


def build(out_dir: Path, nvcc_flags, sources: dict, entry: str) -> dict:
    """Build every {name: source text}; {name: bound C entry}."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "src/repro_torch/csrc"
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *nvcc_flags, "-Xptxas", "-v", "-I", str(csrc),
             "-o", str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        ptxas_report(name, log)
        fn = getattr(ctypes.CDLL(str(out_dir / f"{name}.so")), entry)
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32", action="store_true",
                    help="the float32 kernel's variants instead of bf16's")
    ap.add_argument("--f32-probes", action="store_true",
                    help="probes of the float32 kernel and its SASS")
    args = ap.parse_args()
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
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    if args.f32_probes:
        sources = {"f32_committed": src}
        sources.update({f"f32_probe{i}": edited(src, "f32", edits)
                        for i, edits in enumerate(F32_PROBES.values())})
        for i, name in enumerate(F32_PROBES):
            print(f"f32_probe{i}: {name}")
        entry, dtype, tol = "flash_attention_f32", torch.float32, None
        shapes = ((8, 4096, 2, 2, 16, False),)
    elif args.f32:
        sources = {f"f32_warps{w}_minblocks{mb}_bk{bk}":
                   f32_variant_source(src, w, mb, bk)
                   for w, mb, bk in F32_VARIANTS}
        entry, dtype, tol = "flash_attention_f32", torch.float32, 2e-5
        shapes = ((8, 4096, 2, 2, 16, False), (2, 512, 28, 4, 128, True))
    else:
        sources = {f"bq{bq}_minblocks{mb}": variant_source(src, bq, nt, mb)
                   for bq, nt, mb in VARIANTS}
        entry, dtype, tol = "flash_attention_bf16", torch.bfloat16, 3e-2
        shapes = ((2, 512, 28, 4, 128, True),)
    fns = build(_build.BUILD_DIR / "variants", _build.NVCC_FLAGS, sources,
                entry)
    if args.f32_probes:
        sass_opcodes(_build.BUILD_DIR / "variants" / "f32_committed.so",
                     "flash_mma_kernelILi16E")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    for b, s, h, kh, hd, causal in shapes:
        q = torch.randn((b, s, h, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((b, s, kh, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((b, s, kh, hd), generator=g, device=dev).to(dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        want = flash_attention_plain(q, k, v, causal=causal).float()
        out = torch.empty_like(q)
        shape = f"B={b} S={s} H={h} KH={kh} hd={hd} causal={causal}"

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, s, s, h, kh, hd, *q.stride()[:3],
                     *k.stride()[:3], *v.stride()[:3], int(causal), 0, 0,
                     stream)
            if err:
                raise SystemExit(f"launch returned cudaError_t {err}")

        for rnd in range(2):
            for name, fn in fns.items():
                call(fn)
                torch.cuda.synchronize()
                diff = (out.float() - want).abs()
                err = float(diff.max())
                # bf16: the largest difference; float32: the tests'
                # allclose; probes are not checked
                ok = tol is None or (
                    err <= tol if dtype == torch.bfloat16 else
                    bool((diff <= tol + tol * want.abs()).all()))
                if not ok:
                    raise SystemExit(f"{name} differs from plain at {shape}: "
                                     f"{err}")
                print(f"round {rnd} {shape} {name}: "
                      f"{event_us(lambda: call(fn))!r} us per call (CUDA "
                      f"events, back to back); max abs diff {err!r}")
            sdpa = event_us(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=kh != h))
            print(f"round {rnd} {shape} scaled_dot_product_attention: "
                  f"{sdpa!r} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
