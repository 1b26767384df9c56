#!/usr/bin/env python3
"""Time the linear-scan kernel's two passes each alone, and print what
ptxas says of them, for one checkout.

    python3 tools/scan_passes.py [--src ROOT] [--iters N] [--phases]

Needs one CUDA device and nvcc. Builds ROOT's ``csrc/linear_scan.cu``
into ``build/scan_passes/`` of this checkout, with the flags of
``repro_torch.kernels._build`` plus ``-Xptxas -v``, inside a harness that
adds one C entry launching pass A (every chunk's own terms) or pass B
(the carry through the chunks) alone. It prints each kernel's registers,
spills and shared memory as ptxas reports them, each pass's shared
memory at the shapes below and the blocks an SM that registers and
shared memory allow, and then, with CUDA events around ``--iters``
back-to-back launches of one pass (after a warm call of both), the time
of pass A, of pass B and of the wrapper's whole call at zamba2-1.2b's
scan shapes (bf16 q, k, v, chunk 128, ssm, dk = dv = 64, 64 heads):

  - the prefill (2, 512), a (B, S, H, 1) decay;
  - the ingest block (2, 4096) with an initial state;
  - the training forward (2, 1024), which is also the compressed step's;
  - the prefill with a per-channel (B, S, H, dk) decay, where ROOT's
    kernel takes it.

``--phases`` also times pass A built with ``-DSCAN_STOP_AT=n``, which
makes it return at the source's ``SCAN_STOP(n)`` (``PHASES``: after the
loads and the cumsum, after qd, kd and k_rem, after v), ROOT's
tensor-core pass A only; their outputs are wrong, they split the time.

Two checkouts are compared on one card by running this script in turns,
e.g. with the parent unpacked under ``build/parent``::

    python3 tools/scan_passes.py --src build/parent
    python3 tools/scan_passes.py
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (the helpers; imports no torch yet)

B, H, DK, DV, L = 2, 64, 64, 64, 128
SHAPES = (("zamba2 prefill", 512, False, False),
          ("zamba2 ingest block", 4096, True, False),
          ("zamba2 training forward (and compressed step)", 1024, False,
           False),
          ("zamba2 prefill, per-channel decay", 512, False, True))

# Pass launchers for a source that has none of its own (the kernel as it
# stood before ``launch_pass_a`` / ``launch_pass_b``): the launch code of
# its ``launch_passes``, one pass at a time, at zamba2's compiled dims.
PARENT_LAUNCHERS = r"""
template <typename T>
int launch_pass_a(const void* q, const void* k, const void* v,
                  const void* ld, const void* u, void* scratch,
                  const Dims& dm, cudaStream_t st) {
  const size_t smem =
      (size_t)smem_floats_a(dm.L, dm.DK, dm.DV, dm.ld_per_channel) * 4;
  auto* pass_a = chunk_kernel<T, 128, 64, 64>;
  cudaError_t err = cudaFuncSetAttribute(
      pass_a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pass_a<<<dim3(dm.NC, dm.B * dm.H), NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)ld,
      (const float*)u, (float*)scratch, dm);
  return (int)cudaGetLastError();
}
int launch_pass_b(const void* s0, const void* scratch, void* y, void* sf,
                  const Dims& dm, cudaStream_t st) {
  const size_t smem = (size_t)smem_floats_b(dm.L, dm.DK) * 4;
  auto* pass_b = carry_kernel<128, 64>;
  cudaError_t err = cudaFuncSetAttribute(
      pass_b, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pass_b<<<dim3(dm.B * dm.H, (dm.DV + JS - 1) / JS), NTB, smem, st>>>(
      (const float*)s0, (const float*)scratch, (float*)y, (float*)sf, dm);
  return (int)cudaGetLastError();
}
int smem_bytes_a(const Dims& dm) {
  return smem_floats_a(dm.L, dm.DK, dm.DV, dm.ld_per_channel) * 4;
}
int smem_bytes_b(const Dims& dm) { return smem_floats_b(dm.L, dm.DK) * 4; }
"""

HARNESS = r"""
#include "{source}"
namespace {{
{launchers}
}}  // namespace

// which: 0 pass A, 1 pass B, 2 pass A's shared bytes, 3 pass B's
extern "C" int scan_pass(int which, int bf16, const void* q, const void* k,
                         const void* v, const void* ld, const void* u,
                         const void* s0, void* y, void* sf, void* scratch,
                         int B, int S, int H, int DK, int DV, int L, int rwkv,
                         int ld_per_channel, void* stream) {{
  const Dims dm{{B, S, H, DK, DV, L, S / L, rwkv, u != nullptr && rwkv,
                ld_per_channel}};
  cudaStream_t st = (cudaStream_t)stream;
  if (which == 2) return smem_bytes_a(dm);
  if (which == 3) return smem_bytes_b(dm);
  if (which == 1) return launch_pass_b(s0, scratch, y, sf, dm, st);
  return bf16 ? launch_pass_a<__nv_bfloat16>(q, k, v, ld, u, scratch, dm, st)
              : launch_pass_a<float>(q, k, v, ld, u, scratch, dm, st);
}}
"""


# --phases: pass A of the tensor-core kernel stopped at SCAN_STOP(1), (2)
# and (3) (its outputs are then wrong; the probes only split its time)
PHASES = ("loads of q, k and the decay, the bonus, the cumsum",
          "+ qd, kd, k_rem", "+ v and the chunk's flags")


def build(src_root: Path, stop: int | None = None,
          quiet: bool = False) -> ctypes.CDLL:
    """Compile the harness around ``src_root``'s scan source (with
    ``-DSCAN_STOP_AT=stop`` where given); print ptxas's report of each
    kernel unless ``quiet``."""
    from repro_torch.kernels import _build
    source = src_root / "src" / "repro_torch" / "csrc" / "linear_scan.cu"
    text = source.read_text()
    launchers = "" if "launch_pass_a" in text else PARENT_LAUNCHERS
    if stop is not None and "SCAN_STOP(" not in text:
        raise RuntimeError(f"{source} has no SCAN_STOP marks")
    out = ROOT / "build" / "scan_passes"
    out.mkdir(parents=True, exist_ok=True)
    tag = ("parent" if launchers else "own") + \
        ("" if stop is None else f"_stop{stop}")
    cu = out / f"harness_{tag}.cu"
    cu.write_text(HARNESS.format(source=source, launchers=launchers))
    inc = src_root / "src" / "repro_torch" / "csrc"
    lib = out / f"libscan_passes_{tag}.so"
    defs = [] if stop is None else [f"-DSCAN_STOP_AT={stop}"]
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-Xptxas", "-v", "-I",
         str(inc), "-o", str(lib), str(cu)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    report = proc.stdout + proc.stderr
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if Path(filt).exists():
        names = sorted(set(re.findall(r"_Z\w+", report)))
        if names:
            dem = subprocess.run([filt], input="\n".join(names),
                                 capture_output=True, text=True).stdout
            for m, d in zip(names, dem.splitlines()):
                report = report.replace(m, d.strip())
    for line in report.splitlines():
        if line.strip() and not quiet and "Compile time" not in line:
            print(f"ptxas: {line.strip()}")
    so = ctypes.CDLL(str(lib))
    so.registers = registers(report)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.scan_pass.argtypes = [I, I] + [P] * 9 + [I] * 8 + [P]
    so.scan_pass.restype = I
    return so


def registers(report: str) -> dict:
    """{kernel (demangled): registers a thread} from ptxas's report."""
    regs, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(.+)' for", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    return regs


def blocks_per_sm(regs: int, threads: int, smem: int) -> int:
    """Blocks an SM holds at once: 64K registers (allocated 256 a warp at a
    time), 228 KB of shared memory (1 KB reserved a block), 2048 threads,
    32 blocks."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32)


def pass_regs(so, pattern: str):
    for name, n in so.registers.items():
        if re.search(pattern, name):
            return name, n
    return None, None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="root of the checkout whose scan kernel is timed")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--phases", action="store_true",
                    help="also time pass A stopped at each SCAN_STOP mark")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("scan_passes: no CUDA device", file=sys.stderr)
        return 1
    src = args.src.resolve()
    sys.path.insert(0, str(src / "src"))
    from repro_torch.kernels.linear_scan import (_scratch_floats,
                                                 linear_scan)
    print(f"device: {cs.nvidia_smi_line()}; scan kernel of {src}")
    so = build(src)
    probes = {}
    if args.phases:
        for i, what in enumerate(PHASES):
            probes[what] = build(src, stop=i + 1, quiet=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    seen = set()
    for label, s_, init, per_ch in SHAPES:
        qs, ks = ((torch.randn((B, s_, 1, DK), generator=g, device=dev)
                   * 0.5).expand(B, s_, H, DK).to(torch.bfloat16)
                  .contiguous() for _ in range(2))
        vs = torch.randn((B, s_, H, DV), generator=g, device=dev) \
            .to(torch.bfloat16)
        ld = -F.softplus(torch.randn((B, s_, H, DK if per_ch else 1),
                                     generator=g, device=dev) - 2.0) * 0.6931
        s0 = torch.randn((B, H, DK, DV), generator=g, device=dev) \
            if init else None
        y = torch.empty((B, s_, H, DV), device=dev)
        sf = torch.empty((B, H, DK, DV), device=dev)
        scratch = torch.empty(_scratch_floats(B, H, s_ // L, L, DK, DV),
                              device=dev)
        ptrs = [t.data_ptr() if t is not None else None
                for t in (qs, ks, vs, ld, None, s0, y, sf, scratch)]

        def call(which):
            return so.scan_pass(which, 1, *ptrs, B, s_, H, DK, DV, L, 0,
                                int(per_ch), stream)
        smem_a, smem_b = call(2), call(3)
        for tag, pattern, threads, smem in (
                ("A", r"chunk_kernel\w*<__nv_bfloat16, (\(int\))?128, "
                      r"(\(int\))?64, (\(int\))?64>", 256, smem_a),
                ("B", r"carry_kernel<(\(int\))?128, (\(int\))?64>", 128,
                 smem_b)):
            name, n = pass_regs(so, pattern)
            if n is not None and (label, tag) not in seen:
                seen.add((label, tag))
                print(f"scan passes {label}: pass {tag} {name}: {n} "
                      f"registers, {threads} threads, {smem} B of shared "
                      f"memory: {blocks_per_sm(n, threads, smem)} blocks "
                      f"an SM")
        err = call(0) or call(1)
        torch.cuda.synchronize()
        if err:
            print(f"scan passes {label} S={s_}: pass A {smem_a} B of shared "
                  f"memory, pass B {smem_b}: launch returned cudaError_t "
                  f"{err} (not taken by this kernel)")
            continue
        kw = dict(initial_state=s0, chunk=L, mode="ssm")
        ref = linear_scan(qs, ks, vs, ld, **kw)
        torch.cuda.synchronize()
        same = torch.equal(ref[0], y) and torch.equal(ref[1], sf)
        ms_a = cs.event_ms(lambda: call(0), iters=args.iters)
        ms_b = cs.event_ms(lambda: call(1), iters=args.iters)
        ms_call = cs.event_ms(lambda: linear_scan(qs, ks, vs, ld, **kw),
                              iters=args.iters)
        for what, pr in probes.items():
            ms = cs.event_ms(lambda: pr.scan_pass(0, 1, *ptrs, B, s_, H, DK,
                                                  DV, L, 0, int(per_ch),
                                                  stream), iters=args.iters)
            print(f"scan passes {label}: pass A stopped after {what}: "
                  f"{ms * 1e3!r} us")
        print(f"scan passes {label} B={B} S={s_} H={H} dk=dv={DK} chunk "
              f"{L}{', initial state' if init else ''}: pass A "
              f"{ms_a * 1e3!r} us ({smem_a} B of shared memory), pass B "
              f"{ms_b * 1e3!r} us ({smem_b} B), the wrapper's call "
              f"{ms_call * 1e3!r} us; the harness's passes give the call's "
              f"outputs bit for bit: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
