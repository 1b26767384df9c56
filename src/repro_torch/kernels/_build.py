"""Build the CUDA sources under ``repro_torch/csrc`` and bind them with ctypes.

Each kernel is one ``.cu`` file with a plain C entry point (and may include
the ``.cuh`` headers beside it, which are part of every hash). At first use it
is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch/`` at the root of the checkout, named by a hash of the
source and flags so an edited source is never served a stale library. The
library is loaded with ``ctypes``; pointers and the stream travel as
``c_void_p`` and every entry point returns its ``cudaError_t``.

Flags: ``-O3 -fmad=false`` and no ``--use_fast_math``, so divides stay IEEE
round-to-nearest and ``a + b * c`` is not contracted into an FMA; the
kernels then round exactly as their plain torch versions do.

Nothing here runs at import: this module imports on machines with no card
and no ``nvcc``. :func:`build_all` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong


class KernelError(RuntimeError):
    """A kernel failed to build or its launch returned a CUDA error."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fixed = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fixed):
        return fixed
    raise KernelError("nvcc not found on PATH or under /usr/local/cuda/bin; "
                      "the CUDA kernels cannot be built")


class CudaKernel:
    """One source file, one C entry point per element type, one counter.

    ``launches`` counts calls that launched the kernel on the card; the
    wrapper in ``kernels/*.py`` bumps it through :meth:`launch` and nowhere
    else.
    """

    def __init__(self, name: str, source: str, entries: dict[str, list]):
        self.name = name
        self.source = CSRC / source
        self.entries = entries          # C symbol -> argtypes
        self.launches = 0
        self.build_seconds: float | None = None
        self._lib = None
        self._proc = None
        self._out: Path | None = None
        self._tmp: Path | None = None
        self._t0 = 0.0

    def _target(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):     # included by sources
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:12]}.so"

    def start_build(self) -> None:
        """Start nvcc in the background (no-op when built or cached)."""
        if self._lib is not None or self._proc is not None:
            return
        self._out = self._target()
        self._t0 = time.perf_counter()
        if self._out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self._out.with_suffix(f".{os.getpid()}.tmp")
        self._tmp = tmp
        self._proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self) -> None:
        """Wait for nvcc, then load and bind the library."""
        if self._lib is not None:
            return
        self.start_build()
        if self._proc is not None:
            out, _ = self._proc.communicate()
            rc = self._proc.returncode
            self._proc = None
            if rc != 0:
                raise KernelError(f"nvcc failed for {self.source.name} "
                                  f"(exit {rc}):\n{out}")
            os.replace(self._tmp, self._out)
        lib = ctypes.CDLL(str(self._out))
        for sym, argtypes in self.entries.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib = lib
        self.build_seconds = time.perf_counter() - self._t0

    def launch(self, entry: str, *args) -> None:
        """Call ``entry`` (builds on first use); raise on a CUDA error."""
        self.finish_build()
        err = getattr(self._lib, entry)(*args)
        if err != 0:
            raise KernelError(f"{self.name}: {entry} returned cudaError_t "
                              f"{err}")
        self.launches += 1


_QUANTIZE_ARGS = [P, P, P, P, P,      # x, chans (nullable), codes, mins, maxs
                  I, I, I, I, I,      # B, R, P, C, levels
                  I, I, I, I,         # plan: group, cluster, rows, held
                  I, P]               # device, stream
QUANTIZE = CudaKernel("quantize", "quantize.cu", {
    "baf_quantize_f32": _QUANTIZE_ARGS,
    "baf_quantize_f32_u16": _QUANTIZE_ARGS,
})
_HISTOGRAM_ARGS = [P, P, I, I, I,     # codes, counts, K, C, nsym
                   I, I, I, I, I, I,  # plan: group, cluster, rows, unit,
                                      # share, shared bytes
                   I, P]              # device, stream
HISTOGRAM = CudaKernel("histogram", "histogram.cu", {
    "baf_histogram_u8": _HISTOGRAM_ARGS,
    "baf_histogram_u16": _HISTOGRAM_ARGS,
    "baf_histogram_i32": _HISTOGRAM_ARGS,
})
_CONSOLIDATE_ARGS = [P, P, P, P, P,  # z (in place), codes, mins, maxs,
                                     # channel table (nullable)
                     I, I, I, I, I,  # B, R, P, C, levels
                     I, I,           # plan: rows, row threads
                     I, P]           # device, stream
CONSOLIDATE = CudaKernel("consolidate", "consolidate.cu", {
    "baf_consolidate_f32": _CONSOLIDATE_ARGS,
    "baf_consolidate_f32_u16": _CONSOLIDATE_ARGS,
})
CDF = CudaKernel("cdf", "cdf.cu", {
    # counts, cdf, S, C, counts' strides (S, C), cdf's strides (S, C),
    # plan: warps a channel; device, stream
    "baf_cdf_i32": [P, P, I, I, LL, LL, LL, LL, I, I, P],
})
_FLASH_ARGS = [P, P, P, P,            # q, k, v, o
               I, I, I, I, I, I,      # B, Sq, Sk, H, KH, hd
               LL, LL, LL, LL, LL, LL, LL, LL, LL,   # q/k/v strides (B, S, H)
               I, I, I, P]            # causal, window, device, stream
FLASH_ATTENTION = CudaKernel("flash_attention", "flash_attention.cu", {
    "flash_attention_f32": _FLASH_ARGS,
    "flash_attention_bf16": _FLASH_ARGS,
})
_SCAN_ARGS = [P, P, P, P, P, P, P, P,  # q, k, v, ld, u, s0, y, state
              P,                       # scratch from pass A to pass B
              I, I, I, I, I, I,        # B, S, H, dk, dv, chunk
              I, I, I, P]              # rwkv, per-channel decay, device, stream
LINEAR_SCAN = CudaKernel("linear_scan", "linear_scan.cu", {
    "linear_scan_f32": _SCAN_ARGS,
    "linear_scan_bf16": _SCAN_ARGS,
})
BAF_CONV = CudaKernel("baf_conv", "baf_conv.cu", {
    # x, weights (prepared), bias, alpha, BN mean, var, scale, shift, out
    # (each nullable but x, weights, out); B, H, W, Cin, Cout, stride,
    # pad_t, pad_l, transposed; device, stream
    "baf_conv_f32": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                     I, P],
})
KERNELS = (QUANTIZE, HISTOGRAM, CONSOLIDATE, CDF, FLASH_ATTENTION,
           LINEAR_SCAN, BAF_CONV)


def build_all() -> float:
    """Build every kernel, one nvcc per source in parallel; wall seconds."""
    t0 = time.perf_counter()
    for k in KERNELS:
        k.start_build()
    for k in KERNELS:
        k.finish_build()
    return time.perf_counter() - t0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def stream_args(t: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) for a CUDA tensor."""
    dev = t.device.index if t.device.index is not None else 0
    return dev, torch.cuda.current_stream(t.device).cuda_stream
