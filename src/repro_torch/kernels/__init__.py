"""Hand-written CUDA kernels of the BaF path, each beside its plain version.

  quantize.py     channel gather + fp16 side info + eq. (4) codes
  histogram.py    per-channel symbol counts for the static rANS tables
  consolidate.py  eq. (6) clip to the received bin, in place
  _build.py       nvcc build of ``csrc/*.cu`` and the ctypes binding

A wrapper takes its plain torch version only for CPU tensors; a CUDA
tensor launches the kernel or the call raises.
"""
