"""Hand-written CUDA kernels of the port, each beside its plain version.

  quantize.py         channel gather + fp16 side info + eq. (4) codes
  histogram.py        per-channel symbol counts, and their exclusive CDF
  consolidate.py      eq. (6) clip to the received bin, in place
  flash_attention.py  online-softmax attention with GQA (LM prefill)
  linear_scan.py      chunked linear attention (RWKV-6 / Mamba-2 scan)
  baf_conv.py         the served restore's 3x3 convs, 3xTF32 implicit GEMM
  _build.py           nvcc build of ``csrc/*.cu`` and the ctypes binding

A wrapper takes its plain torch version only for CPU tensors; a CUDA
tensor launches the kernel or the call raises.
"""
