// Eq. (6) consolidation, fused with the channel gather and the scatter back.
//
// Replaces: src/repro/kernels/consolidate.py::consolidate_pallas
// (_consolidate_kernel), together with the z_tilde[..., sel_idx] gather and
// scatter_consolidated around it in src/repro/core/split.py::
// restore_codes_fused.
//
// For every example b, position r and transmitted channel j, with
// p = sel[j], m/M the fp16 side info and step = (M - m) / levels:
//   z[b, r, p] = clip(z[b, r, p], m + (c - 0.5) * step, m + (c + 0.5) * step)
// IN PLACE on the full (B, R, P) estimate z: the other P - C channels are
// not touched, so no gathered copy and no scatter pass are needed.
//
// Codes are uint8 (1..8 bits) or uint16 (9..16 bits).
//
// Bound on the H100: memory bytes (read and write 4 bytes of z and read one
// or two code bytes per element; the side info is B * C * 4 bytes). One thread per
// element, channel fastest, so code reads coalesce.
// Rounding: -fmad=false keeps m + (c -+ 0.5) * step as a multiply then an
// add, exactly as the plain torch version and the JAX reference.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename CodeT>
__global__ void consolidate_kernel(float* __restrict__ z,
                                   const CodeT* __restrict__ codes,
                                   const __half* __restrict__ mins,
                                   const __half* __restrict__ maxs,
                                   const int* __restrict__ sel, long long n,
                                   int R, int P, int C, int levels) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int j = (int)(e % C);
  const long long br = e / C;              // b * R + r
  const int b = (int)(br / R);
  const float m = __half2float(mins[b * C + j]);
  const float mx = __half2float(maxs[b * C + j]);
  const float step = __fdiv_rn(__fsub_rn(mx, m), (float)levels);
  const int p = sel ? sel[j] : j;
  if (p < 0 || p >= P) return;   // sel_idx is validated by the callers
  const float c = (float)codes[e];
  const float lo = __fadd_rn(m, __fmul_rn(__fsub_rn(c, 0.5f), step));
  const float hi = __fadd_rn(m, __fmul_rn(__fadd_rn(c, 0.5f), step));
  float* zp = z + br * P + p;
  *zp = fminf(fmaxf(*zp, lo), hi);
}

template <typename CodeT>
int launch(void* z, const void* codes, const void* mins, const void* maxs,
           const void* sel, int B, int R, int P, int C, int levels,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * R * C;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  consolidate_kernel<CodeT><<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (float*)z, (const CodeT*)codes, (const __half*)mins,
      (const __half*)maxs, (const int*)sel, n, R, P, C, levels);
  return (int)cudaGetLastError();
}

}  // namespace

// z (B, R, P) f32, updated in place; codes (B, R, C) uint8 or uint16;
// mins/maxs (B, C) f16; sel (C,) int32 or null (then P == C).
extern "C" int baf_consolidate_f32(void* z, const void* codes, const void* mins,
                                   const void* maxs, const void* sel, int B,
                                   int R, int P, int C, int levels, int device,
                                   void* stream) {
  return launch<uint8_t>(z, codes, mins, maxs, sel, B, R, P, C, levels,
                         device, stream);
}

extern "C" int baf_consolidate_f32_u16(void* z, const void* codes,
                                       const void* mins, const void* maxs,
                                       const void* sel, int B, int R, int P,
                                       int C, int levels, int device,
                                       void* stream) {
  return launch<uint16_t>(z, codes, mins, maxs, sel, B, R, P, C, levels,
                          device, stream);
}
