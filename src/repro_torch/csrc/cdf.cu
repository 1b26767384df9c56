// Exclusive prefix sum of symbol counts along the symbol axis, per channel:
// counts (S, C) int32 -> cdf (S, C) int32, cdf[s, c] = sum_{s' < s} counts.
//
// Replaces: src/repro/kernels/histogram.py::cdf_pallas (_cdf_kernel),
// reached through channel_histogram_cdf. The TPU kernel holds an (S, 8)
// column block in VMEM and takes cumsum - counts. Integer adds are exact in
// any order (and wrap as torch.cumsum's int32 does), so the scan is split
// across lanes and warps freely.
//
// Bound on the H100: bytes (read S * C int32 once, write them once; at 8
// bits and 64 channels 128 KB, ~0.04 us at 3.35 TB/s): launch latency
// dominates at these sizes, so the design keeps the chain after the launch
// short.
//
// Design: a block per channel, spread over the SMs; warp w of the block
// scans symbols [256 w, 256 w + 256), lane l holding the 8 consecutive
// symbols from 256 w + 8 l in registers (one load of the counts: two
// 16-byte loads where the channel's symbols are contiguous and aligned,
// strided 4-byte loads otherwise). Each lane sums its 8, the warp scans the
// 32 lane totals with shuffles, the warps' totals are combined through
// shared memory (S > 256 only), and each lane stores its 8 outputs once.
// Strides are in elements, for the counts and the output alike: the (S, C)
// row-major layout of the TPU kernel, or the (S, C) view of a (C, S)
// buffer as the histogram kernel writes it. The number of warps a channel
// takes is computed in kernels/histogram.py::cdf_plan; the entry below only
// refuses one that does not cover S.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kV = 8;                // symbols a lane holds
constexpr int kSeg = 32 * kV;        // symbols a warp scans
constexpr int kMaxWarps = 32;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void cdf_kernel(const int* __restrict__ counts,
                           int* __restrict__ cdf, int S, long long in_s,
                           long long in_c, long long out_s, long long out_c) {
  __shared__ unsigned s_tot[kMaxWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s0 = warp * kSeg + lane * kV;
  const int* src = counts + blockIdx.x * in_c;
  int* dst = cdf + blockIdx.x * out_c;
  const bool whole = s0 + kV <= S;

  unsigned v[kV];
  if (in_s == 1 && whole && aligned16(src + s0)) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(src + s0));
    const int4 b = __ldg(reinterpret_cast<const int4*>(src + s0) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i)
      v[i] = s0 + i < S ? (unsigned)__ldg(src + (s0 + i) * in_s) : 0u;
  }

  // exclusive within the lane; run = the lane's total
  unsigned run = 0;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const unsigned t = v[i];
    v[i] = run;
    run += t;
  }
  unsigned incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  unsigned base = incl - run;
  if (blockDim.x > 32) {             // the totals of the warps before this
    if (lane == 31) s_tot[warp] = incl;
    __syncthreads();
    unsigned before = lane < warp ? s_tot[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      before += __shfl_xor_sync(0xffffffffu, before, off);
    base += before;
  }

  if (out_s == 1 && whole && aligned16(dst + s0)) {
    int4* d = reinterpret_cast<int4*>(dst + s0);
    int o[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) o[i] = (int)(base + v[i]);
    d[0] = make_int4(o[0], o[1], o[2], o[3]);
    d[1] = make_int4(o[4], o[5], o[6], o[7]);
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (s0 + i < S) dst[(s0 + i) * out_s] = (int)(base + v[i]);
  }
}

}  // namespace

// counts and cdf (S, C) int32 with the given element strides (S, C); warps:
// warps a channel, from repro_torch/kernels/histogram.py::cdf_plan.
extern "C" int baf_cdf_i32(const void* counts, void* cdf, int S, int C,
                           long long in_s, long long in_c, long long out_s,
                           long long out_c, int warps, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (S == 0 || C == 0) return 0;
  if (warps < 1 || warps > kMaxWarps || (long long)warps * kSeg < S)
    return (int)cudaErrorInvalidValue;
  cdf_kernel<<<C, warps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (int*)cdf, S, in_s, in_c, out_s, out_c);
  return (int)cudaGetLastError();
}
