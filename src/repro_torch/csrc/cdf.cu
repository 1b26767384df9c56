// Exclusive prefix sum of symbol counts along the symbol axis, per channel:
// counts (S, C) int32 -> cdf (S, C) int32, cdf[s, c] = sum_{s' < s} counts.
//
// Replaces: src/repro/kernels/histogram.py::cdf_pallas (_cdf_kernel),
// reached through channel_histogram_cdf. The TPU kernel holds an (S, 8)
// column block in VMEM and takes cumsum - counts. Integer adds are exact in
// any order, so the scan is split across threads freely.
//
// Bound on the H100: bytes (read S * C int32 once, write them once; at 8
// bits and 64 channels 128 KB, ~0.04 us at 3.35 TB/s): launch latency
// dominates at these sizes.
//
// Design: grid over groups of 32 channels, block (32 channels, 32 row
// segments). Each thread sums its segment of rows (neighbouring threads
// read neighbouring channels of a row, so loads coalesce), the 32 segment
// totals of a channel are scanned in shared memory, and each thread then
// writes its segment's exclusive prefix starting from its segment's base.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 32;    // channels per block (threadIdx.x)
constexpr int kSeg = 32;   // row segments per block (threadIdx.y)

__global__ void cdf_kernel(const int* __restrict__ counts,
                           int* __restrict__ cdf, int S, int C) {
  __shared__ int base[kSeg][kCh + 1];
  const int c = blockIdx.x * kCh + threadIdx.x;
  const int seg = (S + kSeg - 1) / kSeg;
  const int r0 = threadIdx.y * seg;
  const int r1 = min(S, r0 + seg);
  int sum = 0;
  if (c < C)
    for (int r = r0; r < r1; ++r) sum += counts[(size_t)r * C + c];
  base[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0) {
    int run = 0;
    for (int y = 0; y < kSeg; ++y) {
      const int t = base[y][threadIdx.x];
      base[y][threadIdx.x] = run;
      run += t;
    }
  }
  __syncthreads();
  if (c >= C) return;
  int run = base[threadIdx.y][threadIdx.x];
  for (int r = r0; r < r1; ++r) {
    const size_t o = (size_t)r * C + c;
    const int v = counts[o];
    cdf[o] = run;
    run += v;
  }
}

}  // namespace

// counts and cdf (S, C) int32, row-major.
extern "C" int baf_cdf_i32(const void* counts, void* cdf, int S, int C,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S <= 0 || C <= 0) return 0;
  const dim3 grid((C + kCh - 1) / kCh);
  cdf_kernel<<<grid, dim3(kCh, kSeg), 0, (cudaStream_t)stream>>>(
      (const int*)counts, (int*)cdf, S, C);
  return (int)cudaGetLastError();
}
