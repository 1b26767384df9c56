// Per-channel symbol counts of a (K, C) code matrix -> counts (C, nsym).
//
// Replaces: src/repro/kernels/histogram.py::histogram_pallas (_hist_kernel),
// reached from the static rANS encoder through channel_histogram. The TPU
// kernel compares an (nsym, BR, BC) block against a symbol iota and sums;
// with nsym up to 4096 that is 4096 compares per code. Here each code costs
// one shared-memory atomic.
//
// Bound on the H100: memory bytes (one read of the codes, one write of the
// counts); the atomics are in shared memory.
//
// Design: grid (channel groups, row blocks). A block keeps a private
// histogram of its cpb channels in shared memory (cpb * nsym int32, at
// most 48 KB, so cpb falls from 32 to 3 as nsym grows to 4096), counts its
// rows with shared atomics, then adds its nonzero bins to the global counts
// with global atomics. Neighbouring threads read neighbouring channels of a
// row, so loads coalesce. Values < 0 or >= nsym are counted nowhere (nsym is
// the callers' padding sentinel). Counts are exact integers whatever the
// order of the atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemInts = 48 * 1024 / 4;

template <typename T>
__global__ void hist_kernel(const T* __restrict__ codes, int* __restrict__ counts,
                            int K, int C, int nsym, int cpb,
                            int rows_per_block) {
  extern __shared__ int sh[];
  const int c0 = blockIdx.x * cpb;
  const int nc = min(cpb, C - c0);
  const int k0 = blockIdx.y * rows_per_block;
  const int k1 = min(K, k0 + rows_per_block);
  for (int i = threadIdx.x; i < nc * nsym; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const long long total = (long long)max(k1 - k0, 0) * nc;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    const int k = k0 + (int)(i / nc);
    const int j = (int)(i % nc);
    const int v = (int)codes[(size_t)k * C + c0 + j];
    if (v >= 0 && v < nsym) atomicAdd(&sh[j * nsym + v], 1);
  }
  __syncthreads();
  int* out = counts + (size_t)c0 * nsym;
  for (int i = threadIdx.x; i < nc * nsym; i += blockDim.x) {
    const int v = sh[i];
    if (v) atomicAdd(&out[i], v);
  }
}

template <typename T>
int launch(const void* codes, void* counts, int K, int C, int nsym, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(counts, 0, (size_t)C * nsym * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0 || C <= 0) return 0;
  if (nsym > kSmemInts) return (int)cudaErrorInvalidValue;
  const int cpb = max(1, min(min(C, 32), kSmemInts / nsym));
  const int col_blocks = (C + cpb - 1) / cpb;
  // at least 64 rows a block, and about two blocks per SM in all
  int ksplit = (264 + col_blocks - 1) / col_blocks;
  ksplit = max(1, min(ksplit, (K + 63) / 64));
  const int rpb = (K + ksplit - 1) / ksplit;
  ksplit = (K + rpb - 1) / rpb;
  const dim3 grid(col_blocks, ksplit);
  const size_t smem = (size_t)cpb * nsym * sizeof(int);
  hist_kernel<T><<<grid, kThreads, smem, s>>>((const T*)codes, (int*)counts, K,
                                              C, nsym, cpb, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

// codes (K, C) row-major; counts (C, nsym) int32, zeroed here.
extern "C" int baf_histogram_u8(const void* codes, void* counts, int K, int C,
                                int nsym, int device, void* stream) {
  return launch<uint8_t>(codes, counts, K, C, nsym, device, stream);
}

extern "C" int baf_histogram_u16(const void* codes, void* counts, int K, int C,
                                 int nsym, int device, void* stream) {
  return launch<uint16_t>(codes, counts, K, C, nsym, device, stream);
}

extern "C" int baf_histogram_i32(const void* codes, void* counts, int K, int C,
                                 int nsym, int device, void* stream) {
  return launch<int32_t>(codes, counts, K, C, nsym, device, stream);
}
