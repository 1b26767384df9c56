// Per-channel symbol counts of a (K, C) code matrix -> counts (C, nsym).
//
// Replaces: src/repro/kernels/histogram.py::histogram_pallas (_hist_kernel),
// reached from the static rANS encoder through channel_histogram. The TPU
// kernel compares an (nsym, BR, BC) block against a symbol iota and sums;
// with nsym up to 4096 that is 4096 compares per code. Here each code costs
// one shared-memory atomic at most.
//
// Bound on the H100: memory bytes (one read of the codes, one write of the
// counts). At the path's shape (K=4096, C=64, 8 bits) that is 0.1 us, so
// what a call costs is launches, latency and synchronisation.
//
// Design: one launch and no memset. The grid is (cluster, channel groups);
// a thread-block cluster of N blocks owns one group of `group` channels
// (a power of two up to 4) and splits its K rows N ways.
//   1. Each block zeroes a private histogram of its group in shared memory
//      (group * nsym int32, through the opt-in dynamic shared memory) and
//      counts its rows into it with one shared atomic per code. Measured on
//      the H100, this beat aggregating equal codes of a warp first
//      (__match_any_sync) and per-warp sub-histograms on uniform codes, on
//      the path's own codes and on one symbol everywhere (PERF.md).
//   2. Block r sums bins [r * share, (r + 1) * share) of the group: every
//      block stores those bins of its histogram into block r's shared
//      memory with 16-byte st.async, counted on block r's mbarrier
//      (cluster.cuh), and block r adds the N copies and stores the counts
//      with plain 16-byte stores: every count is written exactly once. No
//      block reads another's shared memory, so none waits for the others
//      before it exits. The receive buffer doubles the shared memory, so
//      nsym = 4096 takes groups of 4 channels (128 KB a block).
// The launch plan (group, cluster, rows a block, the unit and share of the
// bins a block sums, shared bytes) is computed in one place,
// repro_torch/kernels/histogram.py::histogram_plan; the entry below only
// refuses a plan that would not cover K and the bins, or that asks for
// more shared memory than the plan's bins need or a block may have.
// Loads: where C is a multiple of the group and the base is aligned, a row
// of the group is read with 4-, 8- or 16-byte vector loads (one 4-byte load
// per row for 4 u8 channels); otherwise one code per thread, lanes over
// channels.
// No divide per code. Values < 0 or >= nsym are counted nowhere (nsym is
// the callers' padding sentinel). Counts are exact whatever the order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 4;         // histogram.py MAX_GROUP
constexpr int kMaxCluster = 16;
constexpr int kSmemMax = 231424;     // dynamic shared memory a block may opt
                                     // into: 227 KB less 1 KB of static
constexpr int kMaxDevices = 64;

template <int VB> struct Vec;
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<16> { using T = uint4; };

__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }
__device__ __forceinline__ uint32_t word(uint2 v, int i) { return i ? v.y : v.x; }
__device__ __forceinline__ uint32_t word(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Element e of a little-endian vector of codes of type T, as unsigned (a
// negative int32 becomes large and fails the < nsym test).
template <typename T, typename V>
__device__ __forceinline__ uint32_t element(V v, int e) {
  constexpr int per_word = 4 / sizeof(T);
  const uint32_t w = word(v, e / per_word);
  if constexpr (sizeof(T) == 4) {
    return w;
  } else {
    constexpr uint32_t mask = (1u << (8 * sizeof(T))) - 1;
    return (w >> (8 * sizeof(T) * (e % per_word))) & mask;
  }
}

// VB = 0: one code per thread; VB = 4, 8, 16: vector loads of VB bytes.
// Shared memory: the group's histogram, then the bins this block sums, as
// every block of the cluster stores them (nblk x share units of
// 1 << unit_log2 ints).
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const T* __restrict__ codes, int* __restrict__ counts, int K, int C,
            int nsym, int group_log2, int vec_log2, int rows_per_block,
            int unit_log2, int share) {
  extern __shared__ int4 smem4[];
  int* sh = reinterpret_cast<int*>(smem4);
  __shared__ uint64_t s_bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nblk = (int)cluster.num_blocks();
  const int group = 1 << group_log2;
  const int c0 = blockIdx.y * group;
  const int nc = min(group, C - c0);
  const int stride = group * nsym;           // ints of the histogram
  const int nunits = (nc * nsym) >> unit_log2;
  const int mine = max(0, min(share, nunits - rank * share));
  if (threadIdx.x == 0)
    dsm::expect_bytes(&s_bar, (uint32_t)(nblk * mine) << (unit_log2 + 2));
  dsm::arrive_relaxed();

  for (int i = threadIdx.x; i < (stride >> 2); i += kThreads)
    smem4[i] = make_int4(0, 0, 0, 0);
  for (int i = (stride & ~3) + threadIdx.x; i < stride; i += kThreads) sh[i] = 0;
  __syncthreads();

  const int k0 = rank * rows_per_block;
  const int k1 = min(K, k0 + rows_per_block);
  if constexpr (VB > 0) {
    // vectors of a row: 1 << vec_log2; lanes over (row, vector)
    using V = typename Vec<VB>::T;
    constexpr int E = VB / sizeof(T);
    const int v = threadIdx.x & ((1 << vec_log2) - 1);
    const int row_off = threadIdx.x >> vec_log2;
    const int step = kThreads >> vec_log2;
    for (int base = k0; base < k1; base += step) {
      const int r = base + row_off;
      const bool ok = r < k1;
      V w{};
      if (ok) w = reinterpret_cast<const V*>(codes + (size_t)r * C + c0)[v];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint32_t code = element<T>(w, e);
        if (ok && code < (uint32_t)nsym) atomicAdd(&sh[(v * E + e) * nsym + code], 1);
      }
    }
  } else {
    // lanes over the group's channels, then rows
    const int j = threadIdx.x & (group - 1);
    const int row_off = threadIdx.x >> group_log2;
    const int step = kThreads >> group_log2;
    for (int base = k0; base < k1; base += step) {
      const int r = base + row_off;
      if (r < k1 && j < nc) {
        const uint32_t code = (uint32_t)(int)codes[(size_t)r * C + c0 + j];
        if (code < (uint32_t)nsym) atomicAdd(&sh[j * nsym + code], 1);
      }
    }
  }
  __syncthreads();

  // 2. each bin to the block that sums it (every block has started: the
  // cluster barrier), then this block's share summed over the cluster
  dsm::wait();
  int* recv = sh + stride;
  const uint32_t bar = dsm::smem(&s_bar);
  for (int u = threadIdx.x; u < nunits; u += kThreads) {
    const int o = u / share;
    const uint32_t to =
        dsm::remote(dsm::smem(recv + ((rank * share + u - o * share) << unit_log2)), o);
    if (unit_log2)
      dsm::st_async(to, smem4[u], dsm::remote(bar, o));
    else
      dsm::st_async(to, (uint32_t)sh[u], dsm::remote(bar, o));
  }
  dsm::wait_bytes(&s_bar);
  int* out = counts + (size_t)c0 * nsym + ((rank * share) << unit_log2);
  if (unit_log2) {
    const int4* r4 = reinterpret_cast<const int4*>(recv);
    for (int u = threadIdx.x; u < mine; u += kThreads) {
      int4 acc = r4[u];
      for (int s = 1; s < nblk; ++s) {
        const int4 v = r4[s * share + u];
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      reinterpret_cast<int4*>(out)[u] = acc;
    }
  } else {
    for (int u = threadIdx.x; u < mine; u += kThreads) {
      int acc = recv[u];
      for (int s = 1; s < nblk; ++s) acc += recv[s * share + u];
      out[u] = acc;
    }
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

template <typename T, int VB>
int launch_vec(const T* codes, int* counts, int K, int C, int nsym,
               int group_log2, int cluster, int groups, int rows_per_block,
               int unit_log2, int share, int smem_bytes, int device,
               cudaStream_t s) {
  auto kern = hist_kernel<T, VB>;
  static bool ready[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  const int vec_log2 =
      VB ? group_log2 + log2_exact((int)sizeof(T)) - log2_exact(VB) : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, groups, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, codes, counts, K, C, nsym,
                                 group_log2, vec_log2, rows_per_block,
                                 unit_log2, share);
}

template <typename T>
int launch(const void* codes, void* counts, int K, int C, int nsym, int group,
           int cluster, int rows_per_block, int unit, int share,
           int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int group_log2 = log2_exact(group);
  const int unit_log2 = unit == 4 ? 2 : unit == 1 ? 0 : -1;
  // the plan must cover the K rows and the group's bins, and give a block
  // the shared memory its histogram and the bins it sums take
  const long long bins = (long long)group * nsym;
  if (K < 0 || C <= 0 || nsym <= 0 || group_log2 < 0 || group > kMaxGroup ||
      cluster < 1 || cluster > kMaxCluster || rows_per_block < 0 ||
      (long long)rows_per_block * cluster < K || unit_log2 < 0 ||
      nsym % unit != 0 || share < 0 || (long long)share * cluster * unit < bins ||
      (long long)smem_bytes < 4 * (bins + (long long)cluster * share * unit) ||
      smem_bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int groups = (C + group - 1) / group;
  cudaStream_t s = (cudaStream_t)stream;
  const T* p = (const T*)codes;
  int* out = (int*)counts;
  // bytes of one row of the group; vector loads when every group is whole
  // and every row of it starts on a multiple of the vector
  const int seg = group * (int)sizeof(T);
  const int vb = seg >= 16 ? 16 : seg;
  if (C % group == 0 && vb >= 4 && (uintptr_t)codes % vb == 0) {
    if (vb == 16)
      return launch_vec<T, 16>(p, out, K, C, nsym, group_log2, cluster, groups,
                               rows_per_block, unit_log2, share, smem_bytes,
                               device, s);
    if (vb == 8)
      return launch_vec<T, 8>(p, out, K, C, nsym, group_log2, cluster, groups,
                              rows_per_block, unit_log2, share, smem_bytes,
                              device, s);
    return launch_vec<T, 4>(p, out, K, C, nsym, group_log2, cluster, groups,
                            rows_per_block, unit_log2, share, smem_bytes,
                            device, s);
  }
  return launch_vec<T, 0>(p, out, K, C, nsym, group_log2, cluster, groups,
                          rows_per_block, unit_log2, share, smem_bytes, device,
                          s);
}

}  // namespace

// codes (K, C) row-major; counts (C, nsym) int32, every count written here.
// The plan (group, cluster, rows_per_block, unit, share, smem_bytes) comes
// from repro_torch/kernels/histogram.py::histogram_plan.
#define BAF_HISTOGRAM(NAME, T)                                                \
  extern "C" int NAME(const void* codes, void* counts, int K, int C, int nsym, \
                      int group, int cluster, int rows_per_block, int unit,   \
                      int share, int smem_bytes, int device, void* stream) {  \
    return launch<T>(codes, counts, K, C, nsym, group, cluster,               \
                     rows_per_block, unit, share, smem_bytes, device, stream); \
  }
BAF_HISTOGRAM(baf_histogram_u8, uint8_t)
BAF_HISTOGRAM(baf_histogram_u16, uint16_t)
BAF_HISTOGRAM(baf_histogram_i32, int32_t)
