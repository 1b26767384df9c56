// Per-(example, channel) fp16 min/max and eq. (4) codes, fused with the
// channel gather z[..., sel_idx].
//
// Replaces: src/repro/kernels/quantize.py::quantize_pallas (_quantize_kernel).
// The TPU kernel holds one (R, 128) column in VMEM, reduces it and quantizes
// it in one pass. At R = 64*64 that column is 2 MiB; a Hopper block has at
// most 227 KB of shared memory, and one block per (example, channel group)
// would give 2 blocks for one 64-channel request on a 132-SM card.
//
// Bound on the H100: memory bytes. Per element it reads 4 bytes, writes 1
// and does a handful of flops, far below the card's ~20 flops/byte ridge.
// The gather reads whole 32-byte sectors: 64 channels scattered over a
// 256-float row touch most of its 32 sectors.
//
// Design: one launch, no scratch. A thread-block cluster of N blocks owns
// one (example, group of `group` channels) and splits its R rows N ways.
//   1. The group's channels come from a table the caller computes once per
//      selection (kernels/quantize.py::channel_order): the channels sorted
//      by their index in x, so the 8 channels of a group lie close together
//      in a row and one warp's loads (8 channels x 4 rows) touch few
//      sectors. A thread reads its slot's (output column, x column) pair
//      with one 8-byte load. Without sel there is no table: slot k is
//      channel k.
//   2. Each block loads its rows of its channels once into registers
//      (kHold values a thread) and reduces them: shuffles, then shared
//      memory across warps.
//   3. Each block stores its partial min/max into every block of the
//      cluster (distributed shared memory, st.async counted on the
//      receiver's mbarrier: cluster.cuh), waits for the N partials to
//      arrive in its own shared memory, reduces them and derives the same
//      fp16 side info as every other block; rank 0 stores it. No cluster
//      barrier stands between a block's reduction and its codes.
//   4. Each block quantizes the values it holds and writes the codes. A
//      block whose rows do not fit in kHold values a thread re-reads them
//      (mostly from L2) in this pass instead.
// The chain a block waits on: the table, then x (one round of loads), the
// block's reduction, the other blocks' partials, the codes.
// Side info (exactly repro/core/quant.py::compute_quant_params): the min
// rounds to fp16 and saturates at -65504; the max rounds to fp16, widens by
// one ulp on the bit pattern and is capped at 65504. The min ranks -0.0
// below +0.0 and the max +0.0 above -0.0, as jnp.min/jnp.max do (the bit
// patterns of two equal operands are OR-ed for the min, AND-ed for the
// max), and both propagate NaN: an (example, channel) holding a NaN gets
// NaN side info and zero codes.
// Codes: clip(rint((x - m) / max(M - m, 1e-12) * levels), 0, levels), with
// -fmad=false and IEEE __fdiv_rn/__fsub_rn/__fmul_rn, rintf half-to-even,
// so they are bit-identical to the plain torch version and to the JAX
// reference. uint8 for 1..8 bits, uint16 for 9..16, as core/quant.py.
#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHold = 16;          // values a thread keeps in registers
constexpr int kMaxGroup = 8;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;

// NaN-propagating min and max with jnp's order of the zeros.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a || b != b) return a + b;
  if (a == b) return __int_as_float(__float_as_int(a) | __float_as_int(b));
  return a < b ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a || b != b) return a + b;
  if (a == b) return __int_as_float(__float_as_int(a) & __float_as_int(b));
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned short f16_next_up(unsigned short h) {
  if ((h & 0x7FFF) == 0) return 0x0001;   // +-0 -> smallest subnormal
  if (h == 0x7C00) return h;              // +inf stays
  if ((h & 0x7FFF) > 0x7C00) return h;    // NaN stays
  return (h & 0x8000) ? h - 1 : h + 1;    // towards +inf
}

template <typename CodeT>
__device__ __forceinline__ CodeT code_of(float v, float m, float rng, float lv) {
  const float s = __fmul_rn(__fdiv_rn(__fsub_rn(v, m), rng), lv);
  return (CodeT)fminf(fmaxf(rintf(s), 0.0f), lv);
}

// kHeld: every block's rows fit in kHold values a thread (one read of x).
template <typename CodeT, bool kHeld>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const int2* __restrict__ chans,
                CodeT* __restrict__ codes, __half* __restrict__ mins,
                __half* __restrict__ maxs, int R, int P, int C, int levels,
                int group_log2, int rows_per_block) {
  __shared__ float s_wmn[kWarps][kMaxGroup], s_wmx[kWarps][kMaxGroup];
  __shared__ float s_mn[kMaxGroup], s_mx[kMaxGroup];
  // every block's partial min (slots 0..group) and max (group..2 group),
  // stored here by that block; s_bar counts their bytes
  __shared__ float s_all[kMaxCluster][2 * kMaxGroup];
  __shared__ uint64_t s_bar;
  __shared__ float s_m[kMaxGroup], s_rng[kMaxGroup];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nblk = (int)cluster.num_blocks();
  const int group = 1 << group_log2;
  if (threadIdx.x == 0) dsm::expect_bytes(&s_bar, nblk * 2 * group * 4);
  dsm::arrive_relaxed();
  const int b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // 1. lanes over the group's slots, then rows; slot k of the table is
  // output column c, read from column p of x (thread t < group holds slot t)
  const int slot = t & (group - 1);
  const int entry = blockIdx.y * group + slot;
  int c = -1, p = -1;
  if (entry < C) {
    const int2 e = chans ? chans[entry] : make_int2(entry, entry);
    // a table entry out of range is skipped: it reads no x and writes no
    // codes or side info
    if ((unsigned)e.x < (unsigned)C && (unsigned)e.y < (unsigned)P) {
      c = e.x;
      p = e.y;
    }
  }
  const int row_off = t >> group_log2;
  const int step = kThreads >> group_log2;
  const float* xb = x + (size_t)b * R * P + (p < 0 ? 0 : p);
  const int r0 = rank * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);

  // 2. this block's rows: load, reduce
  float mn = INFINITY, mx = -INFINITY;
  float v[kHeld ? kHold : 1];
  if constexpr (kHeld) {
#pragma unroll
    for (int i = 0; i < kHold; ++i) {
      const int r = r0 + row_off + i * step;
      v[i] = (p >= 0 && r < r1) ? xb[(size_t)r * P] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kHold; ++i)
      if (p >= 0 && r0 + row_off + i * step < r1) {
        mn = nan_min(mn, v[i]);
        mx = nan_max(mx, v[i]);
      }
  } else if (p >= 0) {
    for (int r = r0 + row_off; r < r1; r += step) {
      const float w = xb[(size_t)r * P];
      mn = nan_min(mn, w);
      mx = nan_max(mx, w);
    }
  }
  for (int off = group; off < 32; off <<= 1) {
    mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if (lane < group) {
    s_wmn[warp][lane] = mn;
    s_wmx[warp][lane] = mx;
  }
  __syncthreads();
  if (t < group) {
    float a = s_wmn[0][t], z = s_wmx[0][t];
    for (int w = 1; w < kWarps; ++w) {
      a = nan_min(a, s_wmn[w][t]);
      z = nan_max(z, s_wmx[w][t]);
    }
    s_mn[t] = a;
    s_mx[t] = z;
  }
  __syncthreads();

  // 3. this block's partials into every block of the cluster (each has
  // started: the cluster barrier), then the cluster's min/max of each slot
  // from this block's own shared memory -> fp16 side info, the same in
  // every block
  dsm::wait();
  for (int i = t; i < nblk * 2 * group; i += kThreads) {
    const int dst = i >> (group_log2 + 1), k = i & (2 * group - 1);
    const float val = k < group ? s_mn[k] : s_mx[k - group];
    dsm::st_async(dsm::remote(dsm::smem(&s_all[rank][k]), dst),
                  __float_as_uint(val), dsm::remote(dsm::smem(&s_bar), dst));
  }
  if (t < group) {
    dsm::wait_bytes(&s_bar);
    float a = INFINITY, z = -INFINITY;
    for (int s = 0; s < nblk; ++s) {
      a = nan_min(a, s_all[s][t]);
      z = nan_max(z, s_all[s][group + t]);
    }
    __half hmn = __float2half_rn(a);
    if (__half2float(hmn) < -65504.0f) hmn = __float2half_rn(-65504.0f);
    __half hmx = __ushort_as_half(f16_next_up(__half_as_ushort(__float2half_rn(z))));
    if (__half2float(hmx) > 65504.0f) hmx = __float2half_rn(65504.0f);
    const float m = __half2float(hmn);
    s_m[t] = m;
    s_rng[t] = fmaxf(__fsub_rn(__half2float(hmx), m), 1e-12f);
    if (rank == 0 && c >= 0) {
      mins[(size_t)b * C + c] = hmn;
      maxs[(size_t)b * C + c] = hmx;
    }
  }
  __syncthreads();

  // 4. codes of the values this block holds (or re-reads)
  if (p >= 0) {
    const float m = s_m[slot], rng = s_rng[slot], lv = (float)levels;
    CodeT* cb = codes + (size_t)b * R * C + c;
    if constexpr (kHeld) {
#pragma unroll
      for (int i = 0; i < kHold; ++i) {
        const int r = r0 + row_off + i * step;
        if (r < r1) cb[(size_t)r * C] = code_of<CodeT>(v[i], m, rng, lv);
      }
    } else {
      for (int r = r0 + row_off; r < r1; r += step)
        cb[(size_t)r * C] = code_of<CodeT>(xb[(size_t)r * P], m, rng, lv);
    }
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

template <typename CodeT, bool kHeld>
int launch_held(const float* x, const int2* chans, CodeT* codes, __half* mins,
                __half* maxs, int B, int R, int P, int C, int levels,
                int group_log2, int cluster, int rows_per_block, int device,
                cudaStream_t s) {
  auto kern = quantize_kernel<CodeT, kHeld>;
  const int groups = (C + (1 << group_log2) - 1) >> group_log2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, groups, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static bool ready[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  return (int)cudaLaunchKernelEx(&cfg, kern, x, chans, codes, mins, maxs, R, P,
                                 C, levels, group_log2, rows_per_block);
}

template <typename CodeT>
int launch(const void* x, const void* chans, void* codes, void* mins,
           void* maxs, int B, int R, int P, int C, int levels, int group,
           int cluster, int rows_per_block, int held, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int group_log2 = log2_exact(group);
  if (B <= 0 || R <= 0 || C <= 0 || P <= 0 || group_log2 < 0 ||
      group > kMaxGroup || cluster < 1 || cluster > kMaxCluster ||
      (long long)rows_per_block * cluster < R ||
      (held && (long long)rows_per_block * group > (long long)kHold * kThreads))
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const int2* ch = (const int2*)chans;
  cudaStream_t s = (cudaStream_t)stream;
  if (held)
    return launch_held<CodeT, true>(xf, ch, (CodeT*)codes, (__half*)mins,
                                    (__half*)maxs, B, R, P, C, levels,
                                    group_log2, cluster, rows_per_block,
                                    device, s);
  return launch_held<CodeT, false>(xf, ch, (CodeT*)codes, (__half*)mins,
                                   (__half*)maxs, B, R, P, C, levels,
                                   group_log2, cluster, rows_per_block, device,
                                   s);
}

}  // namespace

// x (B, R, P) f32; chans (C, 2) int32 (output column, x column) in the
// order the kernel takes them (repro_torch/kernels/quantize.py::
// channel_order), or null to take channel k of x as output column k (then
// P == C); an entry whose output column is not in [0, C) or whose column
// of x is not in [0, P) is skipped, and its output column is not written;
// codes (B, R, C) uint8 (1..8 bits) or uint16 (9..16 bits);
// mins/maxs (B, C) f16. The plan (group, cluster, rows_per_block, held)
// comes from repro_torch/kernels/quantize.py::quantize_plan.
extern "C" int baf_quantize_f32(const void* x, const void* chans, void* codes,
                                void* mins, void* maxs, int B, int R, int P,
                                int C, int levels, int group, int cluster,
                                int rows_per_block, int held, int device,
                                void* stream) {
  return launch<uint8_t>(x, chans, codes, mins, maxs, B, R, P, C, levels, group,
                         cluster, rows_per_block, held, device, stream);
}

extern "C" int baf_quantize_f32_u16(const void* x, const void* chans,
                                    void* codes, void* mins, void* maxs, int B,
                                    int R, int P, int C, int levels, int group,
                                    int cluster, int rows_per_block, int held,
                                    int device, void* stream) {
  return launch<uint16_t>(x, chans, codes, mins, maxs, B, R, P, C, levels, group,
                          cluster, rows_per_block, held, device, stream);
}
