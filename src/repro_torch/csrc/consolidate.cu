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
// Bound on the H100: memory bytes. The useful bytes are 4 read and 4
// written per selected element, the codes and the side info; but every
// 32-byte sector of z that holds a selected channel is read and written
// whole (at 64 random channels of 256, ~29 of a row's 32 sectors: 58.7 MB
// at B=8). Measured, the time follows those sectors at about the HBM rate
// (PERF.md), from which we infer (no L2 counter was read) that the 33.5 MB
// estimate at B=8 does not stay in L2 from one call to the next; if so,
// that is the floor of any kernel on this layout.
//
// Design: a block per (example, tile of rows); no divide per element.
// Each thread keeps one channel k of the channel table, in address order
// (the plan's table, kernels/quantize.py::channel_order, sorted by column
// of z), so the lanes of a warp touch ascending columns of one row. It
// loads its entry (output column j, column p), then at once m and M of
// (b, j) and the z values and codes of kRows rows of the tile (32-bit
// offsets from the tile's base), divides step, clips and stores. A whole
// row read as float4 by a warp measured slower (PERF.md).
// Nothing waits on another thread: a channel table in shared memory,
// built behind a barrier, put the table's loads and the divide in front
// of every z load and measured slower than the thread-per-element kernel
// it replaced (PERF.md).
// The launch plan (rows a block, threads across a row's channels) is
// computed in kernels/consolidate.py::consolidate_plan; the entry below
// only refuses a plan that does not fit the shapes.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;             // rows a thread loads before it stores

// torch.maximum / torch.minimum on the card: NaN in, NaN out.
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
consolidate_kernel(float* __restrict__ z, const CodeT* __restrict__ codes,
                   const __half* __restrict__ mins,
                   const __half* __restrict__ maxs,
                   const int2* __restrict__ order, int R, int P, int C,
                   int levels, int rows_per_block, int row_threads) {
  const int row_step = kThreads / row_threads;
  const int row_lane = threadIdx.x / row_threads;
  if (row_lane >= row_step) return;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, R - r0);
  const size_t tile = (size_t)b * R + r0;
  float* zt = z + tile * P;
  const CodeT* ct = codes + tile * C;
  for (int k = threadIdx.x % row_threads; k < C; k += row_threads) {
    int p = k, j = k;
    if (order) {
      const int2 e = __ldg(order + k);
      j = e.x;
      p = e.y;
    }
    // a table entry out of range is skipped: its rows are not touched
    if ((unsigned)j >= (unsigned)C || (unsigned)p >= (unsigned)P) continue;
    const float m = __half2float(mins[(size_t)b * C + j]);
    const float mx = __half2float(maxs[(size_t)b * C + j]);
    for (int r = row_lane; r < rows; r += kRows * row_step) {
      float v[kRows], c[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rr = r + i * row_step;
        if (rr < rows) {
          v[i] = zt[rr * P + p];
          c[i] = (float)__ldg(ct + rr * C + j);
        }
      }
      const float step = __fdiv_rn(__fsub_rn(mx, m), (float)levels);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rr = r + i * row_step;
        if (rr < rows) {
          const float lo =
              __fadd_rn(m, __fmul_rn(__fsub_rn(c[i], 0.5f), step));
          const float hi =
              __fadd_rn(m, __fmul_rn(__fadd_rn(c[i], 0.5f), step));
          zt[rr * P + p] = min_nan(max_nan(v[i], lo), hi);
        }
      }
    }
  }
}

template <typename CodeT>
int launch(void* z, const void* codes, const void* mins, const void* maxs,
           const void* order, int B, int R, int P, int C, int levels,
           int rows_per_block, int row_threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || R < 0 || P <= 0 || C <= 0 || C > P || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * R == 0) return 0;
  // the plan must give each block rows and its threads channels, within
  // 32-bit offsets from a tile's base
  if (rows_per_block < 1 || row_threads < 1 || row_threads > kThreads ||
      row_threads > C || (long long)rows_per_block * P > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + rows_per_block - 1) / rows_per_block, B);
  consolidate_kernel<CodeT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)z, (const CodeT*)codes, (const __half*)mins,
      (const __half*)maxs, (const int2*)order, R, P, C, levels,
      rows_per_block, row_threads);
  return (int)cudaGetLastError();
}

}  // namespace

// z (B, R, P) f32, updated in place; codes (B, R, C) uint8 or uint16;
// mins/maxs (B, C) f16; order (C, 2) int32, rows (output column, column of
// z) sorted by column (kernels/quantize.py::channel_order), or null (then
// P == C and channel k is column k). The plan (rows_per_block, row_threads)
// comes from kernels/consolidate.py::consolidate_plan.
#define BAF_CONSOLIDATE(NAME, T)                                              \
  extern "C" int NAME(void* z, const void* codes, const void* mins,           \
                      const void* maxs, const void* order, int B, int R,      \
                      int P, int C, int levels, int rows_per_block,           \
                      int row_threads, int device, void* stream) {            \
    return launch<T>(z, codes, mins, maxs, order, B, R, P, C, levels,         \
                     rows_per_block, row_threads, device, stream);            \
  }
BAF_CONSOLIDATE(baf_consolidate_f32, uint8_t)
BAF_CONSOLIDATE(baf_consolidate_f32_u16, uint16_t)
