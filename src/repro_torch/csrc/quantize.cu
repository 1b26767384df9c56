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
//
// Design: three launches on the caller's stream.
//   1. minmax_partial: grid (channel groups of 32, row blocks, examples),
//      block (32 channels, 8 row slots). Each warp reads 32 selected
//      channels of one row; each block reduces its rows through shared
//      memory and writes one partial min/max per channel.
//   2. finalize: grid (channel groups, examples), block (32, 8); reduce the
//      partials through shared memory, round to fp16, saturate the min at
//      -65504, widen the max by one fp16 ulp on the bit pattern and cap it
//      at 65504 (exactly repro/core/quant.py::compute_quant_params).
//   3. quantize_codes: same grid as (1); re-reads the selected channels
//      (mostly from L2) and writes the codes
//      clip(rint((x - m) / max(M - m, 1e-12) * levels), 0, levels).
// Rounding: built with -fmad=false and IEEE __fdiv_rn/__fsub_rn/__fmul_rn,
// rintf is round-half-even, so codes and side info are bit-identical to the
// plain torch version and to the JAX reference.
// NaN: the min/max reductions propagate NaN, as jnp.min/jnp.max and
// torch.amin/amax do (fminf/fmaxf would drop it), so an (example, channel)
// holding a NaN gets NaN fp16 side info, and its codes are 0.
// Codes are uint8 for 1..8 bits and uint16 for 9..16, as core/quant.py.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 32;    // channels per block (threadIdx.x)
constexpr int kRows = 8;   // row slots per block (threadIdx.y)

// NaN-propagating min and max (fminf/fmaxf return the other operand).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// Selected channel of group lane c, or -1 when it lies outside [0, P): the
// callers validate sel_idx on the host; this only keeps a bad index from
// reading outside x.
__device__ __forceinline__ int channel_of(const int* sel, int c, int P) {
  const int p = sel ? sel[c] : c;
  return (p >= 0 && p < P) ? p : -1;
}

__global__ void minmax_partial(const float* __restrict__ x,
                               const int* __restrict__ sel,
                               float* __restrict__ pmin,
                               float* __restrict__ pmax, int R, int P, int C,
                               int rows_per_block) {
  const int c = blockIdx.x * kCh + threadIdx.x;
  const int rb = blockIdx.y, nrb = gridDim.y, b = blockIdx.z;
  const int r0 = rb * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  float mn = INFINITY, mx = -INFINITY;
  const int p = c < C ? channel_of(sel, c, P) : -1;
  if (p >= 0) {
    const float* xb = x + (size_t)b * R * P + p;
    for (int r = r0 + threadIdx.y; r < r1; r += kRows) {
      const float v = xb[(size_t)r * P];
      mn = nan_min(mn, v);
      mx = nan_max(mx, v);
    }
  }
  __shared__ float smn[kRows][kCh + 1];
  __shared__ float smx[kRows][kCh + 1];
  smn[threadIdx.y][threadIdx.x] = mn;
  smx[threadIdx.y][threadIdx.x] = mx;
  __syncthreads();
  for (int s = kRows / 2; s > 0; s >>= 1) {
    if (threadIdx.y < s) {
      smn[threadIdx.y][threadIdx.x] =
          nan_min(smn[threadIdx.y][threadIdx.x], smn[threadIdx.y + s][threadIdx.x]);
      smx[threadIdx.y][threadIdx.x] =
          nan_max(smx[threadIdx.y][threadIdx.x], smx[threadIdx.y + s][threadIdx.x]);
    }
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < C) {
    const size_t o = ((size_t)b * nrb + rb) * C + c;
    pmin[o] = smn[0][threadIdx.x];
    pmax[o] = smx[0][threadIdx.x];
  }
}

__device__ __forceinline__ unsigned short f16_next_up(unsigned short h) {
  if ((h & 0x7FFF) == 0) return 0x0001;   // +-0 -> smallest subnormal
  if (h == 0x7C00) return h;              // +inf stays
  if ((h & 0x7FFF) > 0x7C00) return h;    // NaN stays
  return (h & 0x8000) ? h - 1 : h + 1;    // towards +inf
}

__global__ void finalize(const float* __restrict__ pmin,
                         const float* __restrict__ pmax,
                         __half* __restrict__ mins, __half* __restrict__ maxs,
                         int C, int nrb) {
  const int c = blockIdx.x * kCh + threadIdx.x;
  const int b = blockIdx.y;
  float mn = INFINITY, mx = -INFINITY;
  if (c < C) {
    for (int rb = threadIdx.y; rb < nrb; rb += kRows) {
      const size_t o = ((size_t)b * nrb + rb) * C + c;
      mn = nan_min(mn, pmin[o]);
      mx = nan_max(mx, pmax[o]);
    }
  }
  __shared__ float smn[kRows][kCh + 1];
  __shared__ float smx[kRows][kCh + 1];
  smn[threadIdx.y][threadIdx.x] = mn;
  smx[threadIdx.y][threadIdx.x] = mx;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return;
  for (int y = 1; y < kRows; ++y) {
    mn = nan_min(mn, smn[y][threadIdx.x]);
    mx = nan_max(mx, smx[y][threadIdx.x]);
  }
  __half hmn = __float2half_rn(mn);
  if (__half2float(hmn) < -65504.0f) hmn = __float2half_rn(-65504.0f);
  __half hmx = __ushort_as_half(f16_next_up(__half_as_ushort(__float2half_rn(mx))));
  if (__half2float(hmx) > 65504.0f) hmx = __float2half_rn(65504.0f);
  mins[b * C + c] = hmn;
  maxs[b * C + c] = hmx;
}

template <typename CodeT>
__global__ void quantize_codes(const float* __restrict__ x,
                               const int* __restrict__ sel,
                               const __half* __restrict__ mins,
                               const __half* __restrict__ maxs,
                               CodeT* __restrict__ codes, int R, int P,
                               int C, int levels, int rows_per_block) {
  const int c = blockIdx.x * kCh + threadIdx.x;
  const int b = blockIdx.z;
  const int p = c < C ? channel_of(sel, c, P) : -1;
  if (p < 0) return;
  const float m = __half2float(mins[b * C + c]);
  const float rng = fmaxf(__fsub_rn(__half2float(maxs[b * C + c]), m), 1e-12f);
  const float lv = (float)levels;
  const float* xb = x + (size_t)b * R * P + p;
  CodeT* cb = codes + (size_t)b * R * C + c;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  for (int r = r0 + threadIdx.y; r < r1; r += kRows) {
    const float s = __fmul_rn(__fdiv_rn(__fsub_rn(xb[(size_t)r * P], m), rng), lv);
    cb[(size_t)r * C] = (CodeT)fminf(fmaxf(rintf(s), 0.0f), lv);
  }
}

template <typename CodeT>
int launch(const void* x, const void* sel, void* codes, void* mins,
           void* maxs, void* partials, int B, int R, int P, int C, int levels,
           int nrb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int rpb = (R + nrb - 1) / nrb;
  float* pmin = (float*)partials;
  float* pmax = pmin + (size_t)B * nrb * C;
  const dim3 block(kCh, kRows);
  const dim3 grid((C + kCh - 1) / kCh, nrb, B);
  minmax_partial<<<grid, block, 0, s>>>((const float*)x, (const int*)sel,
                                        pmin, pmax, R, P, C, rpb);
  finalize<<<dim3(grid.x, B), block, 0, s>>>(pmin, pmax, (__half*)mins,
                                               (__half*)maxs, C, nrb);
  quantize_codes<CodeT><<<grid, block, 0, s>>>(
      (const float*)x, (const int*)sel, (const __half*)mins,
      (const __half*)maxs, (CodeT*)codes, R, P, C, levels, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, R, P) f32; sel (C,) int32 or null (then P == C); codes (B, R, C)
// uint8 (1..8 bits) or uint16 (9..16 bits); mins/maxs (B, C) f16;
// partials 2 * B * nrb * C f32 scratch.
extern "C" int baf_quantize_f32(const void* x, const void* sel, void* codes,
                                void* mins, void* maxs, void* partials, int B,
                                int R, int P, int C, int levels, int nrb,
                                int device, void* stream) {
  return launch<uint8_t>(x, sel, codes, mins, maxs, partials, B, R, P, C,
                         levels, nrb, device, stream);
}

extern "C" int baf_quantize_f32_u16(const void* x, const void* sel,
                                    void* codes, void* mins, void* maxs,
                                    void* partials, int B, int R, int P,
                                    int C, int levels, int nrb, int device,
                                    void* stream) {
  return launch<uint16_t>(x, sel, codes, mins, maxs, partials, B, R, P, C,
                          levels, nrb, device, stream);
}
