// The served BaF restore's 3x3 convolutions (core/split.py::
// restore_codes_fused): the x2 transposed conv `up`, `c2`, `c3`, `c4` and
// the frozen split conv (stride 2, BN after it), as one implicit GEMM each,
// float32 in and out, on the tensor cores in 3xTF32.
//
// Replaces no Pallas kernel: the JAX package's convolutions are XLA's. It
// takes the place of cuDNN on this path only (the trainer, the unfused
// restore and the CNN's halves keep nn.py's cuDNN calls), because cuDNN has
// no float32 product on the tensor cores: with TF32 off it runs its float32
// FFT and implicit-GEMM convolutions on the CUDA cores (PERF.md section 5).
//
// Bound: products. A request's restore is 7.55 GFLOP at C=64 (7.70 at
// C=96) against ~35 MB, so at 3xTF32's 165 TFLOP/s (495 / 3) and 3.35 TB/s
// the products take ~46 us and the bytes ~10 us.
//
// The GEMM: rows are the output pixels of the whole micro-batch (B Ho Wo),
// columns the output channels, the depth 9 Cin (tap-major, a tap's channels
// contiguous as NHWC keeps them). SAME padding is applied in the gather (a
// tap outside the input reads zeros), so no padded copy and no permute is
// made. The transposed conv (XLA's SAME conv_transpose: the kernel not
// flipped, correlated with the input dilated by 2 and padded (2, 1)) is
// split into its four output parity classes (py, px), one per blockIdx.z:
// output pixel (2 my + py, 2 mx + px) takes input (my + py - 1 + ey,
// mx + px - 1 + ex) through tap (py + 2 ey, px + 2 ex), for ey < 2 - py
// and ex < 2 - px. The classes hold 4, 2, 2 and 1 taps: 9 an input pixel,
// the products the restore needs, where a gather over the dilated input
// would make four times as many.
//
// A block of 4 warps computes 128 rows x 64 columns; a warp owns 32 rows
// and all 64 columns (2 x 8 tiles of mma.sync m16n8k8: 64 float32 sums a
// thread, and 64 more for a k-tile's part), so each A value is split into
// its TF32 parts once a block.
// k-tiles of 32 channels of one tap stream through a three-stage ring in
// shared memory with cp.async (16 bytes a copy where Cin is a multiple of
// 4 and x is 16-byte aligned, else 4; out-of-range taps and channels past
// Cin zero-filled). A: [row][8 pieces of 4 channels], piece q of row r
// stored at q ^ 4 (r & 1), so the 16-byte fragment reads of rows g and g + 1
// fall on distinct banks. Within each 16 channels, the mma's k column t
// takes channel 4t + 2e and column t + 4 channel 4t + 2e + 1 in k-step e:
// one 16-byte read gives a lane its A values of two k-steps. B (the
// weights) comes pre-split (kernels/baf_conv.py::prepare_weights) in that
// order, [ntile][tap][chunk][k-step][column][t][hi, hi, lo, lo]: a k-tile is
// one contiguous 16 KB copy and a lane's fragment one 16-byte read.
//
// Numerics: A's high part is x truncated to TF32 (one LOP3) and its
// remainder rounded to TF32 to nearest (x - hi - lo within 2^-21 |x|); B's
// parts are rounded to nearest (within 2^-22 |w|). Per k-step the small
// products first, then a_hi b_hi. The tensor cores' float32 sums truncate
// (flash_attention.cu: O drifted toward zero over 1,536 such additions),
// and the split conv's K = 1152 would make 432 of them into one sum: so
// each k-tile (4 k-steps, 12 additions) is summed from zero on the tensor
// cores and added to the running sum with float32 adds, which round to
// nearest. The epilogue runs on the float32 sums in nn.py's order of
// operations, built with -fmad=false: + bias; PReLU where(v >= 0, v,
// alpha v); or BN (v - mean) * rsqrt(var + eps) * scale + bias. The output
// is NHWC contiguous. No atomics: a pixel's result does not depend on the
// batch it is in or the run.
//
// Shared memory 98,304 B a block (three stages of 16 KB of A and 16 KB of
// B), two blocks an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int BM = 128;                   // output rows a block
constexpr int BN = 64;                    // output channels a block
constexpr int BK = 32;                    // channels a k-tile (one tap)
constexpr int STAGES = 3;
constexpr int WARPS = 4;                  // a warp: 32 rows x 64 columns
constexpr int NT = 32 * WARPS;
constexpr int ROWS_A_THREAD = BM * BK / 4 / NT;   // 16-byte pieces: 8
constexpr int A_WORDS = BM * BK;
constexpr int B_WORDS = 2 * BK * BN;      // high parts and remainders
constexpr int STAGE_WORDS = A_WORDS + B_WORDS;
constexpr int SMEM_BYTES = STAGES * STAGE_WORDS * 4;
constexpr float BN_EPS = 1e-5f;           // nn.py's BN_EPS

struct Conv {
  int H, W, Cin, Cout;       // the input (B, H, W, Cin), NHWC
  int MH, MW;                // a class's row grid (output pixels; input
                             // pixels for the transposed conv)
  int OH, OW;                // the output (B, OH, OW, Cout)
  int stride, pad_t, pad_l;  // regular conv
  int transposed;
  int chunks;                // k-tiles a tap: ceil(Cin / BK)
  long long M;               // rows a class: B MH MW
};

struct Epilogue {
  const float* bias;         // (Cout,) or null
  const float* alpha;        // PReLU's (Cout,) or null
  const float* mean;         // BN's four (Cout,), or all null
  const float* var;
  const float* scale;
  const float* shift;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (4) bytes from global to shared memory; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo: hi truncated to TF32, the exact remainder rounded to TF32
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c = a . b on the tensor cores (m16n8k8, TF32, float32), C taken as zero
__device__ __forceinline__ void mma_tf32_zero(float* c, const uint32_t* a,
                                              const uint32_t* b) {
  const float z = 0.0f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(z));
}

__device__ __forceinline__ float epilogue(float v, int c, const Epilogue& ep) {
  if (ep.bias) v = v + ep.bias[c];
  if (ep.alpha) v = v >= 0.0f ? v : ep.alpha[c] * v;
  if (ep.mean) {
    const float inv = rsqrtf(ep.var[c] + BN_EPS);
    v = (v - ep.mean[c]) * inv * ep.scale[c] + ep.shift[c];
  }
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
baf_conv_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                float* __restrict__ out, Conv cv, Epilogue ep) {
  extern __shared__ uint4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int py = blockIdx.z >> 1, px = blockIdx.z & 1;
  const long long m0 = (long long)blockIdx.x * BM;
  const int ntile = blockIdx.y;
  const int nx = cv.transposed ? 2 - px : 3;
  const int ntaps = cv.transposed ? (2 - py) * nx : 9;
  const int KT = ntaps * cv.chunks;

  // This thread copies piece q (channels 4q..4q+3 of a k-tile) of rows
  // tid / 8 + 16 i. For each: the input pixel of its tap (0, 0) and a mask
  // of the taps (bit 3 ey + ex) that lie inside the input.
  const int q = tid & 7;
  int pix[ROWS_A_THREAD], inside[ROWS_A_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_A_THREAD; ++i) {
    const long long row = m0 + (tid >> 3) + 16 * i;
    pix[i] = 0;
    inside[i] = 0;
    if (row < cv.M) {
      const int mx = (int)(row % cv.MW);
      const long long r2 = row / cv.MW;
      const int my = (int)(r2 % cv.MH);
      const int b = (int)(r2 / cv.MH);
      const int iy0 = cv.transposed ? my + py - 1 : my * cv.stride - cv.pad_t;
      const int ix0 = cv.transposed ? mx + px - 1 : mx * cv.stride - cv.pad_l;
      pix[i] = (b * cv.H + iy0) * cv.W + ix0;
      int mk = 0;
#pragma unroll
      for (int ey = 0; ey < 3; ++ey)
#pragma unroll
        for (int ex = 0; ex < 3; ++ex)
          if (iy0 + ey >= 0 && iy0 + ey < cv.H && ix0 + ex >= 0 &&
              ix0 + ex < cv.W)
            mk |= 1 << (3 * ey + ex);
      inside[i] = mk;
    }
  }

  // k-tile kt (tap kt / chunks, channels 32 (kt % chunks) on) into `stage`
  auto load_tile = [&](int stage, int kt) {
    float* sa = smem + stage * STAGE_WORDS;
    float* sb = sa + A_WORDS;
    const int tap_i = kt / cv.chunks, chunk = kt % cv.chunks;
    int ey, ex, tap;
    if (cv.transposed) {
      ey = tap_i / nx;
      ex = tap_i % nx;
      tap = (py + 2 * ey) * 3 + px + 2 * ex;
    } else {
      ey = tap_i / 3;
      ex = tap_i % 3;
      tap = tap_i;
    }
    const int bit = 3 * ey + ex;
    const int toff = ey * cv.W + ex;
    const int ch = chunk * BK + 4 * q;
#pragma unroll
    for (int i = 0; i < ROWS_A_THREAD; ++i) {
      const int r = (tid >> 3) + 16 * i;
      const bool tap_ok = (inside[i] >> bit) & 1;
      const float* src = x + (long long)(pix[i] + toff) * cv.Cin + ch;
      const uint32_t dst = smem_u32(sa + r * BK + 4 * (q ^ ((r & 1) << 2)));
      if (VEC) {
        const bool ok = tap_ok && ch < cv.Cin;
        cp_async16(dst, ok ? src : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = tap_ok && ch + e < cv.Cin;
          cp_async4(dst + 4 * e, ok ? src + e : x, ok);
        }
      }
    }
    const float* wsrc =
        wp + (((long long)ntile * 9 + tap) * cv.chunks + chunk) * B_WORDS;
#pragma unroll
    for (int j = 0; j < B_WORDS / 4 / NT; ++j) {
      const int w4 = 4 * (tid + NT * j);
      cp_async16(smem_u32(sb + w4), wsrc + w4, true);
    }
  };

  // acc: the float32 sum over k-tiles; part: one k-tile's sum on the
  // tensor cores, started from zero and added to acc with float32 adds
  float acc[2][8][4], part[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt is in (this thread's copies)
    __syncthreads();               // everyone's copies; stage kt-1 read
    if (kt + STAGES - 1 < KT) load_tile((kt + STAGES - 1) % STAGES,
                                        kt + STAGES - 1);
    cp_async_commit();
    const float* sa = smem + (kt % STAGES) * STAGE_WORDS;
    const uint32_t* sb = reinterpret_cast<const uint32_t*>(sa + A_WORDS);
#pragma unroll
    for (int h = 0; h < 2; ++h) {            // 16 channels: two k-steps
      float4 ra[2][2];                       // [m tile][row g, g + 8]
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = warp * 32 + i * 16 + g + 8 * rr;
          ra[i][rr] = *reinterpret_cast<const float4*>(
              sa + r * BK + 4 * ((4 * h + t) ^ ((r & 1) << 2)));
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
          split_trunc(e ? ra[i][0].z : ra[i][0].x, ah[i][0], al[i][0]);
          split_trunc(e ? ra[i][1].z : ra[i][1].x, ah[i][1], al[i][1]);
          split_trunc(e ? ra[i][0].w : ra[i][0].y, ah[i][2], al[i][2]);
          split_trunc(e ? ra[i][1].w : ra[i][1].y, ah[i][3], al[i][3]);
        }
        const int ks = 2 * h + e;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint4 b = *reinterpret_cast<const uint4*>(
              sb + ((ks * BN + 8 * j + g) * 4 + t) * 4);
          const uint32_t bh[2] = {b.x, b.y}, bl[2] = {b.z, b.w};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (ks == 0)
              mma_tf32_zero(part[i][j], al[i], bh);
            else
              mma_tf32(part[i][j], al[i], bh);
            mma_tf32(part[i][j], ah[i], bl);
            mma_tf32(part[i][j], ah[i], bh);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long row = m0 + warp * 32 + i * 16 + g + 8 * rr;
      if (row >= cv.M) continue;
      long long opix = row;
      if (cv.transposed) {
        const int mx = (int)(row % cv.MW);
        const long long r2 = row / cv.MW;
        const int my = (int)(r2 % cv.MH);
        const long long b = r2 / cv.MH;
        opix = (b * cv.OH + 2 * my + py) * cv.OW + 2 * mx + px;
      }
      float* o = out + opix * cv.Cout;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = ntile * BN + 8 * j + 2 * t;
        if (c >= cv.Cout) continue;
        const float v0 = epilogue(acc[i][j][2 * rr], c, ep);
        if (c + 1 < cv.Cout) {
          const float v1 = epilogue(acc[i][j][2 * rr + 1], c + 1, ep);
          if (cv.Cout % 2 == 0) {
            *reinterpret_cast<float2*>(o + c) = make_float2(v0, v1);
          } else {
            o[c] = v0;
            o[c + 1] = v1;
          }
        } else {
          o[c] = v0;
        }
      }
    }
}

template <bool VEC>
int launch(const float* x, const float* wp, float* out, const Conv& cv,
           const Epilogue& ep, int classes, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      baf_conv_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((cv.M + BM - 1) / BM), (cv.Cout + BN - 1) / BN,
                  classes);
  baf_conv_kernel<VEC><<<grid, NT, SMEM_BYTES, s>>>(x, wp, out, cv, ep);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin) float32 NHWC contiguous; w the weights as
// kernels/baf_conv.py::prepare_weights lays them out for (Cin, Cout); out
// (B, OH, OW, Cout) contiguous: OH = 2H for the transposed conv (kernel 3,
// stride 2, XLA's SAME), else ceil(H / stride) with SAME pads (pad_t,
// pad_l) before. bias, alpha: (Cout,) or null; mean, var, scale, shift: BN
// after the conv, all four or none.
extern "C" int baf_conv_f32(const void* x, const void* w, const void* bias,
                            const void* alpha, const void* mean,
                            const void* var, const void* scale,
                            const void* shift, void* out, int B, int H,
                            int W, int Cin, int Cout, int stride, int pad_t,
                            int pad_l, int transposed, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || H < 0 || W < 0 || Cin <= 0 || Cout <= 0 || stride < 1 ||
      (transposed && stride != 2) || ((mean == nullptr) != (var == nullptr)) ||
      ((mean == nullptr) != (scale == nullptr)) ||
      ((mean == nullptr) != (shift == nullptr)))
    return (int)cudaErrorInvalidValue;
  Conv cv;
  cv.H = H;
  cv.W = W;
  cv.Cin = Cin;
  cv.Cout = Cout;
  cv.OH = transposed ? 2 * H : (H + stride - 1) / stride;
  cv.OW = transposed ? 2 * W : (W + stride - 1) / stride;
  cv.MH = transposed ? H : cv.OH;
  cv.MW = transposed ? W : cv.OW;
  cv.stride = stride;
  cv.pad_t = pad_t;
  cv.pad_l = pad_l;
  cv.transposed = transposed;
  cv.chunks = (Cin + BK - 1) / BK;
  cv.M = (long long)B * cv.MH * cv.MW;
  if (cv.M == 0) return 0;
  // pixel indices and a row's offsets stay within 32 bits
  if ((long long)B * H * W >= (1LL << 31) ||
      (long long)B * cv.OH * cv.OW >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Epilogue ep{(const float*)bias,  (const float*)alpha,
                    (const float*)mean,  (const float*)var,
                    (const float*)scale, (const float*)shift};
  const int classes = transposed ? 4 : 1;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? launch<true>((const float*)x, (const float*)w, (float*)out,
                            cv, ep, classes, s)
             : launch<false>((const float*)x, (const float*)w, (float*)out,
                             cv, ep, classes, s);
}
