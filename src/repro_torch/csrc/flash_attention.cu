// Online-softmax (flash) attention with GQA, causal alignment, an optional
// sliding window and ragged lengths.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (_flash_kernel) and the GQA repeat and head transposes around it in
// src/repro/kernels/ops.py::flash_attention. The TPU kernel walks the kv
// blocks of one (head, q block) as a sequential grid dimension with m, l and
// the accumulator in VMEM scratch. Here one block owns one (b, h, 64-row q
// tile) and loops over the 64-row kv tiles itself, with m, l and the
// accumulator in registers; the (Sq, Sk) score matrix never reaches device
// memory.
//
// Semantics (as the reference kernels/ref.py::flash_attention_ref): scores
// q.k * (1/sqrt(hd)) in float32; query row i sits at position
// i + (Sk - Sq), so a causal row sees keys kpos <= qpos; a window keeps
// kpos > qpos - window. Masked scores are -inf and contribute exactly 0.
// Every row sees at least its own position, since the wrapper refuses
// causal calls with Sq > Sk, the one case that would leave a row without a
// key; l is still clamped at 1e-20 as on the TPU.
// kv tiles that the causal mask or the window hide entirely are skipped.
// Query head h reads kv head h / (H / KH): GQA without a materialised repeat.
// Inputs are read in place through their (B, S, H) strides, the last dim
// contiguous; the output is (B, Sq, H, hd) contiguous in q's dtype.
//
// Bound on the H100: at the qwen2-7b prefill (B = 2, S = 512, 28 q heads,
// 4 kv heads, hd = 128, bf16, causal) the call does 3.76 GFLOP on 16.8 MB,
// ~224 flops per byte: just under the bf16 tensor-core ridge (989 TFLOP/s
// over 3.35 TB/s = 295), so the card's bound is the bytes, ~5 us. This
// first version runs float32 FMAs on the CUDA cores (67 TFLOP/s, ridge 20),
// no tensor cores, so its own floor is the operations, ~56 us; wgmma is the
// next step.
//
// Design: 256 threads as 16 x 16; thread (ty, tx) owns q rows ty*4..ty*4+3
// and, for each kv tile, key columns tx + 16j (j < 4) of the score tile and
// output columns tx + 16j (j < hd/16) of the accumulator. Q (transposed,
// rows padded to 68), K (transposed, padded to 65) and V live in shared
// memory in float32; P is written over K's buffer once the scores are
// taken. Row max and row sum are reduced with shuffles over the 16 lanes
// of a row. expf (not __expf), IEEE division, explicit fmaf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // q rows per block
constexpr int BK = 64;            // kv rows per tile
constexpr int NT = 256;           // threads (16 x 16)
constexpr int QST = BQ + 4;       // Qs row stride (float4-aligned)
constexpr int KST = BK + 1;       // Ks row stride (conflict-free transpose)
constexpr int PST = BQ + 4;       // Ps row stride (float4-aligned)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

struct Shape {
  int Sq, Sk, H, KH, causal, window;          // window <= 0: none
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;  // strides, in elements
};

__host__ __device__ constexpr int smem_floats(int hd) {
  return hd * QST + (hd * KST > BK * PST ? hd * KST : BK * PST) + BK * hd;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Shape sh) {
  constexpr int NJ = HD / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                       // [HD][QST]
  float* Ks = Qs + HD * QST;              // [HD][KST], later P as [BK][PST]
  float* Ps = Ks;
  float* Vs = Ks + (HD * KST > BK * PST ? HD * KST : BK * PST);  // [BK][HD]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nqt = gridDim.x;
  const int qt = nqt - 1 - blockIdx.x;     // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / sh.H, h = bh % sh.H;
  const int kvh = h / (sh.H / sh.KH);
  const int q0 = qt * BQ;
  const int q_offset = sh.Sk - sh.Sq;
  const float scale = 1.0f / sqrtf((float)HD);

  const T* qp = q + b * sh.qb + h * sh.qh;
  const T* kp = k + b * sh.kb + kvh * sh.kh;
  const T* vp = v + b * sh.vb + kvh * sh.vh;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int row = q0 + r;
    Qs[d * QST + r] = row < sh.Sq ? to_f(qp[row * sh.qs + d]) : 0.0f;
  }

  // kv tiles that hold a visible key for some row of this q tile
  const int q_last = min(q0 + BQ, sh.Sq) - 1;
  int k_hi = sh.Sk - 1;
  if (sh.causal) k_hi = min(k_hi, q_last + q_offset);
  int k_lo = 0;
  if (sh.window > 0) k_lo = max(0, q0 + q_offset - sh.window + 1);
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi < 0 ? -1 : k_hi / BK;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();            // the previous tile's P and V are consumed
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int r = idx / HD, d = idx % HD;
      const int row = k0 + r;
      const bool in = row < sh.Sk;
      Ks[d * KST + r] = in ? to_f(kp[row * sh.ks + d]) : 0.0f;
      Vs[r * HD + d] = in ? to_f(vp[row * sh.vs + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[d * QST + ty * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[d * KST + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + q_offset;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < sh.Sk;
        if (sh.causal) ok = ok && kpos <= qpos;
        if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float mref = m_new == -INFINITY ? 0.0f : m_new;
      alpha[i] = expf(m[i] - mref);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mref);     // masked: exp(-inf) = 0
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = fmaf(l[i], alpha[i], rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha[i];
    }

    __syncthreads();            // every thread is done reading K
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * PST + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[kk * PST + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sh.Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* orow = o + (((long long)b * sh.Sq + row) * sh.H + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      orow[tx + 16 * j] = from_f<T>(acc[i][j] / den);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              const Shape& sh, cudaStream_t s) {
  const size_t smem = (size_t)smem_floats(HD) * sizeof(float);
  // above 48 KB of dynamic shared memory only after opting in (per device)
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sh.Sq + BQ - 1) / BQ, B * sh.H);
  flash_kernel<T, HD><<<grid, NT, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KH, int hd, long long qb, long long qs,
           long long qh, long long kb, long long ks, long long kh,
           long long vb, long long vs, long long vh, int causal, int window,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || Sk < 0) return (int)cudaErrorInvalidValue;
  const Shape sh{Sq, Sk, H, KH, causal, window, qb, qs, qh,
                 kb, ks, kh, vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, o, B, sh, s);
    case 32: return launch_hd<T, 32>(q, k, v, o, B, sh, s);
    case 64: return launch_hd<T, 64>(q, k, v, o, B, sh, s);
    case 128: return launch_hd<T, 128>(q, k, v, o, B, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Sk, KH, hd) with element strides for the first
// three dims and the last dim contiguous; o (B, Sq, H, hd) contiguous.
// window <= 0 means no window.
extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int KH, int hd, long long qb, long long qs, long long qh,
    long long kb, long long ks, long long kh, long long vb, long long vs,
    long long vh, int causal, int window, int device, void* stream) {
  return launch<float>(q, k, v, o, B, Sq, Sk, H, KH, hd, qb, qs, qh, kb, ks,
                       kh, vb, vs, vh, causal, window, device, stream);
}

extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int KH, int hd, long long qb, long long qs, long long qh,
    long long kb, long long ks, long long kh, long long vb, long long vs,
    long long vh, int causal, int window, int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KH, hd, qb, qs, qh,
                               kb, ks, kh, vb, vs, vh, causal, window, device,
                               stream);
}
