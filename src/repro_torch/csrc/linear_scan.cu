// Chunked linear attention (RWKV-6 wkv / Mamba-2 SSD): per head
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
//   rwkv: y_t = q_t . S_{t-1} + (q_t * u * k_t) . v_t      (bonus u)
//   ssm : y_t = q_t . S_t
// computed chunk by chunk with the JAX package's factorisation.
//
// Replaces: src/repro/kernels/linear_scan.py::linear_scan_pallas
// (_scan_kernel) with the clamp, broadcasts and head flattening of
// src/repro/kernels/ops.py::linear_scan. The TPU kernel carries the (dk, dv)
// state in VMEM scratch across a sequential chunk grid dimension. Here one
// block loops over the chunks in order with its part of the state in shared
// memory, and the heads are read in place from (B, S, H, d): no transposes.
//
// Per chunk of L steps (the arithmetic of models/linear_attention.py's
// chunked path, kept exactly, overflow included): ld = clip(log_decay, -4,
// -1e-9); la = cumsum(ld) (inclusive), la_prev = la - ld, la_end = la[L-1];
// qd = q * exp(rwkv ? la_prev : la); kd = k * exp(-la);
// k_rem = k * exp(la_end - la); scores = (qd . kd^T) * tri (strict lower
// for rwkv, inclusive for ssm; a 0/1 product as in the reference, so an
// overflowed chunk gives the reference's NaNs); y = scores . v
// (+ (q * u * k) . v for rwkv with a bonus) + qd . S;
// S = exp(la_end) * S + k_rem^T . v. All float32; q, k, v are read in
// float32 or bf16 and widened.
//
// Bound on the H100: bytes (each step reads q, k, v and the decay and
// writes y once; the state stays on chip). The chunk loop is sequential,
// so each block's time is L-step latency times S / L chunks.
//
// Design: block = (b, h, 16 of the dv columns). The columns of S never
// interact, so splitting dv across blocks is exact; it turns the 80 (b, h)
// pairs of rwkv6-3b at B = 2 into 320 blocks for 132 SMs. Each block
// recomputes the chunk's decays and scores (L x L x dk, small) and keeps a
// (dk, 16) slice of the state. Shared arrays indexed [t][d] use row stride
// dk + 1 so the per-column cumsum and the score products are free of bank
// conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int DVT = 16;                  // dv columns per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Dims {
  int B, S, H, DK, DV, L, rwkv, bonus, ld_per_channel;
};

__host__ __device__ inline int smem_floats(int L, int DK) {
  const int dkp = DK + 1;
  // q/qd, k/kd, k_rem, ld: [L][dkp]; v: [L][DVT]; scores [L][L]; bonus [L];
  // la_end [DK]; state [DK][DVT]
  return 4 * L * dkp + L * DVT + L * L + L + DK + DK * DVT;
}

template <typename T>
__global__ void __launch_bounds__(NT)
scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ ld,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sf, Dims dm) {
  extern __shared__ float smem[];
  const int L = dm.L, DK = dm.DK, DV = dm.DV, dkp = DK + 1;
  float* qs = smem;                 // q, then qd
  float* ks = qs + L * dkp;         // k, then kd
  float* kr = ks + L * dkp;         // la, then k_rem
  float* ls = kr + L * dkp;         // clamped log-decay
  float* vs = ls + L * dkp;         // [L][DVT]
  float* sc = vs + L * DVT;         // [L][L]
  float* bq = sc + L * L;           // [L]
  float* le = bq + L;               // [DK] la_end
  float* st = le + DK;              // [DK][DVT]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / dm.H, h = bh % dm.H;
  const int j0 = blockIdx.y * DVT;
  const int nj = min(DVT, DV - j0);
  const long long row_qk = (long long)dm.H * DK;     // elements per step
  const long long row_v = (long long)dm.H * DV;
  const int ldw = dm.ld_per_channel ? DK : 1;
  const long long row_ld = (long long)dm.H * ldw;

  for (int i = tid; i < DK * DVT; i += NT) {
    const int d = i / DVT, jj = i % DVT;
    st[i] = (s0 && jj < nj)
                ? s0[(((long long)b * dm.H + h) * DK + d) * DV + j0 + jj]
                : 0.0f;
  }

  const int nc = dm.S / L;
  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)b * dm.S + (long long)c * L;
    for (int i = tid; i < L * DK; i += NT) {
      const int t = i / DK, d = i % DK;
      const long long o = (t0 + t) * row_qk + (long long)h * DK + d;
      qs[t * dkp + d] = to_f(q[o]);
      ks[t * dkp + d] = to_f(k[o]);
      const float w = ld[(t0 + t) * row_ld + (long long)h * ldw +
                         (dm.ld_per_channel ? d : 0)];
      ls[t * dkp + d] = fminf(fmaxf(w, -4.0f), -1e-9f);
    }
    for (int i = tid; i < L * DVT; i += NT) {
      const int t = i / DVT, jj = i % DVT;
      vs[i] = jj < nj ? to_f(v[(t0 + t) * row_v + (long long)h * DV + j0 + jj])
                      : 0.0f;
    }
    __syncthreads();

    if (dm.bonus && tid < L) {      // (q * u * k) summed over dk
      float acc = 0.0f;
      for (int d = 0; d < DK; ++d)
        acc = fmaf(qs[tid * dkp + d] * u[h * DK + d], ks[tid * dkp + d], acc);
      bq[tid] = acc;
    }
    __syncthreads();                 // raw q and k are read; scale in place
    for (int d = tid; d < DK; d += NT) {   // decays, one dk column a thread
      float la = 0.0f;
      for (int t = 0; t < L; ++t) {
        la = la + ls[t * dkp + d];
        kr[t * dkp + d] = la;
      }
      le[d] = la;
      for (int t = 0; t < L; ++t) {
        const float a = kr[t * dkp + d];
        const float a_prev = a - ls[t * dkp + d];
        const float kk = ks[t * dkp + d];
        qs[t * dkp + d] *= expf(dm.rwkv ? a_prev : a);
        ks[t * dkp + d] = kk * expf(-a);
        kr[t * dkp + d] = kk * expf(la - a);
      }
    }
    __syncthreads();

    for (int i = tid; i < L * L; i += NT) {
      const int t = i / L, s = i % L;
      float acc = 0.0f;
      for (int d = 0; d < DK; ++d)
        acc = fmaf(qs[t * dkp + d], ks[s * dkp + d], acc);
      const bool keep = dm.rwkv ? s < t : s <= t;
      sc[i] = acc * (keep ? 1.0f : 0.0f);
    }
    __syncthreads();

    for (int i = tid; i < L * DVT; i += NT) {
      const int t = i / DVT, jj = i % DVT;
      float intra = 0.0f;
      for (int s = 0; s < L; ++s) intra = fmaf(sc[t * L + s], vs[s * DVT + jj], intra);
      if (dm.bonus) intra = intra + bq[t] * vs[t * DVT + jj];
      float inter = 0.0f;
      for (int d = 0; d < DK; ++d)
        inter = fmaf(qs[t * dkp + d], st[d * DVT + jj], inter);
      if (jj < nj)
        y[(t0 + t) * row_v + (long long)h * DV + j0 + jj] = intra + inter;
    }
    __syncthreads();

    for (int i = tid; i < DK * DVT; i += NT) {
      const int d = i / DVT, jj = i % DVT;
      float acc = 0.0f;
      for (int t = 0; t < L; ++t)
        acc = fmaf(kr[t * dkp + d], vs[t * DVT + jj], acc);
      st[i] = expf(le[d]) * st[i] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < DK * DVT; i += NT) {
    const int d = i / DVT, jj = i % DVT;
    if (jj < nj)
      sf[(((long long)b * dm.H + h) * DK + d) * DV + j0 + jj] = st[i];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ld,
           const void* u, const void* s0, void* y, void* sf, int B, int S,
           int H, int DK, int DV, int L, int rwkv, int ld_per_channel,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || DK <= 0 || DV <= 0) return 0;
  if (L <= 0 || S % L != 0) return (int)cudaErrorInvalidValue;
  const Dims dm{B, S, H, DK, DV, L, rwkv, u != nullptr && rwkv,
                ld_per_channel};
  const size_t smem = (size_t)smem_floats(L, DK) * sizeof(float);
  err = cudaFuncSetAttribute(scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (DV + DVT - 1) / DVT);
  scan_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)ld,
      (const float*)u, (const float*)s0, (float*)y, (float*)sf, dm);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k (B, S, H, DK) and v (B, S, H, DV), contiguous, float32 or bf16;
// ld (B, S, H, DK) or (B, S, H, 1) float32 (unclamped); u (H, DK) float32 or
// null; s0 (B, H, DK, DV) float32 or null (zeros); y (B, S, H, DV) and
// sf (B, H, DK, DV) float32. S must be a multiple of the chunk L.
extern "C" int linear_scan_f32(const void* q, const void* k, const void* v,
                               const void* ld, const void* u, const void* s0,
                               void* y, void* sf, int B, int S, int H, int DK,
                               int DV, int L, int rwkv, int ld_per_channel,
                               int device, void* stream) {
  return launch<float>(q, k, v, ld, u, s0, y, sf, B, S, H, DK, DV, L, rwkv,
                       ld_per_channel, device, stream);
}

extern "C" int linear_scan_bf16(const void* q, const void* k, const void* v,
                                const void* ld, const void* u, const void* s0,
                                void* y, void* sf, int B, int S, int H, int DK,
                                int DV, int L, int rwkv, int ld_per_channel,
                                int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, ld, u, s0, y, sf, B, S, H, DK, DV, L,
                               rwkv, ld_per_channel, device, stream);
}
