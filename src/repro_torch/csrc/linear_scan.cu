// Chunked linear attention (RWKV-6 wkv / Mamba-2 SSD): per head
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
//   rwkv: y_t = q_t . S_{t-1} + (q_t * u * k_t) . v_t      (bonus u)
//   ssm : y_t = q_t . S_t
// computed chunk by chunk with the JAX package's factorisation.
//
// Replaces: src/repro/kernels/linear_scan.py::linear_scan_pallas
// (_scan_kernel) with the clamp, broadcasts and head flattening of
// src/repro/kernels/ops.py::linear_scan. The TPU kernel carries the (dk, dv)
// state in VMEM scratch across a sequential chunk grid dimension. Here only
// the state recurrence runs in order; everything else runs for all chunks
// at once, and the heads are read in place from (B, S, H, d): no transposes.
//
// Per chunk c of L steps (the arithmetic of models/linear_attention.py's
// chunked path, kept exactly, overflow included): ld = clip(log_decay, -4,
// -1e-9); la = cumsum(ld) (inclusive, in step order), la_prev = la - ld,
// la_end = la[L-1]; qd = q * exp(rwkv ? la_prev : la); kd = k * exp(-la);
// k_rem = k * exp(la_end - la); scores = (qd . kd^T) * tri (strict lower
// for rwkv, inclusive for ssm; a 0/1 product as in the reference, so an
// overflowed chunk gives the reference's NaNs);
//   y_c = scores . v (+ (q * u * k) . v for rwkv with a bonus) + qd . S_{c-1}
//   S_c = exp(la_end) * S_{c-1} + k_rem^T . v.
// All float32 on the CUDA cores (bf16 or TF32 operands would not meet the
// 1e-4 tolerance); q, k, v are read in float32 or bf16 and widened; expf,
// IEEE arithmetic, built with -fmad=false.
//
// Two passes on the caller's stream, one C entry:
//   A. one block per (b, h, c), all chunks at once: decays, qd, kd, k_rem,
//      the masked scores and y_c's intra-chunk part (with the bonus). A
//      scalar decay (Mamba-2) and its cumsum are held as [L] vectors, not
//      as [L][dk] rows, so zamba2's chunk of 128 at dk = dv = 64 fits a
//      block's shared memory (51,136 floats; per-channel decay at that
//      chunk does not, and the wrapper refuses it). It
//      writes k_rem, qd, v (as float32) and y_intra of the chunk, and
//      exp(la_end_c), to a scratch the wrapper allocates. A thread computes
//      a small tile of outputs (2x2 scores, 1x4 of y_intra) from float4
//      reads of shared memory and issues all its global loads of a phase
//      before it stores any (staged()).
//   B. one block per (b, h, 16 dv columns) walks the chunks in order with
//      its (dk, 16) slice of the state in registers (a 4 x 2 tile a
//      thread): y_c = y_intra + qd_c . S_{c-1}, then
//      S_c = exp(la_end_c) * S_{c-1} + k_rem_c^T . v_c, while the next
//      chunk's scratch is copied into shared memory (cp.async, two
//      stages). Only this recurrence runs in chunk order.
// Both passes are also compiled with rwkv6-3b's and zamba2-1.2b's chunk
// and head dims ((16, 64, 64) and (128, 64, 64)) fixed, which the launcher
// picks for those shapes: the index arithmetic folds and the loops unroll.
//
// Bound on the H100: at the rwkv6-3b prefill (B = 2, S = 512, 40 heads,
// dk = dv = 64, chunk 16) inputs and outputs are 38 MB (11.4 us) and the
// masked products 0.77 GFLOP of float32 (11.5 us). The scratch,
// B * H * (S / L) * (2 L dk + 2 L dv + dk) floats (42 MB here), is written
// once and read once (k_rem and qd by each of the dv / 16 blocks of a
// head, mostly from L2). Pass B's time is its chunk chain: about 2 us a
// chunk, set neither by its loads (four stages in flight did not help)
// nor by the work a thread does (halving it did not help). Earlier
// designs measured slower: three passes (the state increments to scratch,
// the recurrence elementwise, then qd . S per chunk), which moved four
// times the scratch, and a chunk-ordered pass that waited on its loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int JS = 16;              // dv columns per block of pass B
constexpr int NTB = 128;            // threads of pass B
constexpr int TJ = 2;               // state columns a thread of pass B holds
constexpr int NJ = JS / TJ;         // threads across one row of the slice
constexpr int MAXG = 2;             // 4-row groups of S a thread: dk <= 128

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Dims {
  int B, S, H, DK, DV, L, NC, rwkv, bonus, ld_per_channel;
};

// [L][*] arrays over dk have row stride dkp: dk rounded up to 4 (the pad
// holds zeros, so float4 loops over d add exact zeros) plus 4, so rows
// start 16-byte aligned and 8 consecutive rows fall on distinct banks.
__host__ __device__ inline int r4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline int dk4(int DK) { return r4(DK); }
__host__ __device__ inline int dk_stride(int DK) { return dk4(DK) + 4; }
// arrays over dv have rows of dv rounded up to 64, zeros in the pad: the
// products then run over whole blocks of 64 columns without guards
__host__ __device__ inline int dv64(int DV) { return (DV + 63) / 64 * 64; }

// shared floats of pass A and of pass B
__host__ __device__ inline int smem_floats_a(int L, int DK, int DV,
                                             int ld_per_channel) {
  // q/qd, k/kd, la/k_rem: [L][dkp]; v [L][dv64]; scores [L][L]; bonus
  // [L]; la_end [DK]; the clamped log-decay as [L][dkp] when it is per
  // channel, else it and its cumsum as two [L] vectors (la then lives
  // there, and the third [L][dkp] array holds k_rem alone)
  const int ld_floats = ld_per_channel ? L * dk_stride(DK) : 2 * r4(L);
  return 3 * L * dk_stride(DK) + L * dv64(DV) + r4(L * L + L + DK) +
         ld_floats;
}
__host__ __device__ inline int stage_floats_b(int L, int DK) {
  // k_rem [L][dk4]; qd [L][dk4 + 4] (rows shifted by 4 banks); v, y_intra
  // [L][JS]; decay [dk4]
  return L * dk4(DK) + L * (dk4(DK) + 4) + 2 * L * JS + dk4(DK);
}
__host__ __device__ inline int smem_floats_b(int L, int DK) {
  return 2 * stage_floats_b(L, DK) + dk4(DK) * JS;   // two stages, S
}

// Scratch from pass A to pass B, per chunk (b, h, c): k_rem and qd as
// [L][dk4], v and y_intra as [L][dv64], exp(la_end) as [dk4]; zeros in the
// pads. Every part starts 16-byte aligned.
struct Scratch {
  float *kr, *qd, *v, *yi, *decay;
};
__host__ __device__ inline long long scratch_chunk_floats(int L, int DK,
                                                          int DV) {
  return 2LL * L * dk4(DK) + 2LL * L * dv64(DV) + dk4(DK);
}
__device__ __forceinline__ Scratch scratch_of(float* base, const Dims& dm,
                                              long long chunk_id) {
  const int L = dm.L, d4 = dk4(dm.DK), dvp = dv64(dm.DV);
  float* p = base + chunk_id * scratch_chunk_floats(L, dm.DK, dm.DV);
  return {p, p + L * d4, p + 2 * L * d4, p + 2 * L * d4 + L * dvp,
          p + 2 * L * d4 + 2 * L * dvp};
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// n thread-strided elements of W floats each: a thread issues the loads
// of BATCH elements before it stores any, so their latencies overlap
template <int W, int BATCH, typename Load, typename Store>
__device__ __forceinline__ void staged(int n, Load load, Store store) {
  for (int i0 = threadIdx.x; i0 < n; i0 += NT * BATCH) {
    float r[BATCH][W];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (i0 + u * NT < n) load(i0 + u * NT, r[u]);
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (i0 + u * NT < n) store(i0 + u * NT, r[u]);
  }
}

// 16 bytes from global to shared memory, asynchronously (cp.async)
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_prev() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float clamp_ld(float w) {
  return fminf(fmaxf(w, -4.0f), -1e-9f);
}

// Pass A: the state-free terms of one chunk, for all chunks at once.
// (a chunk of 128 takes a block's whole shared memory: one block an SM,
// so its registers are not held to 8 blocks' share)
template <typename T, int CL, int CDK, int CDV>
__global__ void __launch_bounds__(NT, CL > 64 ? 1 : 8)
chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ ld,
             const float* __restrict__ u, float* __restrict__ scratch,
             Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // CL, CDK, CDV: the chunk and head dims fixed at compile time, or 0
  const int L = CL ? CL : dm.L, DK = CDK ? CDK : dm.DK;
  const int DV = CDV ? CDV : dm.DV, DVP = dv64(DV);
  const int dkp = dk_stride(DK), d4 = dk4(DK);
  const bool pc = dm.ld_per_channel;
  float* qs = smem;                 // q, then qd
  float* ks = qs + L * dkp;         // k, then kd
  float* kr = ks + L * dkp;         // la (per channel), then k_rem
  float* vs = kr + L * dkp;         // [L][DVP]
  float* sc = vs + L * DVP;         // [L][L]
  float* bq = sc + L * L;           // [L]
  float* le = bq + L;               // [DK] la_end
  // the clamped log-decay: [L][dkp] per channel; else ls[t] and la[t]
  float* ls = sc + r4(L * L + L + DK);
  float* lv = ls + r4(L);           // la as [L] (scalar decay only)
  const int lstep = pc ? dkp : 1, lcol = pc ? 1 : 0;

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / dm.H, h = bh % dm.H;
  const long long t0 = (long long)b * dm.S + (long long)c * L;
  const long long row_qk = (long long)dm.H * DK;
  const long long row_v = (long long)dm.H * DV;
  const long long chunk_id = (long long)bh * dm.NC + c;
  const Scratch sp = scratch_of(scratch, dm, chunk_id);
  float* decay = sp.decay;
  for (int d = DK + tid; d < d4; d += NT) decay[d] = 0.0f;

  const int ldw = pc ? DK : 1;
  // q, k (zeros in the pad) and the clamped log-decay; then v
  staged<3, 4>(
      L * d4,
      [&](int i, float* r) {
        const int t = i / d4, d = i % d4;
        const long long o = (t0 + t) * row_qk + (long long)h * DK + d;
        const bool in = d < DK;
        r[0] = in ? to_f(q[o]) : 0.0f;
        r[1] = in ? to_f(k[o]) : 0.0f;
        r[2] = in && (pc || d == 0)
                   ? ld[(t0 + t) * dm.H * ldw + (long long)h * ldw + d * lcol]
                   : 0.0f;
      },
      [&](int i, const float* r) {
        const int t = i / d4, d = i % d4;
        qs[t * dkp + d] = r[0];
        ks[t * dkp + d] = r[1];
        if (pc || d == 0) ls[t * lstep + d * lcol] = clamp_ld(r[2]);
      });
  staged<1, 4>(
      L * DVP,
      [&](int i, float* r) {
        const int t = i / DVP, j = i % DVP;
        r[0] = j < DV ? to_f(v[(t0 + t) * row_v + (long long)h * DV + j])
                      : 0.0f;
      },
      [&](int i, const float* r) { vs[i] = r[0]; });
  __syncthreads();

  if (dm.bonus) {                   // (q * u * k) summed over dk
    for (int t = tid; t < L; t += NT) {
      float acc = 0.0f;
      for (int d = 0; d < DK; ++d)
        acc = fmaf(qs[t * dkp + d] * u[h * DK + d], ks[t * dkp + d], acc);
      bq[t] = acc;
    }
  }
  // cumsum, one dk column a thread (with a scalar decay every column
  // sums the same vector, and column 0 keeps la)
  float* la_out = pc ? kr : lv;
  for (int d = tid; d < DK; d += NT) {
    float la = 0.0f;
    for (int t = 0; t < L; ++t) {
      la = la + ls[t * lstep + d * lcol];
      if (pc || d == 0) la_out[t * lstep + d * lcol] = la;
    }
    le[d] = la;
    decay[d] = expf(la);
  }
  __syncthreads();                  // raw q and k are read; scale in place
  for (int i = tid; i < L * DK; i += NT) {
    const int t = i / DK, d = i % DK;
    const float a = la_out[t * lstep + d * lcol];
    const float a_prev = a - ls[t * lstep + d * lcol];
    const float kk = ks[t * dkp + d];
    qs[t * dkp + d] *= expf(dm.rwkv ? a_prev : a);
    ks[t * dkp + d] = kk * expf(-a);
    kr[t * dkp + d] = kk * expf(le[d] - a);
  }
  __syncthreads();

  // scores: a thread takes rows t, t + half and columns s, s + half, and
  // reads qd and kd four d at a time
  const int half = (L + 1) / 2;
  for (int i = tid; i < half * half; i += NT) {
    const int ta = i / half, sa = i % half;
    const float* q0 = &qs[ta * dkp];
    const float* q1 = &qs[min(ta + half, L - 1) * dkp];
    const float* k0 = &ks[sa * dkp];
    const float* k1 = &ks[min(sa + half, L - 1) * dkp];
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
    for (int d = 0; d < d4; d += 4) {
      const float4 x0 = ld4(q0 + d), x1 = ld4(q1 + d);
      const float4 y0 = ld4(k0 + d), y1 = ld4(k1 + d);
      a00 = fmaf(x0.w, y0.w, fmaf(x0.z, y0.z, fmaf(x0.y, y0.y,
                                                   fmaf(x0.x, y0.x, a00))));
      a01 = fmaf(x0.w, y1.w, fmaf(x0.z, y1.z, fmaf(x0.y, y1.y,
                                                   fmaf(x0.x, y1.x, a01))));
      a10 = fmaf(x1.w, y0.w, fmaf(x1.z, y0.z, fmaf(x1.y, y0.y,
                                                   fmaf(x1.x, y0.x, a10))));
      a11 = fmaf(x1.w, y1.w, fmaf(x1.z, y1.z, fmaf(x1.y, y1.y,
                                                   fmaf(x1.x, y1.x, a11))));
    }
    const float acc[4] = {a00, a01, a10, a11};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int t = ta + half * (x >> 1), s = sa + half * (x & 1);
      if (t >= L || s >= L) continue;
      const bool keep = dm.rwkv ? s < t : s <= t;
      sc[t * L + s] = acc[x] * (keep ? 1.0f : 0.0f);
    }
  }
  __syncthreads();

  // y_intra: a thread takes row t and 4 adjacent columns (float4 reads
  // of v); then k_rem, qd and v go to the scratch for the carry pass
  const int nq = DVP / 4;
  for (int i = tid; i < L * nq; i += NT) {
    const int t = i / nq, j0 = 4 * (i % nq);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int s = 0; s < L; ++s) {
      const float p = sc[t * L + s];
      const float4 w = ld4(&vs[s * DVP + j0]);
      a0 = fmaf(p, w.x, a0);
      a1 = fmaf(p, w.y, a1);
      a2 = fmaf(p, w.z, a2);
      a3 = fmaf(p, w.w, a3);
    }
    float out[4] = {a0, a1, a2, a3};
    if (dm.bonus) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        out[x] = out[x] + bq[t] * vs[t * DVP + j0 + x];
    }
    *reinterpret_cast<float4*>(&sp.yi[t * DVP + j0]) =
        make_float4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<float4*>(&sp.v[t * DVP + j0]) =
        ld4(&vs[t * DVP + j0]);
  }
  for (int i = tid; i < L * d4 / 4; i += NT) {
    const int t = i / (d4 / 4), d = 4 * (i % (d4 / 4));
    float4 r = ld4(&kr[t * dkp + d]);   // k_rem's pad is not set: zero it
    if (d + 4 > DK) {
      r.w = 0.0f;
      if (d + 3 > DK) r.z = 0.0f;
      if (d + 2 > DK) r.y = 0.0f;
    }
    *reinterpret_cast<float4*>(&sp.kr[t * d4 + d]) = r;
    *reinterpret_cast<float4*>(&sp.qd[t * d4 + d]) = ld4(&qs[t * dkp + d]);
  }
}

// Pass B: one block per (b, h, JS columns of dv) walks the chunks in
// order with its (dk, JS) slice of the state in registers, while the next
// chunk's k_rem, qd, v, y_intra and decays are copied in (cp.async).
// For chunk c: y_c = y_intra + qd_c . S_{c-1}, then
// S_c = exp(la_end_c) * S_{c-1} + k_rem_c^T . v_c.

template <int CL, int CDK>
__global__ void __launch_bounds__(NTB)
carry_kernel(const float* __restrict__ s0, const float* __restrict__ scratch,
             float* __restrict__ y, float* __restrict__ sf, Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = CL ? CL : dm.L, DK = CDK ? CDK : dm.DK, DV = dm.DV;
  const int d4 = dk4(DK), DVP = dv64(DV);
  const int stage = stage_floats_b(L, DK);
  const int qdp = d4 + 4, vo = L * d4 + L * qdp;   // qd row stride, v
  float* sS = smem + 2 * stage;     // S_{c-1} as [d4][JS]
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, j0 = blockIdx.y * JS;
  const int b = bh / dm.H, h = bh % dm.H;
  const long long per_head = (long long)DK * DV;
  const long long row_v = (long long)dm.H * DV;

  auto issue = [&](int c, int buf) {
    const Scratch sp = scratch_of(const_cast<float*>(scratch), dm,
                                  (long long)bh * dm.NC + c);
    float* st = smem + buf * stage;
    for (int i = tid; i < L * d4 / 4; i += NTB) {
      const int t = i / (d4 / 4), x = 4 * (i % (d4 / 4));
      cp16(st + 4 * i, sp.kr + 4 * i);
      cp16(st + L * d4 + t * qdp + x, sp.qd + 4 * i);
    }
    for (int i = tid; i < L * JS / 4; i += NTB) {
      const int t = i / (JS / 4), x = 4 * (i % (JS / 4));
      cp16(st + vo + t * JS + x, sp.v + t * DVP + j0 + x);
      cp16(st + vo + L * JS + t * JS + x, sp.yi + t * DVP + j0 + x);
    }
    for (int i = tid; i < d4 / 4; i += NTB)
      cp16(st + vo + 2 * L * JS + 4 * i, sp.decay + 4 * i);
  };

  // a thread holds a 4 x TJ tile of S per group g: rows
  // 4 (tid / NJ + 16 g) + a, columns TJ (tid % NJ) + x of the block's JS
  float S[MAXG][4][TJ];
  const int jq = TJ * (tid % NJ);
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int x = 0; x < TJ; ++x) {
        const int d = 4 * (tid / NJ + 16 * g) + a, j = j0 + jq + x;
        S[g][a][x] = s0 && d < DK && j < DV
            ? s0[(long long)bh * per_head + (long long)d * DV + j] : 0.0f;
      }
  issue(0, 0);
  cp_commit();
  for (int c = 0; c < dm.NC; ++c) {
    if (c + 1 < dm.NC) issue(c + 1, (c + 1) & 1);
    cp_commit();
    cp_wait_prev();                 // chunk c is in
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int d = 4 * (tid / NJ + 16 * g) + a;
        if (d < d4)
          *reinterpret_cast<float2*>(&sS[d * JS + jq]) =
              make_float2(S[g][a][0], S[g][a][1]);
      }
    __syncthreads();
    const float* st = smem + (c & 1) * stage;
    const float* skr = st;
    const float* sqd = st + L * d4;
    const float* sv = st + vo;
    const float* syi = sv + L * JS;
    const float* se = syi + L * JS;
    // y: a thread takes row t and TJ adjacent columns
    for (int o = tid; o < L * NJ; o += NTB) {
      const int t = o / NJ, jo = TJ * (o % NJ);
      float acc0 = 0.0f, acc1 = 0.0f;
      for (int d = 0; d < d4; d += 4) {
        const float4 qv = ld4(&sqd[t * qdp + d]);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 w = *reinterpret_cast<const float2*>(
              &sS[(d + e) * JS + jo]);
          acc0 = fmaf(qa[e], w.x, acc0);
          acc1 = fmaf(qa[e], w.y, acc1);
        }
      }
      float* yrow = y + ((long long)b * dm.S + (long long)c * L + t) * row_v +
                    (long long)h * DV + j0 + jo;
      if (j0 + jo < DV) yrow[0] = syi[t * JS + jo] + acc0;
      if (j0 + jo + 1 < DV) yrow[1] = syi[t * JS + jo + 1] + acc1;
    }
    // S_c = exp(la_end_c) S_{c-1} + k_rem^T v, on the thread's tiles
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const int d0 = 4 * (tid / NJ + 16 * g);
      if (d0 >= d4) continue;
      float acc[4][TJ];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int x = 0; x < TJ; ++x) acc[a][x] = 0.0f;
      for (int t = 0; t < L; ++t) {
        const float4 r = ld4(&skr[t * d4 + d0]);
        const float2 w = *reinterpret_cast<const float2*>(&sv[t * JS + jq]);
        const float ra[4] = {r.x, r.y, r.z, r.w};
        const float wa[TJ] = {w.x, w.y};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int x = 0; x < TJ; ++x)
            acc[a][x] = fmaf(ra[a], wa[x], acc[a][x]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int x = 0; x < TJ; ++x)
          S[g][a][x] = se[d0 + a] * S[g][a][x] + acc[a][x];
    }
    __syncthreads();                // the buffers of chunk c are free
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int x = 0; x < TJ; ++x) {
        const int d = 4 * (tid / NJ + 16 * g) + a, j = j0 + jq + x;
        if (d < DK && j < DV)
          sf[(long long)bh * per_head + (long long)d * DV + j] = S[g][a][x];
      }
}

// the two passes, with the dims compiled in (CL, CDK, CDV) or not (0)
template <typename T, int CL, int CDK, int CDV>
int launch_passes(const void* q, const void* k, const void* v, const void* ld,
                  const void* u, const void* s0, void* y, void* sf,
                  void* scratch, const Dims& dm, cudaStream_t st) {
  const int L = dm.L, DK = dm.DK, DV = dm.DV;
  const size_t smem_a =
      (size_t)smem_floats_a(L, DK, DV, dm.ld_per_channel) * sizeof(float);
  const size_t smem_b = (size_t)smem_floats_b(L, DK) * sizeof(float);
  auto* pass_a = chunk_kernel<T, CL, CDK, CDV>;
  auto* pass_b = carry_kernel<CL, CDK>;
  cudaError_t err = cudaFuncSetAttribute(
      pass_a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      pass_b, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  pass_a<<<dim3(dm.NC, dm.B * dm.H), NT, smem_a, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)ld,
      (const float*)u, (float*)scratch, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pass_b<<<dim3(dm.B * dm.H, (DV + JS - 1) / JS), NTB, smem_b, st>>>(
      (const float*)s0, (const float*)scratch, (float*)y, (float*)sf, dm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ld,
           const void* u, const void* s0, void* y, void* sf, void* scratch,
           int B, int S, int H, int DK, int DV, int L, int rwkv,
           int ld_per_channel, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || DK <= 0 || DV <= 0) return 0;
  if (L <= 0 || S % L != 0 || dk4(DK) > 4 * 16 * MAXG)
    return (int)cudaErrorInvalidValue;
  const Dims dm{B, S, H, DK, DV, L, S / L, rwkv, u != nullptr && rwkv,
                ld_per_channel};
  cudaStream_t st = (cudaStream_t)stream;
  const long long nstate = (long long)B * H * DK * DV;
  if (dm.NC == 0) {                 // no steps: the state passes through
    if (s0) return (int)cudaMemcpyAsync(sf, s0, nstate * sizeof(float),
                                        cudaMemcpyDeviceToDevice, st);
    return (int)cudaMemsetAsync(sf, 0, nstate * sizeof(float), st);
  }
  if (L == 16 && DK == 64 && DV == 64)     // rwkv6-3b's heads and chunk
    return launch_passes<T, 16, 64, 64>(q, k, v, ld, u, s0, y, sf, scratch,
                                        dm, st);
  if (L == 128 && DK == 64 && DV == 64)    // zamba2-1.2b's
    return launch_passes<T, 128, 64, 64>(q, k, v, ld, u, s0, y, sf, scratch,
                                         dm, st);
  return launch_passes<T, 0, 0, 0>(q, k, v, ld, u, s0, y, sf, scratch, dm,
                                   st);
}

}  // namespace

// q, k (B, S, H, DK) and v (B, S, H, DV), contiguous, float32 or bf16;
// ld (B, S, H, DK) or (B, S, H, 1) float32 (unclamped); u (H, DK) float32 or
// null; s0 (B, H, DK, DV) float32 or null (zeros); y (B, S, H, DV) and
// sf (B, H, DK, DV) float32; scratch: B * H * (S / L) chunks of
// scratch_chunk_floats(L, DK, DV) floats, 16-byte aligned. S must be a
// multiple of the chunk L, and DK at most 128.
extern "C" int linear_scan_f32(const void* q, const void* k, const void* v,
                               const void* ld, const void* u, const void* s0,
                               void* y, void* sf, void* scratch, int B, int S,
                               int H, int DK, int DV, int L, int rwkv,
                               int ld_per_channel, int device, void* stream) {
  return launch<float>(q, k, v, ld, u, s0, y, sf, scratch, B, S, H, DK, DV,
                       L, rwkv, ld_per_channel, device, stream);
}

extern "C" int linear_scan_bf16(const void* q, const void* k, const void* v,
                                const void* ld, const void* u, const void* s0,
                                void* y, void* sf, void* scratch, int B,
                                int S, int H, int DK, int DV, int L, int rwkv,
                                int ld_per_channel, int device,
                                void* stream) {
  return launch<__nv_bfloat16>(q, k, v, ld, u, s0, y, sf, scratch, B, S, H,
                               DK, DV, L, rwkv, ld_per_channel, device,
                               stream);
}
