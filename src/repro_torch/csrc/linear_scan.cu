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
// Float32 throughout: on the CUDA cores at chunks up to 64, and at longer
// chunks on the tensor cores in 3xTF32 (each operand split into a TF32
// high part and its remainder, a_hi b_hi + a_hi b_lo + a_lo b_hi summed in
// float32: about float32's accuracy, where plain TF32 would not meet the
// 1e-4 tolerance); q, k, v are read in float32 or bf16 and widened; expf,
// IEEE arithmetic, built with -fmad=false.
//
// Two passes on the caller's stream, one C entry:
//   A. one block per (b, h, c), all chunks at once: decays, qd, kd, k_rem,
//      the masked scores and y_c's intra-chunk part (with the bonus). It
//      writes k_rem, qd, v (as float32) and y_intra of the chunk, and
//      exp(la_end_c), to a scratch the wrapper allocates.
//      Chunks up to 64 (rwkv6-3b's 16): a thread computes a small tile of
//      outputs (2x2 scores, 1x4 of y_intra) from float4 reads of shared
//      memory and issues all its global loads of a phase before it stores
//      any (staged()).
//      Chunks above 64 (zamba2-1.2b's 128), chunk_kernel_mma: there the
//      earlier design (the layout above at L = 128) held one block of 8
//      warps an SM (204,544 B of shared memory, an [L][L] score buffer
//      among it), computed all L^2 scores and zeroed the masked half
//      afterwards, summed y_intra over the masked zeros too, and read
//      shared memory four times for every 16 FMAs: 300.9 us of pass A at
//      zamba2's prefill against a 32.7 us bound (operations). Now each
//      warp takes 16-row tiles of the chunk and forms its scores 16 x 8 at
//      a time on the tensor cores (mma.sync m16n8k8, 3xTF32), masks them
//      in registers and multiplies them straight into its y_intra sums, as
//      flash does with P: no [L][L] buffer. Tiles wholly above the
//      diagonal are skipped (72 of the 128 score blocks are formed at L =
//      128) unless the chunk overflows: there the reference's masked inf *
//      0 turns whole rows NaN, so such a chunk forms every tile. qd and
//      k_rem go to the scratch as they are formed; v takes the log-decay's
//      area once that is spent: 107,024 B at (128, 64, 64), per-channel
//      decay too, so two blocks fit an SM. The cumsum runs in step order,
//      a column a thread, as the reference adds it (a tree order moved la
//      by a few ulps at |la| ~ 48 and the outputs by ~1e-4).
//   B. one block per (b, h, 16 dv columns) walks the chunks in order with
//      its (dk, 16) slice of the state in registers (a 4 x 2 tile a
//      thread): y_c = y_intra + qd_c . S_{c-1}, then
//      S_c = exp(la_end_c) * S_{c-1} + k_rem_c^T . v_c, while the next
//      piece of the scratch (at most 64 rows of a chunk) is copied into
//      shared memory (cp.async, two stages). Only this recurrence runs in
//      chunk order.
// Both passes are also compiled with rwkv6-3b's and zamba2-1.2b's chunk
// and head dims ((16, 64, 64) and (128, 64, 64)) fixed, which the launcher
// picks for those shapes: the index arithmetic folds and the loops unroll.
//
// Bound on the H100: at the rwkv6-3b prefill (B = 2, S = 512, 40 heads,
// dk = dv = 64, chunk 16) inputs and outputs are 38 MB (11.4 us, the
// bound) and the masked products 0.77 GFLOP (4.1 us at the 3xTF32 rate;
// 11.5 us on the CUDA cores, where this chunk runs them). The scratch,
// B * H * (S / L) * (2 L dk + 2 L dv + dk) floats (42 MB here), is written
// once and read once (k_rem and qd by each of the dv / 16 blocks of a
// head, mostly from L2). Pass B's time is its chunk chain: about 2 us a
// chunk, set neither by its loads (four stages in flight did not help)
// nor by the work a thread does (halving it did not help). Earlier
// designs measured slower: three passes (the state increments to scratch,
// the recurrence elementwise, then qd . S per chunk), which moved four
// times the scratch, and a chunk-ordered pass that waited on its loads.
// At zamba2's prefill (B = 2, S = 512, 64 heads, chunk 128) the bound is
// 13.2 us, its 44 MB of inputs and outputs (its 2.19 GFLOP take 11.4 us,
// the products at the 3xTF32 rate); pass A reads 25 MB and writes 67 MB
// of scratch (27 us at the card's rate). The tensor-core pass A took 67.4
// us there, its phases (tools/scan_passes.py --phases, each up to its
// end): the q, k and decay loads with the cumsum 9.9, qd, kd and k_rem
// written 15.8 more, v 11.6 more (these move data at ~2 TB/s), the
// products and y_intra 30.1 more. 16-byte loads and a row's exps taken once cut the
// first phases from 23.8, 30.5 and 18.4 us; the cumsum in step order and
// the rounded remainders cost ~4 us and took the largest error against
// the plain version at zamba2's shapes from ~1e-4 to ~1.5e-5.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int NT = 256;
constexpr int JS = 16;              // dv columns per block of pass B
constexpr int NTB = 128;            // threads of pass B
constexpr int TJ = 2;               // state columns a thread of pass B holds
constexpr int NJ = JS / TJ;         // threads across one row of the slice
constexpr int MAXG = 2;             // 4-row groups of S a thread: dk <= 128
constexpr int PB = 64;              // rows of a chunk pass B copies at once

// Stops that time the tensor-core pass A in parts: built with
// -DSCAN_STOP_AT=n (tools/scan_passes.py --phases), it returns at stop n;
// its outputs are then wrong. Without it the stops are empty.
#ifdef SCAN_STOP_AT
#define SCAN_STOP(n) if ((n) == SCAN_STOP_AT) return
#else
#define SCAN_STOP(n)
#endif

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
__host__ __device__ inline int smem_floats_a(int L, int DK, int DV) {
  // q/qd, k/kd, la/k_rem and the clamped log-decay (a scalar one
  // broadcast over dk): [L][dkp]; v [L][dv64]; scores [L][L]; bonus [L];
  // la_end [DK]
  return 4 * L * dk_stride(DK) + L * dv64(DV) + r4(L * L + L + DK);
}
__host__ __device__ inline int stage_floats_b(int L, int DK) {
  // k_rem [L][dk4]; qd [L][dk4 + 4] (rows shifted by 4 banks); v, y_intra
  // [L][JS]; decay [dk4]
  return L * dk4(DK) + L * (dk4(DK) + 4) + 2 * L * JS + dk4(DK);
}
// pass B copies a chunk in pieces of at most PB rows
__host__ __device__ inline int piece_rows(int L) { return L < PB ? L : PB; }
__host__ __device__ inline int smem_floats_b(int L, int DK) {
  return 2 * stage_floats_b(piece_rows(L), DK) + dk4(DK) * JS;  // 2 stages, S
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

// Pass A at chunks up to 64: the state-free terms of one chunk, for all
// chunks at once, on the CUDA cores.
template <typename T, int CL, int CDK, int CDV>
__global__ void __launch_bounds__(NT, 8)
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
  float* kr = ks + L * dkp;         // la, then k_rem
  float* vs = kr + L * dkp;         // [L][DVP]
  float* sc = vs + L * DVP;         // [L][L]
  float* bq = sc + L * L;           // [L]
  float* le = bq + L;               // [DK] la_end
  float* ls = sc + r4(L * L + L + DK);   // [L][dkp] clamped log-decay

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
        r[2] = in ? ld[(t0 + t) * dm.H * ldw + (long long)h * ldw +
                       (pc ? d : 0)]
                  : 0.0f;
      },
      [&](int i, const float* r) {
        const int t = i / d4, d = i % d4;
        qs[t * dkp + d] = r[0];
        ks[t * dkp + d] = r[1];
        ls[t * dkp + d] = clamp_ld(r[2]);
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
  // cumsum, one dk column a thread, into kr
  for (int d = tid; d < DK; d += NT) {
    float la = 0.0f;
    for (int t = 0; t < L; ++t) {
      la = la + ls[t * dkp + d];
      kr[t * dkp + d] = la;
    }
    le[d] = la;
    decay[d] = expf(la);
  }
  __syncthreads();                  // raw q and k are read; scale in place
  for (int i = tid; i < L * DK; i += NT) {
    const int t = i / DK, d = i % DK;
    const float a = kr[t * dkp + d];
    const float a_prev = a - ls[t * dkp + d];
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

// ---------------------------------------------------------------------------
// Pass A at chunks above 64 (zamba2's 128): the products on the tensor
// cores in 3xTF32, only the tiles on or below the diagonal, no score
// matrix in shared memory.
// ---------------------------------------------------------------------------

constexpr int RT = 16;              // rows of a warp's tile (mma m16)
constexpr int SB = 8;               // columns of a block of scores (mma n8)
constexpr int NG = 64;              // dv columns a warp accumulates at once

__host__ __device__ inline int r8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ inline int r16(int n) { return (n + 15) / 16 * 16; }
// rows of the mma operands in shared memory: d rounded up to 8 (zeros in
// the pad, so the k-steps add exact zeros) plus 4, so that the fragment
// reads of a warp, rows g = 0..7 (or 2 t) and columns t = 0..3 (or g),
// fall on 32 distinct banks
__host__ __device__ inline int mma_stride(int d) { return r8(d) + 4; }

// shared floats of the tensor-core pass A: q then qd, k then kd as
// [Lp][sk]; the clamped per-channel log-decay, then v, in a third
// [Lp][max(sk, sv)] area; the scalar log-decay and its cumsum, the bonus
// term, la_end per column and the chunk's flags
__host__ __device__ inline int smem_floats_mma(int L, int DK, int DV,
                                               int ld_per_channel) {
  const int Lp = r16(L), sk = mma_stride(DK), sv = mma_stride(DV);
  const int third = ld_per_channel && sk > sv ? Lp * sk : Lp * sv;
  return 2 * Lp * sk + third + r4(3 * Lp) + NT + 4;
}

// A warp's rows [r0, r0 + 16) of y_intra, columns [n0, n0 + 8 nt): the
// scores of s-blocks 0 .. nsb - 1 (an even count) formed two 16 x 8 tiles
// at a time in registers (their sums are independent chains, and the A
// fragment of qd is read and split once for both), in 3xTF32 (a_hi b_hi +
// a_hi b_lo + a_lo b_hi, the small terms summed apart), masked, and
// multiplied straight into the sums (as flash does with P). The score
// tile's accumulator layout (row g or g + 8, columns 2t, 2t + 1) is taken
// as the A fragment of the next product with its k index permuted
// (column t <-> s 2t, t + 4 <-> 2t + 1), so the B fragment reads v's rows
// 2t and 2t + 1: no shuffle. v widened from bf16 is exact in TF32 (its
// remainder is 0): two products, not three.
template <bool EXACT, bool V_EXACT>
__device__ __forceinline__ void y_tile(float (*acc)[4], const float* qs,
                                       const float* ks, const float* vs,
                                       int sk, int sv, int DK8, int L,
                                       int r0, int n0, int nt, int nsb,
                                       bool rwkv, int g, int t) {
  const int row0 = r0 + g, row1 = r0 + g + 8;
  for (int sb = 0; sb < nsb; sb += 2) {
    float big[2][4] = {}, small[2][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < DK8; kk += 8) {
      const float a[4] = {qs[row0 * sk + kk + t], qs[row1 * sk + kk + t],
                          qs[row0 * sk + kk + t + 4],
                          qs[row1 * sk + kk + t + 4]};
      uint32_t ah[4], al[4], ax[4];
      split_n<EXACT, 4>(a, ah, al, ax);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* kr = ks + ((sb + e) * SB + g) * sk + kk + t;
        const float b[2] = {kr[0], kr[4]};
        uint32_t bh[2], bl[2], bx[2];
        split_n<EXACT, 2>(b, bh, bl, bx);
        mma_tf32(small[e], al, bx);
        mma_tf32(small[e], ax, bl);
        mma_tf32(big[e], ah, bh);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s0 = (sb + e) * SB;
      // the 0/1 mask as a product, as the reference applies it; columns
      // past the chunk (padding to the 16-row tiles) are 0 outright
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tr = i < 2 ? row0 : row1, sc = s0 + 2 * t + (i & 1);
        const bool keep = rwkv ? sc < tr : sc <= tr;
        p[i] = sc < L ? (big[e][i] + small[e][i]) * (keep ? 1.0f : 0.0f)
                      : 0.0f;
      }
      // A fragment: (g, t) <- (g, 2t), (g + 8, t) <- (g + 8, 2t),
      // (g, t + 4) <- (g, 2t + 1), (g + 8, t + 4) <- (g + 8, 2t + 1)
      const float pa[4] = {p[0], p[2], p[1], p[3]};
      uint32_t ph[4], pl[4], px[4];
      split_n<EXACT, 4>(pa, ph, pl, px);
      const float* v0 = vs + (s0 + 2 * t) * sv + n0 + g;
      const float* v1 = v0 + sv;
#pragma unroll
      for (int n = 0; n < NG / 8; ++n) {
        if (n >= nt) break;
        const float b[2] = {v0[8 * n], v1[8 * n]};
        uint32_t bh[2], bl[2] = {0u, 0u}, bx[2];
        if (V_EXACT) {           // exact in TF32: no remainder
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            bh[i] = __float_as_uint(b[i]);
            bx[i] = EXACT && !isfinite(b[i]) ? 0u : bh[i];
          }
        } else {
          split_n<EXACT, 2>(b, bh, bl, bx);
        }
        mma_tf32(acc[n], pl, bx);
        if (!V_EXACT) mma_tf32(acc[n], px, bl);
        mma_tf32(acc[n], ph, bh);
      }
    }
  }
}

// 16 bytes of T from global memory (16-byte aligned) as floats
__device__ __forceinline__ void load16(const float* p, float* r) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* r) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[2 * i] = __uint_as_float(w[i] << 16);          // bf16 -> float
    r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// n floats (a multiple of 4) to 16-byte-aligned memory
template <int N>
__device__ __forceinline__ void store_n(float* p, const float* r) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(r[i], r[i + 1],
                                                    r[i + 2], r[i + 3]);
}
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Pass A at chunks above 64: one block of 8 warps per (b, h, c). q, k and
// the log-decay are loaded; the cumsum, qd, kd and k_rem are formed, qd
// and k_rem written to the scratch as they are formed; v is loaded into
// the log-decay's area (and written to the scratch as float32); then each
// warp takes 16-row tiles of the chunk and forms its y_intra on the
// tensor cores. Tiles wholly above the diagonal are skipped when the
// chunk's qd, kd and v are finite and no masked product can overflow
// (dk * max|qd| * max|kd| < 1e37): a skipped score is then an exact 0 in
// the reference too. Otherwise (an overflowed chunk, or non-finite input)
// every tile is formed and masked by the 0/1 product, with the exact
// split, so the chunk keeps the reference's NaN: a masked inf * 0 makes a
// whole row NaN there.
template <typename T, int CL, int CDK, int CDV>
__global__ void __launch_bounds__(NT, 2)
chunk_kernel_mma(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ld,
                 const float* __restrict__ u, float* __restrict__ scratch,
                 Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = CL ? CL : dm.L, DK = CDK ? CDK : dm.DK;
  const int DV = CDV ? CDV : dm.DV, DVP = dv64(DV);
  const int Lp = r16(L), DK8 = r8(DK), DV8 = r8(DV), d4 = dk4(DK);
  const int sk = mma_stride(DK), sv = mma_stride(DV);
  const bool pc = dm.ld_per_channel;
  float* qs = smem;                   // q, then qd   [Lp][sk]
  float* ks = qs + Lp * sk;           // k, then kd   [Lp][sk]
  float* x3 = ks + Lp * sk;           // log-decay [Lp][sk], then v [Lp][sv]
  const int third = pc && sk > sv ? Lp * sk : Lp * sv;
  float* ls = x3 + third;             // [Lp] scalar log-decay
  float* la = ls + Lp;                // [Lp] its cumsum
  float* bq = la + Lp;                // [Lp] bonus term
  float* tot = ls + r4(3 * Lp);       // [NT] la_end per column
  unsigned* flags = reinterpret_cast<unsigned*>(tot + NT);
                                      // max|qd|, max|kd|, non-finite

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / dm.H, h = bh % dm.H;
  const long long t0 = (long long)b * dm.S + (long long)c * L;
  const long long row_qk = (long long)dm.H * DK;
  const long long row_v = (long long)dm.H * DV;
  const Scratch sp = scratch_of(scratch, dm, (long long)bh * dm.NC + c);
  if (tid < 3) flags[tid] = 0u;
  for (int d = DK + tid; d < d4; d += NT) sp.decay[d] = 0.0f;

  // q, k (zeros in the pads) and the clamped log-decay: 16 bytes a load
  // where the dims and pointers allow, else element by element; a thread
  // issues all its loads of a batch before it stores any (staged())
  constexpr int VW = 16 / sizeof(T);  // elements of q, k, v in 16 bytes
  const bool vec = DK % 8 == 0 && DV % 8 == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v) && (!pc || aligned16(ld));
  const int ldw = pc ? DK : 1;
  if (vec) {
    const int nvr = DK / VW;
    staged<2 * VW, 4>(
        L * nvr,
        [&](int i, float* r) {
          const int t = i / nvr, d = VW * (i % nvr);
          const long long o = (t0 + t) * row_qk + (long long)h * DK + d;
          load16(q + o, r);
          load16(k + o, r + VW);
        },
        [&](int i, const float* r) {
          const int t = i / nvr, d = VW * (i % nvr);
          store_n<VW>(qs + t * sk + d, r);
          store_n<VW>(ks + t * sk + d, r + VW);
        });
    if (pc) {
      staged<4, 4>(
          L * DK / 4,
          [&](int i, float* r) {
            const int t = i / (DK / 4), d = 4 * (i % (DK / 4));
            load16(ld + (t0 + t) * row_qk + (long long)h * DK + d, r);
#pragma unroll
            for (int e = 0; e < 4; ++e) r[e] = clamp_ld(r[e]);
          },
          [&](int i, const float* r) {
            const int t = i / (DK / 4), d = 4 * (i % (DK / 4));
            store_n<4>(x3 + t * sk + d, r);
          });
    } else {
      for (int t = tid; t < L; t += NT)
        ls[t] = clamp_ld(ld[(t0 + t) * dm.H + h]);
    }
    for (int i = tid; i < (Lp - L) * sk; i += NT) {   // the pad rows
      qs[L * sk + i] = 0.0f;
      ks[L * sk + i] = 0.0f;
    }
  } else {
    staged<3, 4>(
        Lp * DK8,
        [&](int i, float* r) {
          const int t = i / DK8, d = i % DK8;
          const long long o = (t0 + t) * row_qk + (long long)h * DK + d;
          const bool in = t < L && d < DK;
          r[0] = in ? to_f(q[o]) : 0.0f;
          r[1] = in ? to_f(k[o]) : 0.0f;
          r[2] = in && (pc || d == 0)
                     ? clamp_ld(ld[(t0 + t) * dm.H * ldw +
                                   (long long)h * ldw + (pc ? d : 0)])
                     : 0.0f;
        },
        [&](int i, const float* r) {
          const int t = i / DK8, d = i % DK8;
          qs[t * sk + d] = r[0];
          ks[t * sk + d] = r[1];
          if (pc) x3[t * sk + d] = r[2];
          else if (d == 0) ls[t] = r[2];
        });
  }
  __syncthreads();

  if (dm.bonus) {                     // (q * u * k) summed over dk
    for (int t = tid; t < L; t += NT) {
      float acc = 0.0f;
      for (int d = 0; d < DK; ++d)
        acc = fmaf(qs[t * sk + d] * u[h * DK + d], ks[t * sk + d], acc);
      bq[t] = acc;
    }
  }
  // cumsum in step order, one column a thread (a scalar decay: one
  // column), as the reference's cumsum adds: la bit for bit, so that
  // exp(la) and exp(-la) carry no rounding of their own. la goes in place
  // of the log-decay (per channel) or into la[] (scalar); la_end per
  // column into tot[]
  for (int d = tid; d < (pc ? DK : 1); d += NT) {
    float* col = pc ? x3 + d : ls;
    float* out = pc ? x3 + d : la;
    const int step = pc ? sk : 1;
    float run = 0.0f;
    for (int ta = 0; ta < L; ta += 8) {   // 8 loads in flight, then adds
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = ta + e < L ? col[(ta + e) * step] : 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (ta + e < L) {
          run = run + x[e];
          out[(ta + e) * step] = run;
        }
      }
    }
    tot[d] = run;
  }
  __syncthreads();
  for (int d = tid; d < DK; d += NT) sp.decay[d] = expf(tot[pc ? d : 0]);

  SCAN_STOP(1);
  float mq = 0.0f, mk = 0.0f;         // max |qd|, |kd| of this thread's
  bool bad = false;                   // any of them not finite
  auto seen_qk = [&](float qd, float kd) {
    bad = bad || !isfinite(qd) || !isfinite(kd);
    mq = fmaxf(mq, fabsf(qd));
    mk = fmaxf(mk, fabsf(kd));
  };
  // the log-decay at (t, d), clamped: rwkv's la_prev = la - ld (per
  // channel read again, its area holds la now)
  auto ld_at = [&](int t, int d) {
    return pc ? clamp_ld(ld[(t0 + t) * row_qk + (long long)h * DK + d])
              : ls[t];
  };
  // qd, kd in place; qd and k_rem to the scratch
  if (vec) {                          // 4 columns of a row a thread
    const int nq = DK / 4;
    for (int i = tid; i < L * nq; i += NT) {
      const int t = i / nq, d = 4 * (i % nq);
      const float4 q4 = ld4(qs + t * sk + d), k4 = ld4(ks + t * sk + d);
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
      const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
      float qd[4], kd[4], kr[4];
      if (pc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = x3[t * sk + d + e];
          qd[e] = qv[e] * expf(dm.rwkv ? a - ld_at(t, d + e) : a);
          kd[e] = kv[e] * expf(-a);
          kr[e] = kv[e] * expf(tot[d + e] - a);
        }
      } else {                        // a row's three exps taken once
        const float a = la[t];
        const float eq = expf(dm.rwkv ? a - ls[t] : a), ek = expf(-a);
        const float er = expf(tot[0] - a);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qd[e] = qv[e] * eq;
          kd[e] = kv[e] * ek;
          kr[e] = kv[e] * er;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) seen_qk(qd[e], kd[e]);
      store_n<4>(qs + t * sk + d, qd);
      store_n<4>(ks + t * sk + d, kd);
      store_n<4>(sp.qd + t * d4 + d, qd);
      store_n<4>(sp.kr + t * d4 + d, kr);
    }
  } else {
    for (int i = tid; i < L * d4; i += NT) {
      const int t = i / d4, d = i % d4;
      if (d < DK) {
        const float a = pc ? x3[t * sk + d] : la[t];
        const float kk = ks[t * sk + d];
        const float qd = qs[t * sk + d] * expf(dm.rwkv ? a - ld_at(t, d) : a);
        const float kd = kk * expf(-a);
        qs[t * sk + d] = qd;
        ks[t * sk + d] = kd;
        sp.qd[t * d4 + d] = qd;
        sp.kr[t * d4 + d] = kk * expf(tot[pc ? d : 0] - a);
        seen_qk(qd, kd);
      } else {                        // the scratch's pads
        sp.qd[t * d4 + d] = 0.0f;
        sp.kr[t * d4 + d] = 0.0f;
      }
    }
  }
  __syncthreads();                    // the log-decay's area is free

  SCAN_STOP(2);
  // v into the third area (zeros in the pads) and to the scratch
  float mv = 0.0f;
  auto seen = [&](float x) {
    bad = bad || !isfinite(x);
    mv = fmaxf(mv, fabsf(x));
  };
  if (vec) {
    const int nvr = DV / VW;
    staged<VW, 4>(
        L * nvr,
        [&](int i, float* r) {
          const int t = i / nvr, j = VW * (i % nvr);
          load16(v + (t0 + t) * row_v + (long long)h * DV + j, r);
        },
        [&](int i, const float* r) {
          const int t = i / nvr, j = VW * (i % nvr);
          store_n<VW>(x3 + t * sv + j, r);
          store_n<VW>(sp.v + t * DVP + j, r);
#pragma unroll
          for (int e = 0; e < VW; ++e) seen(r[e]);
        });
    for (int i = tid; i < (Lp - L) * sv; i += NT) x3[L * sv + i] = 0.0f;
    for (int i = tid; i < L * (DVP - DV); i += NT) {   // the scratch's pads
      const int t2 = i / (DVP - DV), j = DV + i % (DVP - DV);
      sp.v[t2 * DVP + j] = 0.0f;
    }
  } else {
    staged<1, 4>(
        Lp * DVP,
        [&](int i, float* r) {
          const int t = i / DVP, j = i % DVP;
          r[0] = t < L && j < DV
                     ? to_f(v[(t0 + t) * row_v + (long long)h * DV + j])
                     : 0.0f;
        },
        [&](int i, const float* r) {
          const int t = i / DVP, j = i % DVP;
          if (j < DV8) x3[t * sv + j] = r[0];
          if (t < L) sp.v[t * DVP + j] = r[0];
          seen(r[0]);
        });
  }
  // the chunk's maxima and flag (non-negative floats order as their bits)
  const unsigned wq = __reduce_max_sync(0xffffffffu, __float_as_uint(mq));
  const unsigned wk = __reduce_max_sync(0xffffffffu, __float_as_uint(mk));
  const unsigned wv = __reduce_max_sync(0xffffffffu, __float_as_uint(mv));
  const unsigned wb = __reduce_or_sync(0xffffffffu, bad ? 1u : 0u);
  if (lane == 0) {
    atomicMax(&flags[0], wq);
    atomicMax(&flags[1], wk);
    atomicOr(&flags[2], wb | (wv > __float_as_uint(1e38f) ? 1u : 0u));
  }
  __syncthreads();
  const float fq = __uint_as_float(flags[0]), fk = __uint_as_float(flags[1]);
  const bool skip = flags[2] == 0u && fq <= 1e38f && fk <= 1e38f &&
                    (float)DK8 * fq * fk < 1e37f;

  SCAN_STOP(3);
  // y_intra: warp w takes the 16-row tiles w, w + 8, ...; the bonus term
  // is added and the tile written to the scratch
  const int g = lane >> 2, t4 = lane & 3;
  constexpr bool V_EXACT = sizeof(T) == 2;
  for (int rt = warp; rt < Lp / RT; rt += NT / 32) {
    const int r0 = rt * RT;
    const int nsb = skip ? min(Lp / SB, (r0 + RT) / SB) : Lp / SB;
    for (int n0 = 0; n0 < DV8; n0 += NG) {
      float acc[NG / 8][4];
#pragma unroll
      for (int n = 0; n < NG / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
      const int nt = min(NG, DV8 - n0) / 8;
      if (skip)
        y_tile<false, V_EXACT>(acc, qs, ks, x3, sk, sv, DK8, L, r0, n0, nt,
                               nsb, dm.rwkv, g, t4);
      else
        y_tile<true, V_EXACT>(acc, qs, ks, x3, sk, sv, DK8, L, r0, n0, nt,
                              nsb, dm.rwkv, g, t4);
#pragma unroll
      for (int n = 0; n < NG / 8; ++n) {
        if (n >= nt) break;
        const int col = n0 + 8 * n + 2 * t4;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r0 + g + 8 * hf;
          if (row >= L) continue;
          float o0 = acc[n][2 * hf], o1 = acc[n][2 * hf + 1];
          if (dm.bonus) {
            o0 = o0 + bq[row] * x3[row * sv + col];
            o1 = o1 + bq[row] * x3[row * sv + col + 1];
          }
          *reinterpret_cast<float2*>(&sp.yi[row * DVP + col]) =
              make_float2(o0, o1);
        }
      }
    }
  }
  for (int i = tid; i < L * (DVP - DV8); i += NT) {   // y_intra's pads
    const int t = i / (DVP - DV8), j = DV8 + i % (DVP - DV8);
    sp.yi[t * DVP + j] = 0.0f;
  }
}

// Pass B: one block per (b, h, JS columns of dv) walks the chunks in
// order with its (dk, JS) slice of the state in registers, while the next
// piece of the scratch (k_rem, qd, v, y_intra and decays of at most PB
// rows of a chunk) is copied in (cp.async). For chunk c:
// y_c = y_intra + qd_c . S_{c-1}, then
// S_c = exp(la_end_c) * S_{c-1} + k_rem_c^T . v_c, the sum taken over the
// pieces in row order. Pieces of 64 rows keep a chunk of 128 to 88,576 B
// at dk = 64 (two blocks an SM, where whole chunks took 172,544 B and one)
// and let dk = 128 fit at that chunk.

template <int CL, int CDK>
__global__ void __launch_bounds__(NTB)
carry_kernel(const float* __restrict__ s0, const float* __restrict__ scratch,
             float* __restrict__ y, float* __restrict__ sf, Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = CL ? CL : dm.L, DK = CDK ? CDK : dm.DK, DV = dm.DV;
  const int d4 = dk4(DK), DVP = dv64(DV);
  const int PL = piece_rows(L), NP = (L + PL - 1) / PL;
  const int stage = stage_floats_b(PL, DK);
  const int qdp = d4 + 4, vo = PL * d4 + PL * qdp;   // qd row stride, v
  float* sS = smem + 2 * stage;     // S_{c-1} as [d4][JS]
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, j0 = blockIdx.y * JS;
  const int b = bh / dm.H, h = bh % dm.H;
  const long long per_head = (long long)DK * DV;
  const long long row_v = (long long)dm.H * DV;

  // piece `it` (chunk it / NP, rows from PL * (it % NP)) into stage buf
  auto issue = [&](int it, int buf) {
    const int c = it / NP, r0 = PL * (it % NP), rows = min(PL, L - r0);
    const Scratch sp = scratch_of(const_cast<float*>(scratch), dm,
                                  (long long)bh * dm.NC + c);
    float* st = smem + buf * stage;
    const float* kr = sp.kr + r0 * d4;
    const float* qd = sp.qd + r0 * d4;
    for (int i = tid; i < rows * d4 / 4; i += NTB) {
      const int t = i / (d4 / 4), x = 4 * (i % (d4 / 4));
      cp16(st + 4 * i, kr + 4 * i);
      cp16(st + PL * d4 + t * qdp + x, qd + 4 * i);
    }
    for (int i = tid; i < rows * JS / 4; i += NTB) {
      const int t = i / (JS / 4), x = 4 * (i % (JS / 4));
      cp16(st + vo + t * JS + x, sp.v + (r0 + t) * DVP + j0 + x);
      cp16(st + vo + PL * JS + t * JS + x, sp.yi + (r0 + t) * DVP + j0 + x);
    }
    for (int i = tid; i < d4 / 4; i += NTB)
      cp16(st + vo + 2 * PL * JS + 4 * i, sp.decay + 4 * i);
  };

  // a thread holds a 4 x TJ tile of S per group g: rows
  // 4 (tid / NJ + 16 g) + a, columns TJ (tid % NJ) + x of the block's JS
  float S[MAXG][4][TJ], acc[MAXG][4][TJ];
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
  for (int it = 0; it < dm.NC * NP; ++it) {
    const int c = it / NP, p = it % NP, r0 = PL * p, rows = min(PL, L - r0);
    if (it + 1 < dm.NC * NP) issue(it + 1, (it + 1) & 1);
    cp_commit();
    cp_wait_prev();                 // piece it is in
    if (p == 0) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int d = 4 * (tid / NJ + 16 * g) + a;
          if (d < d4)
            *reinterpret_cast<float2*>(&sS[d * JS + jq]) =
                make_float2(S[g][a][0], S[g][a][1]);
#pragma unroll
          for (int x = 0; x < TJ; ++x) acc[g][a][x] = 0.0f;
        }
    }
    __syncthreads();
    const float* st = smem + (it & 1) * stage;
    const float* skr = st;
    const float* sqd = st + PL * d4;
    const float* sv = st + vo;
    const float* syi = sv + PL * JS;
    const float* se = syi + PL * JS;
    // y: a thread takes row t and TJ adjacent columns
    for (int o = tid; o < rows * NJ; o += NTB) {
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
      float* yrow = y + ((long long)b * dm.S + (long long)c * L + r0 + t) *
                            row_v + (long long)h * DV + j0 + jo;
      if (j0 + jo < DV) yrow[0] = syi[t * JS + jo] + acc0;
      if (j0 + jo + 1 < DV) yrow[1] = syi[t * JS + jo + 1] + acc1;
    }
    // k_rem^T v over the piece's rows, on the thread's tiles; at the
    // chunk's last piece S_c = exp(la_end_c) S_{c-1} + the sum
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const int d0 = 4 * (tid / NJ + 16 * g);
      if (d0 >= d4) continue;
      for (int t = 0; t < rows; ++t) {
        const float4 r = ld4(&skr[t * d4 + d0]);
        const float2 w = *reinterpret_cast<const float2*>(&sv[t * JS + jq]);
        const float ra[4] = {r.x, r.y, r.z, r.w};
        const float wa[TJ] = {w.x, w.y};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int x = 0; x < TJ; ++x)
            acc[g][a][x] = fmaf(ra[a], wa[x], acc[g][a][x]);
      }
      if (p == NP - 1) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int x = 0; x < TJ; ++x)
            S[g][a][x] = se[d0 + a] * S[g][a][x] + acc[g][a][x];
      }
    }
    __syncthreads();                // the buffers of piece it are free
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

// shared bytes of each pass
inline int smem_bytes_a(const Dims& dm) {
  return 4 * (dm.L > 64 ? smem_floats_mma(dm.L, dm.DK, dm.DV,
                                          dm.ld_per_channel)
                        : smem_floats_a(dm.L, dm.DK, dm.DV));
}
inline int smem_bytes_b(const Dims& dm) {
  return 4 * smem_floats_b(dm.L, dm.DK);
}

template <typename T, typename K>
int run_pass_a(K kernel, const void* q, const void* k, const void* v,
               const void* ld, const void* u, void* scratch, const Dims& dm,
               cudaStream_t st) {
  const int smem = smem_bytes_a(dm);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(dm.NC, dm.B * dm.H), NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)ld,
      (const float*)u, (float*)scratch, dm);
  return (int)cudaGetLastError();
}

// pass A: the tensor-core kernel at chunks above 64, the CUDA-core one at
// the others; rwkv6-3b's (16, 64, 64) and zamba2-1.2b's (128, 64, 64)
// chunk and head dims compiled in
template <typename T>
int launch_pass_a(const void* q, const void* k, const void* v,
                  const void* ld, const void* u, void* scratch,
                  const Dims& dm, cudaStream_t st) {
  const bool h64 = dm.DK == 64 && dm.DV == 64;
  if (dm.L == 16 && h64)
    return run_pass_a<T>(chunk_kernel<T, 16, 64, 64>, q, k, v, ld, u,
                         scratch, dm, st);
  if (dm.L == 128 && h64)
    return run_pass_a<T>(chunk_kernel_mma<T, 128, 64, 64>, q, k, v, ld, u,
                         scratch, dm, st);
  if (dm.L > 64)
    return run_pass_a<T>(chunk_kernel_mma<T, 0, 0, 0>, q, k, v, ld, u,
                         scratch, dm, st);
  return run_pass_a<T>(chunk_kernel<T, 0, 0, 0>, q, k, v, ld, u, scratch,
                       dm, st);
}

int launch_pass_b(const void* s0, const void* scratch, void* y, void* sf,
                  const Dims& dm, cudaStream_t st) {
  const bool h64 = dm.DK == 64 && dm.DV == 64;
  auto* kernel = dm.L == 16 && h64    ? carry_kernel<16, 64>
                 : dm.L == 128 && h64 ? carry_kernel<128, 64>
                                      : carry_kernel<0, 0>;
  const int smem = smem_bytes_b(dm);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(dm.B * dm.H, (dm.DV + JS - 1) / JS), NTB, smem, st>>>(
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
  const int rc = launch_pass_a<T>(q, k, v, ld, u, scratch, dm, st);
  if (rc != 0) return rc;
  return launch_pass_b(s0, scratch, y, sf, dm, st);
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
