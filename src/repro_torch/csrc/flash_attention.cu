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
// over 3.35 TB/s = 295), so the card's bound is the bytes, ~5 us.
//
// Two kernels, one entry each; the wrapper picks by dtype.
//
// bf16 (flash_tc_kernel): both products on the tensor cores with wgmma.
// One block per (b, h, 128-row q tile): two warpgroups, each owning 64 q
// rows (wgmma's M), longest causal rows first; registers capped so that two
// blocks share an SM (64-row tiles and one block per SM both measured
// slower: tools/flash_tile_variants.py). Q is copied once into shared
// memory; K/V tiles of 64 rows go through a two-stage ring filled with
// cp.async (16 bytes a thread, zero-filled past Sk), so tile t+1's copy
// runs while tile t's products do. S = Q.K^T is wgmma m64n64k16 with both
// operands K-major in shared memory and the float32 accumulator in
// registers; mask, scale and the online softmax run on that accumulator in
// place (each row lives in 4 lanes: max and sum take two shuffles); a tile
// that the whole warpgroup sees unmasked skips the mask. P is split into
// two bf16 parts in registers, already in wgmma's A-fragment layout, and
// O += P.V is wgmma m64n{64,128}k16 with A from registers and V read
// MN-major (transposed B) from the same tile layout as K.
// Shared layout: a tile is [hd/64 column blocks][rows][64 bf16], one
// 128-byte line per row, 16-byte chunk c of row r stored at c ^ (r & 7):
// the 128B swizzle, for every head dim. For hd < 64 a line is padded to 64
// values: Q.K^T issues only max(hd/16, 1) k-steps, and P.V runs at N = 64
// and drops the columns past hd, so one swizzle mode and one descriptor
// shape serve hd 8, 16, 32, 64 and 128. At hd 8 the one k-step of 16 values
// also reads values 8..15 of each Q and K line, which no copy writes: the
// block sets them to zero once before its first copy, so the padded half
// of the dot product adds exactly 0. cp.async needs 16-byte-aligned
// sources: the wrapper refuses a base or stride that is not a multiple of
// 16 bytes.
// Numerics: scores and the accumulator in float32 as on the TPU. The TPU
// kernel multiplies P.V in float32; here P is split into a bf16 high part
// and a bf16 low part (the rest) and P.V runs as two products, so P keeps
// ~16 of its 24 bits (a single bf16 P brought the full-width qwen2-7b bf16
// check of chip_smoke.py close to its bound). l sums the unrounded p. The scores are scaled by softmax_scale(hd) * log2(e) and
// exponentiated with exp2f, the same softmax with other float32 roundings.
// The output is rounded to bf16 once.
//
// float32 (flash_kernel): float32 FMAs on the CUDA cores (67 TFLOP/s, so
// ~56 us of operations at the shape above). TF32 tensor cores keep ~10
// mantissa bits and could not meet the 2e-5 tolerance of the float32 tests
// and of the float32 LM checks, so this path stays. 256 threads as 16 x
// 16; thread (ty, tx) owns q rows ty*4..ty*4+3 and, for each kv tile, key
// columns tx + 16j (j < 4) of the score tile and output columns tx + 16j
// (j < hd/16) of the accumulator; at hd 8 the threads with tx < 8 own one
// output column each and the others none. Q (transposed, rows padded to 68), K
// (transposed, padded to 65) and V live in shared memory in float32; P is
// written over K's buffer once the scores are taken. Row max and row sum
// are reduced with shuffles over the 16 lanes of a row. expf (not __expf),
// IEEE division, explicit fmaf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;            // q rows per block
constexpr int BK = 64;            // kv rows per tile
constexpr int NT = 256;           // threads (16 x 16)
constexpr int QST = BQ + 4;       // Qs row stride (float4-aligned)
constexpr int KST = BK + 1;       // Ks row stride (conflict-free transpose)
constexpr int PST = BQ + 4;       // Ps row stride (float4-aligned)

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
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
  // accumulator columns per thread; below hd 16 one, owned by tx < HD
  constexpr int NJ = HD < 16 ? 1 : HD / 16;
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
        // a thread past hd (hd 8) reads column 0 and never stores it
        const int col = HD < 16 && tx >= HD ? 0 : tx + 16 * j;
        const float vv = Vs[kk * HD + col];
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
      if (HD >= 16 || tx < HD) orow[tx + 16 * j] = from_f<T>(acc[i][j] / den);
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;           // q rows per block: two warpgroups of 64
constexpr int BK = 64;            // kv rows per tile
constexpr int NT = 256;
constexpr int LINE = 128;         // bytes of one swizzled line: 64 bf16

__host__ __device__ constexpr int col_blocks(int hd) {
  return hd < 64 ? 1 : hd / 64;
}
__host__ __device__ constexpr int tile_bytes(int rows, int hd) {
  return col_blocks(hd) * rows * LINE;
}
// Q, two stages of K and V, and room to align the base to 1024 bytes (the
// swizzle pattern repeats every 8 lines and wgmma assumes it starts there)
__host__ __device__ constexpr int smem_bytes(int hd) {
  return tile_bytes(BQ, hd) + 4 * tile_bytes(BK, hd) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// this thread's generic-proxy writes to shared memory become visible to
// the async proxy, which is where wgmma reads its operands
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma shared-memory descriptor, 128B swizzle: start address, leading and
// stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 p) {
  return *reinterpret_cast<const uint32_t*>(&p);
}
// (a, b) -> bf16 pairs hi = round(a, b) and lo = round((a, b) - hi); .x
// holds a's part, the lower k index of the A fragment
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - __low2float(h),
                                    b - __high2float(h)));
}

// D(64 x 64) (+)= A(64 x 16) . B(64 x 16)^T, A and B K-major in smem
__device__ __forceinline__ void wgmma_ss_m64n64(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64) += A(64 x 16, registers) . B(16 x 64), B MN-major in smem
__device__ __forceinline__ void wgmma_rs_m64n64(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) . B(16 x 128), B MN-major in smem
__device__ __forceinline__ void wgmma_rs_m64n128(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// rows ROWS from global row r0 on (rows past nrows zero-filled) into the
// swizzled tile at base: row r's 16-byte chunk c goes to column block c/8,
// line r, chunk (c % 8) ^ (r % 8)
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t base, const bf16* g,
                                          long long stride, int r0,
                                          int nrows, int tid) {
  constexpr int CPR = HD / 8;                  // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const int row = r0 + r;
    const bool ok = row < nrows;
    const bf16* src = ok ? g + (long long)row * stride + c * 8 : g;
    cp_async16(base + (c >> 3) * ROWS * LINE + r * LINE +
                   (((c & 7) ^ (r & 7)) << 4),
               src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 2)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, Shape sh) {
  constexpr int NPV = HD < 64 ? 64 : HD;    // P.V width (lines hold 64)
  constexpr int KSTEPS = HD < 16 ? 1 : HD / 16;   // Q.K^T steps of 16
  constexpr int QT = tile_bytes(BQ, HD), KT = tile_bytes(BK, HD);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + QT;             // stage s: K at + 2s KT, V + KT

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                  // warpgroup: q rows 64wg..
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int nqt = gridDim.x;
  const int qt = nqt - 1 - blockIdx.x;      // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / sh.H, h = bh % sh.H;
  const int kvh = h / (sh.H / sh.KH);
  const int q0 = qt * BQ;
  const int q_offset = sh.Sk - sh.Sq;
  // scores in log2 units: softmax(x) = 2^(x log2 e - max), so exp2f (one
  // MUFU.EX2) replaces expf
  const float scale2 = (1.0f / sqrtf((float)HD)) * 1.4426950408889634f;

  const bf16* qp = q + b * sh.qb + h * sh.qh;
  const bf16* kp = k + b * sh.kb + kvh * sh.kh;
  const bf16* vp = v + b * sh.vb + kvh * sh.vh;

  // kv tiles that hold a visible key for some row of the block ...
  const int q_last = min(q0 + BQ, sh.Sq) - 1;
  int k_hi = sh.Sk - 1;
  if (sh.causal) k_hi = min(k_hi, q_last + q_offset);
  int k_lo = 0;
  if (sh.window > 0) k_lo = max(0, q0 + q_offset - sh.window + 1);
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi < 0 ? -1 : k_hi / BK;
  // ... and keys visible to some row of this warpgroup
  const int wq0 = q0 + 64 * wg;
  const bool has_rows = wq0 < sh.Sq;
  int wk_hi = sh.Sk - 1;
  if (sh.causal) wk_hi = min(wk_hi, min(wq0 + 64, sh.Sq) - 1 + q_offset);
  int wk_lo = 0;
  if (sh.window > 0) wk_lo = max(0, wq0 + q_offset - sh.window + 1);

  if constexpr (HD < 16) {
    // values 8..15 (16-byte chunk 1) of every line of Q and of both K/V
    // stages, which the k-step of 16 reads and no copy writes: zeros. The
    // tiles are consecutive runs of lines, each a multiple of 8 long, so a
    // line's swizzle phase is its index & 7. Each thread's fence before the
    // first wgmma makes its writes visible to the tensor cores.
    uint8_t* base = smem_raw + (sQ - smem_u32(smem_raw));
    for (int r = tid; r < BQ + 4 * BK; r += NT)
      *reinterpret_cast<uint4*>(base + r * LINE + ((1 ^ (r & 7)) << 4)) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  load_tile<HD, BQ>(sQ, qp, sh.qs, q0, sh.Sq, tid);
  if (t_lo <= t_hi) {
    load_tile<HD, BK>(sKV, kp, sh.ks, t_lo * BK, sh.Sk, tid);
    load_tile<HD, BK>(sKV + KT, vp, sh.vs, t_lo * BK, sh.Sk, tid);
  }
  cp_async_commit();

  // accumulator fragment: element 4j + 2i + e is row 16 warp + lane/4 + 8i
  // of the warpgroup's 64, column 8j + 2 (lane % 4) + e
  float oacc[NPV / 2];
#pragma unroll
  for (int i = 0; i < NPV / 2; ++i) oacc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const int rrow = 16 * warp + (lane >> 2);
  const int rcol = 2 * (lane & 3);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t < t_hi) {                 // next tile into the other stage
      const uint32_t nx = sKV + (st ^ 1) * 2 * KT;
      load_tile<HD, BK>(nx, kp, sh.ks, (t + 1) * BK, sh.Sk, tid);
      load_tile<HD, BK>(nx + KT, vp, sh.vs, (t + 1) * BK, sh.Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();           // all but the newest group are in
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    const int k0 = t * BK;
    if (has_rows && k0 <= wk_hi && k0 + BK - 1 >= wk_lo) {
      const uint32_t sK = sKV + st * 2 * KT, sV = sK + KT;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t col = (kk & 3) * 32;         // 16 values = 32 bytes
        wgmma_ss_m64n64(
            s,
            smem_desc(sQ + (kk >> 2) * BQ * LINE + wg * 64 * LINE + col, 16,
                      8 * LINE),
            smem_desc(sK + (kk >> 2) * BK * LINE + col, 16, 8 * LINE),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(s);

      // a tile that every row of the warpgroup sees whole skips the mask
      const bool interior =
          k0 + BK <= sh.Sk &&
          (!sh.causal || k0 + BK - 1 <= wq0 + q_offset) &&
          (sh.window <= 0 || k0 > wq0 + 63 + q_offset - sh.window);
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = wq0 + rrow + 8 * i + q_offset;
        float mt = -INFINITY;
        if (interior) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * i + e];
              x = x * scale2;
              mt = fmaxf(mt, x);
            }
        } else {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + 8 * j + rcol + e;
              bool ok = kpos < sh.Sk;
              if (sh.causal) ok = ok && kpos <= qpos;
              if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
              float& x = s[4 * j + 2 * i + e];
              x = ok ? x * scale2 : -INFINITY;
              mt = fmaxf(mt, x);
            }
        }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[i], mt);
        const float mref = m_new == -INFINITY ? 0.0f : m_new;
        alpha[i] = exp2f(m[i] - mref);
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * i + e];
            x = exp2f(x - mref);            // masked: 2^-inf = 0
            rs += x;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[i] = fmaf(l[i], alpha[i], rs);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NPV / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          oacc[4 * j + 2 * i] *= alpha[i];
          oacc[4 * j + 2 * i + 1] *= alpha[i];
        }

      // P = hi + lo, both bf16 (hi = P rounded, lo = the rest rounded):
      // P.V as two products keeps ~16 bits of P. The accumulator's columns
      // 16kk..16kk+15 are the A fragment of k-step kk as they lie.
      uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], phi[kk][r],
                     plo[kk][r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // 16 kv rows a step; column blocks of 64 values BK lines apart
        const uint64_t dv = smem_desc(sV + kk * 16 * LINE, BK * LINE,
                                      8 * LINE);
        if constexpr (NPV == 128) {
          wgmma_rs_m64n128(oacc, phi[kk], dv);
          wgmma_rs_m64n128(oacc, plo[kk], dv);
        } else {
          wgmma_rs_m64n64(oacc, phi[kk], dv);
          wgmma_rs_m64n64(oacc, plo[kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NPV / 2>(oacc);
    }
    __syncthreads();                // this stage is free for tile t + 2
  }

  if (!has_rows) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wq0 + rrow + 8 * i;
    if (row >= sh.Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    bf16* orow = o + (((long long)b * sh.Sq + row) * sh.H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + rcol) =
          __floats2bfloat162_rn(oacc[4 * j + 2 * i] / den,
                                oacc[4 * j + 2 * i + 1] / den);
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              const Shape& sh, cudaStream_t s) {
  const int smem = smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sh.Sq + BQ - 1) / BQ, B * sh.H);
  flash_tc_kernel<HD><<<grid, NT, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, sh);
  return (int)cudaGetLastError();
}

}  // namespace tc

// float32 on the CUDA cores, bf16 on the tensor cores
template <typename T, int HD>
int launch_dtype(const void* q, const void* k, const void* v, void* o, int B,
                 const Shape& sh, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return tc::launch_hd<HD>(q, k, v, o, B, sh, s);
  else
    return launch_hd<T, HD>(q, k, v, o, B, sh, s);
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
    case 8: return launch_dtype<T, 8>(q, k, v, o, B, sh, s);
    case 16: return launch_dtype<T, 16>(q, k, v, o, B, sh, s);
    case 32: return launch_dtype<T, 32>(q, k, v, o, B, sh, s);
    case 64: return launch_dtype<T, 64>(q, k, v, o, B, sh, s);
    case 128: return launch_dtype<T, 128>(q, k, v, o, B, sh, s);
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
