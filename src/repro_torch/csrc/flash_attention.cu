// Online-softmax (flash) attention with GQA, causal alignment, an optional
// sliding window and ragged lengths.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (_flash_kernel) and the GQA repeat and head transposes around it in
// src/repro/kernels/ops.py::flash_attention. The TPU kernel walks the kv
// blocks of one (head, q block) as a sequential grid dimension with m, l and
// the accumulator in VMEM scratch. Here one block owns one (b, h, 128-row q
// tile) and loops over the kv tiles itself, with m, l and the accumulator
// in registers; the (Sq, Sk) score matrix never reaches device memory.
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
// over 3.35 TB/s = 295), so the card's bound is the bytes, ~5 us. At the
// detect head (B = 8, S = 4096, 2 heads, hd = 16, float32, not causal) the
// call does 17.2 GFLOP on 16.8 MB: its bound is the products, 104 us at
// the 3xTF32 rate (a third of TF32's 495 TFLOP/s).
//
// Two kernels, one entry each; the wrapper picks by dtype. Both run both
// products on the tensor cores: bf16 on wgmma, float32 on mma.sync in
// 3xTF32.
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
// float32 (flash_mma_kernel): both products on the tensor cores with
// mma.sync m16n8k8 in 3xTF32 (tf32_mma.cuh: each operand a TF32 high part
// and its remainder rounded to nearest; a_hi b_hi + a_hi b_lo + a_lo b_hi
// in float32), which holds the 2e-5 float32 tolerance where one TF32
// product (~10 mantissa bits) could not.
// One block of 8 warps per (b, h, 128-row q tile), longest causal rows
// first, two blocks an SM below hd 128; a warp owns 16 q rows (mma's M),
// each row in the 4 lanes of a quad as in the accumulator layout.
//   Q: scaled by softmax_scale(hd) * log2(e) once. At hd <= 32 a lane's
//      split A fragments stay in registers for the whole kv loop; at hd 64
//      and 128 they would not fit, so the block's scaled Q sits in shared
//      memory (values t and t + 4 of each 8-column step side by side: a
//      fragment is two 8-byte reads) and a warp splits each k-step's
//      fragment as it reads it.
//   K, V: tiles of 32 keys (16 at hd 64 and 128, for shared memory). Each
//      thread copies its own items of a tile (8 columns of a key of K, 4 of
//      a key pair of V) raw into a two-stage ring with cp.async (16 bytes
//      at a time where k's and v's bases and strides are multiples of 16
//      bytes, else 4; rows past Sk zero-filled, so a masked p = 0 meets a
//      finite v) and later splits exactly those items into one of two
//      split buffers, where a lane's whole B fragment, high parts and
//      remainders, is one 16-byte read: K as [key][hi(t), hi(t + 4),
//      lo(t), lo(t + 4) for each 8-column step and t], V as [key
//      pair][column][hi, hi, lo, lo of keys 2p, 2p + 1]; row strides keep a
//      warp's reads on distinct banks. A thread's own cp.async wait orders
//      its split, so a tile costs one barrier: tile t + 1 is split into the
//      other buffer while tile t's products run.
//   S = Q.K^T: per 8 keys the small terms and a_hi b_hi in two
//      accumulators, added at the end. The mask runs on the accumulator in
//      registers, only on tiles the warp does not see whole; the online
//      softmax takes the row max with two shuffles, exponentiates with
//      ex2.approx.ftz (a p below 2^-126 of its row's max becomes 0, where
//      the plain version keeps a subnormal that no output can show), and
//      keeps each lane's part of the row sum, added across the quad once
//      at the end.
//   O += P.V: P stays in registers: the score accumulator of 8 keys is
//      the A fragment of P.V with its k index permuted (column t <-> key
//      2t, t + 4 <-> 2t + 1), so the B fragment takes keys 2t and 2t + 1 of
//      V: no shuffle and no shared-memory round trip. P is split too, the
//      small terms first. The tensor core's float32 sums truncate: O
//      accumulated there over the detect head's 4096 keys drifted toward
//      zero by up to 1.2e-5 (of the 2e-5 tolerance). So at hd <= 32 each
//      tile's P.V is summed from zero on the tensor cores (in 4, 2 or 1
//      sets at hd 8, 16, 32, for shorter mma chains) and added to O with
//      float32 FMAs: 6.4e-7 there. At hd 64 and 128 (16-key tiles) O
//      stays on the tensor cores, for registers.
//   Splits: cvt.rna.tf32.f32 is four instructions on sm_90a, so the
//      splits truncate the high part (one LOP3) and round only the
//      remainder (split_trunc for Q, K, V: cvt.rna; split_p, for p in
//      [0, 1]: float arithmetic); x - hi - lo stays within 2^-21 |x|.
// Measured on the H100 (tools/flash_tile_variants.py --f32 and
// --f32-probes, PERF.md section 6): at the detect head mma.sync's issue and
// latency and the splits and softmax between them, at four warps a
// scheduler, set the pace (~485 us against a 120 us bound); with one TF32
// product a pair instead of three it would take ~75% of that. 4 warps a
// block, 3 blocks an SM (80 registers, spilled), 16-key tiles and the next
// tile's Q.K^T issued before this tile's softmax measured slower, 64-key
// tiles (spilling) no faster. wgmma in TF32, whose products run beside the
// softmax, is the next step. Shared memory 31,744 B at hd 16, 171,520 B
// at hd 128 (one block an SM). IEEE division for the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

struct Shape {
  int Sq, Sk, H, KH, causal, window;          // window <= 0: none
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;  // strides, in elements
};

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

// ---------------------------------------------------------------------------
// float32 on the tensor cores, 3xTF32
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int WARPS = 8;          // a warp owns 16 q rows (mma's M)
constexpr int MIN_BLOCKS = 2;     // blocks an SM below hd 128 (caps registers)
constexpr int BK_SMALL = 32;      // keys a kv tile at hd <= 32
constexpr int BQ = 16 * WARPS;    // q rows per block
constexpr int NT = 32 * WARPS;

// 4 bytes from global to shared memory; zero when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Splits cheaper than tf32_mma.cuh's split_fast, whose two cvt.rna are four
// instructions each on sm_90a. The high part is x truncated to TF32 (one
// LOP3: no overflow, inf and NaN kept); the remainder x - hi is exact and
// is rounded to TF32 to nearest, so x - hi - lo is within 2^-21 |x|.
// split_trunc rounds it with cvt.rna (any finite x: Q, K, V);
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = tf32_rna(x - __uint_as_float(hi));
}
// split_p, for p in [0, 1] (or NaN), with float arithmetic (Veltkamp: for
// r below 2^-10 p, t = r * (2^13 + 1) and t - (t - r) is r rounded to its
// top 11 bits), three instructions where cvt.rna takes four.
__device__ __forceinline__ void split_p(float p, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(p) & 0xffffe000u;
  const float r = p - __uint_as_float(hi);
  const float t = r * 8193.0f;
  lo = __float_as_uint(t - (t - r));
}

// c += a . b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// Tile shapes and shared-memory layout by head dim; strides in 4-byte words
template <int HD>
struct Tiles {
  // keys a kv tile: fewer at hd 64 and 128, where the tiles are wide
  static constexpr int BK = HD <= 32 ? BK_SMALL : 16;
  static constexpr int NB = BK / 8;               // 8-key blocks of a tile
  static constexpr int KSTEPS = HD / 8;           // k-steps of Q.K^T
  static constexpr bool QREG = HD <= 32;          // Q's fragments in registers
  // At hd <= 32 a tile's P.V is summed from zero on the tensor cores, in
  // OSETS sets (k-steps alternate between them, so the dependent mma chains
  // stay short), and added to O with float32 FMAs: the tensor core's float32
  // sums truncate, and O accumulated there over Sk = 4096 keys drifts
  // toward zero by ~1e-5. At hd 64 and 128 (16-key tiles, 8 or 16 column
  // blocks) O is accumulated on the tensor cores directly, for registers.
  static constexpr bool PV_TILE = HD <= 32;
  static constexpr int OSETS = HD == 8 ? 4 : HD == 16 ? 2 : 1;
  // raw K/V row: = 4 mod 8 words, so the 16-byte copies and reads of 8
  // consecutive rows fall on distinct banks
  static constexpr int RS = HD + 4;
  // split K row: = 16 mod 32, so the 16-byte fragment reads of keys g and
  // g + 1 at t = 0..3 (a quarter warp) fall on 32 distinct banks
  static constexpr int KS = 2 * HD + (2 * HD % 32 == 16 ? 0 : 16);
  // split V key-pair row: = 8 mod 32 (pairs t = 0..3, columns g, g + 1)
  static constexpr int VS = 4 * HD + 8;
  // scaled Q row (hd 64, 128): = 8 mod 32 for the 8-byte reads of rows
  // g = 0..3 at t = 0..3 (a half warp)
  static constexpr int QS = HD + 8;
  static constexpr int RAW = BK * RS;             // one raw K or V tile
  static constexpr int SPLIT = BK * KS + BK / 2 * VS;   // one split K and V
  // items a thread copies and splits: 8 columns of a key of K, or 4
  // columns of a key pair of V
  static constexpr int NK = BK * HD / 8, NV = BK / 2 * HD / 4;
  static constexpr int WORDS = 4 * RAW + 2 * SPLIT + (QREG ? 0 : BQ * QS);
};

// This thread's items of kv tile kt copied raw into ring stage `stage`
// (rows past Sk zero-filled). A thread later splits exactly what it
// copied, so its own cp.async wait is all the ordering the split needs.
template <int HD>
__device__ __forceinline__ void copy_own(float* raw, int stage, int kt,
                                         const float* kp, const float* vp,
                                         const Shape& sh, bool vec, int tid) {
  using T = Tiles<HD>;
  const int k0 = kt * T::BK;
  float* rk = raw + stage * 2 * T::RAW;
  float* rv = rk + T::RAW;
  for (int i = tid; i < T::NK + T::NV; i += NT) {
    const bool is_k = i < T::NK;
    // K: column block c of key r (c-major, so 8 lanes take 8 keys);
    // V: column chunk c of key pair p, its two rows
    const int j = is_k ? i : i - T::NK;
    const int r0 = is_k ? j % T::BK : 2 * (j / (HD / 4));
    const int r1 = is_k ? r0 : r0 + 1;
    const int c0 = is_k ? 8 * (j / T::BK) : 4 * (j % (HD / 4));
    const int c1 = is_k ? c0 + 4 : c0;
    const float* g = is_k ? kp : vp;
    const long long st = is_k ? sh.ks : sh.vs;
    float* d = is_k ? rk : rv;
    const bool ok0 = k0 + r0 < sh.Sk, ok1 = k0 + r1 < sh.Sk;
    const float* s0 = g + (ok0 ? k0 + r0 : 0) * st + c0;
    const float* s1 = g + (ok1 ? k0 + r1 : 0) * st + c1;
    const uint32_t d0 = smem_u32(d + r0 * T::RS + c0);
    const uint32_t d1 = smem_u32(d + r1 * T::RS + c1);
    if (vec) {
      cp_async16(d0, s0, ok0);
      cp_async16(d1, s1, ok1);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        cp_async4(d0 + 4 * e, s0 + e, ok0);
        cp_async4(d1 + 4 * e, s1 + e, ok1);
      }
    }
  }
}

// This thread's items of ring stage `stage` split into the fragment
// layouts of K ([key][hi(t), hi(t + 4), lo(t), lo(t + 4)] for each 8-column
// step and t) and V ([key pair][column][hi, hi, lo, lo of keys 2p, 2p + 1])
template <int HD>
__device__ __forceinline__ void split_own(const float* raw, int stage,
                                          uint32_t* split, int tid) {
  using T = Tiles<HD>;
  const float* rk = raw + stage * 2 * T::RAW;
  const float* rv = rk + T::RAW;
  uint32_t* ks = split;
  uint32_t* vs = split + T::BK * T::KS;
  for (int i = tid; i < T::NK + T::NV; i += NT) {
    if (i < T::NK) {
      const int r = i % T::BK, c = 8 * (i / T::BK);
      const float4 a = *reinterpret_cast<const float4*>(rk + r * T::RS + c);
      const float4 b =
          *reinterpret_cast<const float4*>(rk + r * T::RS + c + 4);
      const float x0[4] = {a.x, a.y, a.z, a.w}, x1[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {              // columns c + t, c + t + 4
        uint32_t h0, l0, h1, l1;
        split_trunc(x0[t], h0, l0);
        split_trunc(x1[t], h1, l1);
        *reinterpret_cast<uint4*>(ks + r * T::KS + 2 * c + 4 * t) =
            make_uint4(h0, h1, l0, l1);
      }
    } else {
      const int j = i - T::NK;
      const int p = j / (HD / 4), c = 4 * (j % (HD / 4));
      const float4 a =
          *reinterpret_cast<const float4*>(rv + 2 * p * T::RS + c);
      const float4 b =
          *reinterpret_cast<const float4*>(rv + (2 * p + 1) * T::RS + c);
      const float x0[4] = {a.x, a.y, a.z, a.w}, x1[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t h0, l0, h1, l1;
        split_trunc(x0[e], h0, l0);
        split_trunc(x1[e], h1, l1);
        *reinterpret_cast<uint4*>(vs + p * T::VS + 4 * (c + e)) =
            make_uint4(h0, h1, l0, l1);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, HD == 128 ? 1 : MIN_BLOCKS)
flash_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Shape sh, int vec) {
  using T = Tiles<HD>;
  constexpr int BK = T::BK, NB = T::NB, KSTEPS = T::KSTEPS;
  constexpr int OSETS = T::OSETS, NO = HD / 8;
  constexpr bool PV_TILE = T::PV_TILE;
  extern __shared__ uint4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);   // [2][K, V][BK][RS]
  // two split tiles: [2][K [BK][KS], V [BK / 2][VS]]
  uint32_t* split = reinterpret_cast<uint32_t*>(raw + 4 * T::RAW);
  float* qs = reinterpret_cast<float*>(split + 2 * T::SPLIT);  // [BQ][QS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;     // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / sh.H, h = bh % sh.H;
  const int kvh = h / (sh.H / sh.KH);
  const int q0 = qt * BQ;
  const int q_offset = sh.Sk - sh.Sq;
  // scores in log2 units: softmax(x) = 2^(x log2 e - max)
  const float scale2 = (1.0f / sqrtf((float)HD)) * 1.4426950408889634f;

  const float* qp = q + b * sh.qb + h * sh.qh;
  const float* kp = k + b * sh.kb + kvh * sh.kh;
  const float* vp = v + b * sh.vb + kvh * sh.vh;

  // kv tiles that hold a visible key for some row of the block ...
  const int q_last = min(q0 + BQ, sh.Sq) - 1;
  int k_hi = sh.Sk - 1;
  if (sh.causal) k_hi = min(k_hi, q_last + q_offset);
  int k_lo = 0;
  if (sh.window > 0) k_lo = max(0, q0 + q_offset - sh.window + 1);
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi < 0 ? -1 : k_hi / BK;
  // ... and keys visible to some row of this warp
  const int wq0 = q0 + 16 * warp;
  const bool has_rows = wq0 < sh.Sq;
  int wk_hi = sh.Sk - 1;
  if (sh.causal) wk_hi = min(wk_hi, min(wq0 + 16, sh.Sq) - 1 + q_offset);
  int wk_lo = 0;
  if (sh.window > 0) wk_lo = max(0, wq0 + q_offset - sh.window + 1);

  // two tiles in flight; the first split before the loop
  if (t_lo <= t_hi) copy_own<HD>(raw, 0, t_lo, kp, vp, sh, vec, tid);
  cp_async_commit();
  if (t_lo + 1 <= t_hi) copy_own<HD>(raw, 1, t_lo + 1, kp, vp, sh, vec, tid);
  cp_async_commit();

  // Q, scaled: A fragments of rows g and g + 8 in registers, or the
  // block's rows in shared memory
  uint32_t qh[T::QREG ? KSTEPS : 1][4], ql[T::QREG ? KSTEPS : 1][4];
  if constexpr (T::QREG) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wq0 + g + 8 * (e & 1);
        const int col = 8 * kk + t4 + 4 * (e >> 1);
        const float x = row < sh.Sq ? qp[row * sh.qs + col] * scale2 : 0.0f;
        split_trunc(x, qh[kk][e], ql[kk][e]);
      }
  } else {
    for (int i = tid; i < BQ * HD / 2; i += NT) {
      const int t = i & 3, c = (i >> 2) % (HD / 8), r = i / (HD / 2);
      const int row = q0 + r;
      float2 x = make_float2(0.0f, 0.0f);
      if (row < sh.Sq) {
        const float* src = qp + row * sh.qs + 8 * c + t;
        x = make_float2(src[0] * scale2, src[4] * scale2);
      }
      *reinterpret_cast<float2*>(qs + r * T::QS + 8 * c + 2 * t) = x;
    }
  }
  cp_async_wait<1>();
  if (t_lo <= t_hi) split_own<HD>(raw, 0, split, tid);
  __syncthreads();

  // accumulator fragments: oacc[n][2i + e] is row g + 8i, column
  // 8n + 2 t4 + e; m and l of rows g and g + 8 (l: this lane's part)
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int cur = (kt - t_lo) & 1;
    // tile kt + 2 into the ring stage that tile kt has left
    if (kt + 2 <= t_hi) copy_own<HD>(raw, cur, kt + 2, kp, vp, sh, vec, tid);
    cp_async_commit();

    const int k0 = kt * BK;
    if (has_rows && k0 <= wk_hi && k0 + BK - 1 >= wk_lo) {
      const uint32_t* ks = split + cur * T::SPLIT;
      const uint32_t* vs = ks + BK * T::KS;
      // S = Q.K^T for this warp's 16 rows and the tile's BK keys, scaled:
      // s[n][2i + e] is row g + 8i, key k0 + 8n + 2 t4 + e
      float s[NB][4];
      if constexpr (T::QREG) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          float big[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float small[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          const uint32_t* kr = ks + (8 * n + g) * T::KS + 4 * t4;
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            const uint4 f = *reinterpret_cast<const uint4*>(kr + 16 * kk);
            const uint32_t bh[2] = {f.x, f.y}, bl[2] = {f.z, f.w};
            mma_tf32(small, ql[kk], bh);
            mma_tf32(small, qh[kk], bl);
            mma_tf32(big, qh[kk], bh);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = big[e] + small[e];
        }
      } else {
        float small[NB][4];
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = small[n][e] = 0.0f;
        const float* qa = qs + (16 * warp + g) * T::QS + 2 * t4;
#pragma unroll 2
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * kk);
          const float2 x1 =
              *reinterpret_cast<const float2*>(qa + 8 * T::QS + 8 * kk);
          const float a[4] = {x0.x, x1.x, x0.y, x1.y};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_trunc(a[e], ah[e], al[e]);
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            const uint4 f = *reinterpret_cast<const uint4*>(
                ks + (8 * n + g) * T::KS + 4 * t4 + 16 * kk);
            const uint32_t bh[2] = {f.x, f.y}, bl[2] = {f.z, f.w};
            mma_tf32(small[n], al, bh);
            mma_tf32(small[n], ah, bl);
            mma_tf32(s[n], ah, bh);
          }
        }
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += small[n][e];
      }

      // a tile that every row of the warp sees whole skips the mask
      float alpha[2];
      const bool interior =
          k0 + BK <= sh.Sk &&
          (!sh.causal || k0 + BK - 1 <= wq0 + q_offset) &&
          (sh.window <= 0 || k0 > wq0 + 15 + q_offset - sh.window);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = wq0 + g + 8 * i + q_offset;
        float mt = -INFINITY;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[n][2 * i + e];
            if (!interior) {
              const int kpos = k0 + 8 * n + 2 * t4 + e;
              bool ok = kpos < sh.Sk;
              if (sh.causal) ok = ok && kpos <= qpos;
              if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
              if (!ok) x = -INFINITY;
            }
            mt = fmaxf(mt, x);
          }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[i], mt);
        const float mref = m_new == -INFINITY ? 0.0f : m_new;
        alpha[i] = exp2_ftz(m[i] - mref);
        float rs = 0.0f;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[n][2 * i + e];
            x = exp2_ftz(x - mref);           // masked: 2^-inf = 0
            rs += x;
          }
        l[i] = fmaf(l[i], alpha[i], rs);
        m[i] = m_new;
        if constexpr (!PV_TILE) {
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            oacc[n][2 * i] *= alpha[i];
            oacc[n][2 * i + 1] *= alpha[i];
          }
        }
      }

      // O += P.V: the scores of keys 8j.. as the A fragment of k-step j,
      // (g, t) <- (g, 2t), (g + 8, t) <- (g + 8, 2t), (g, t + 4) <- (g, 2t +
      // 1), (g + 8, t + 4) <- (g + 8, 2t + 1); B: keys 2t and 2t + 1 of V
      float pv[PV_TILE ? OSETS : 1][NO][4];
      if constexpr (PV_TILE) {
#pragma unroll
        for (int a = 0; a < OSETS; ++a)
#pragma unroll
          for (int n = 0; n < NO; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pv[a][n][e] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_p(pa[e], ph[e], pl[e]);
        const uint32_t* vr = vs + (4 * j + t4) * T::VS + 4 * g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const uint4 f = *reinterpret_cast<const uint4*>(vr + 32 * n);
          const uint32_t bh[2] = {f.x, f.y}, bl[2] = {f.z, f.w};
          if constexpr (PV_TILE)
            mma_3xtf32(pv[j % OSETS][n], ph, pl, bh, bl);
          else
            mma_3xtf32(oacc[n], ph, pl, bh, bl);
        }
      }
      if constexpr (PV_TILE) {
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = pv[0][n][e];
#pragma unroll
            for (int a = 1; a < OSETS; ++a) x += pv[a][n][e];
            oacc[n][e] = fmaf(oacc[n][e], alpha[e >> 1], x);
          }
      }
    }

    // tile kt + 1 split into the other buffer, which tile kt - 1 has left
    if (kt + 1 <= t_hi) {
      cp_async_wait<1>();             // this thread's copies of tile kt + 1
      split_own<HD>(raw, cur ^ 1, split + (cur ^ 1) * T::SPLIT, tid);
    }
    __syncthreads();
  }

  if (!has_rows) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];                  // the row sum over the quad
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = wq0 + g + 8 * i;
    if (row >= sh.Sq) continue;
    const float den = fmaxf(lt, 1e-20f);
    float* orow = o + (((long long)b * sh.Sq + row) * sh.H + h) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
          make_float2(oacc[n][2 * i] / den, oacc[n][2 * i + 1] / den);
  }
}

__host__ inline bool aligned16(const void* p, long long s0, long long s1,
                               long long s2, int n0, int n1, int n2) {
  // a stride matters only where its dim has more than one entry
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         (n0 <= 1 || s0 % 4 == 0) && (n1 <= 1 || s1 % 4 == 0) &&
         (n2 <= 1 || s2 % 4 == 0);
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              const Shape& sh, cudaStream_t s) {
  const int smem = Tiles<HD>::WORDS * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  // K and V copied 16 bytes at a time where every row start is 16-byte
  // aligned
  const int vec = aligned16(k, sh.kb, sh.ks, sh.kh, B, sh.Sk, sh.KH) &&
                  aligned16(v, sh.vb, sh.vs, sh.vh, B, sh.Sk, sh.KH);
  const dim3 grid((sh.Sq + BQ - 1) / BQ, B * sh.H);
  flash_mma_kernel<HD><<<grid, NT, smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sh, vec);
  return (int)cudaGetLastError();
}

}  // namespace f32

// float32 on mma.sync (3xTF32), bf16 on wgmma
template <typename T, int HD>
int launch_dtype(const void* q, const void* k, const void* v, void* o, int B,
                 const Shape& sh, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return tc::launch_hd<HD>(q, k, v, o, B, sh, s);
  else
    return f32::launch_hd<HD>(q, k, v, o, B, sh, s);
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
