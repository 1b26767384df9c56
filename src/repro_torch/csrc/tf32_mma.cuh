// 3xTF32 on the tensor cores: float32 products from TF32 mma.sync, for
// kernels that must keep float32's accuracy (linear_scan.cu's pass A at
// chunks above 64, flash_attention.cu's float32 kernel).
//
// Each operand x is split into a TF32 high part and the remainder, both
// rounded to TF32: a . b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, summed in
// float32 (the dropped a_lo b_lo is within 2^-22 of |a b|). A single TF32
// product keeps ~10 mantissa bits and misses the float32 tolerances.
#pragma once
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both rounded to TF32 to nearest: x - hi - lo is within
// 2^-24 |x|, as float32 rounds (a remainder left for the tensor core to
// truncate would bias every product toward zero by up to 2^-22). The
// exact split also serves non-finite and huge values as the plain
// products would: a non-finite x keeps x as its high part, with a
// remainder of 0, and gives 0 to the cross terms (hx), so that x * 0
// stays x * 0 (NaN for inf) and inf * y stays inf; a finite x whose
// rounding would overflow is truncated instead.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split_exact(float x, uint32_t& hi,
                                            uint32_t& lo, uint32_t& hx) {
  const bool fin = isfinite(x);
  uint32_t h = tf32_rna(x);
  if (fin && !isfinite(__uint_as_float(h)))
    h = __float_as_uint(x) & 0xffffe000u;
  hi = h;
  lo = fin ? tf32_rna(x - __uint_as_float(h)) : 0u;
  hx = fin ? h : 0u;
}

// c += a . b on the tensor cores: m16n8k8, TF32 operands, float32 sums.
// Fragments (g = lane / 4, t = lane % 4): a = (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4) of the 16 x 8 A; b = (t, g), (t + 4, g) of the 8 x 8 B;
// c = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of the 16 x 8 C.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// split n floats into TF32 high parts, remainders and the high parts the
// cross terms take (the same but for non-finite values in the exact split)
template <bool EXACT, int N>
__device__ __forceinline__ void split_n(const float* x, uint32_t* hi,
                                        uint32_t* lo, uint32_t* hx) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (EXACT) {
      split_exact(x[i], hi[i], lo[i], hx[i]);
    } else {
      split_fast(x[i], hi[i], lo[i]);
      hx[i] = hi[i];
    }
  }
}
