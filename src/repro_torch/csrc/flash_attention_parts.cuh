// The float32 parts arithmetic that the flash forward's float32 wgmma
// route (flash_attention_fwd_parts.cu) and the backward's parts kernels
// (flash_attention_bwd_parts.cuh) share: a float32 value as three bf16
// parts (hi, mid, lo: 8 + 8 + 8 bits, their sum the value exactly), the
// split of a row into the (B, S, heads, 3 DP) layout their TMA maps read,
// the recomputation's six-term product over split operands, and the
// split of an f32 accumulator fragment into register A fragments.  bf16
// parts and not TF32: wgmma reads a TF32 operand from shared memory only
// K-major, and the accumulations (P.V, P^T.dO, dS^T.Q, dS.K) read their
// B operand MN-major, which bf16 allows.  Each source that includes this
// header gets its own copy (internal linkage).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

#include "flash_attention_bwd.cuh"

namespace {

// shared memory a block may use; 1,024 of it go to aligning the swizzle
// atoms
constexpr uint32_t SMEM_LIMIT = 232448;

// The terms of a product of split operands, smallest first.  The
// recomputations S = Q.K^T and dP = dO.V^T (three parts an operand: hi,
// mid, lo) keep every term down to 2^-16 of the product: lo.hi, mid.mid,
// hi.lo, mid.hi, hi.mid, hi.hi (six; the dropped ones are 2^-24 of it).
// The backward's accumulations (A = P or dS in two parts, hi and lo; B
// the operand's hi and mid) keep lo.hi, hi.mid, hi.hi (three).  One
// part: one term.
template <int PARTS>
constexpr int RTERMS = PARTS == 1 ? 1 : 6;
template <int PARTS>
constexpr int ATERMS = PARTS == 1 ? 1 : 3;
template <int PARTS>
constexpr int APARTS = PARTS == 1 ? 1 : 2;   // parts of P and dS
__device__ __forceinline__ constexpr int rterm_a(int i, int n) {
  return n == 1 ? 0 : i == 0 ? 2 : i == 1 || i == 3 ? 1 : 0;
}
__device__ __forceinline__ constexpr int rterm_b(int i, int n) {
  return n == 1 ? 0 : i == 2 ? 2 : i == 1 || i == 4 ? 1 : 0;
}
__device__ __forceinline__ constexpr int aterm_a(int i, int n) {
  return n == 3 && i == 0 ? 1 : 0;
}
__device__ __forceinline__ constexpr int aterm_b(int i, int n) {
  return n == 3 && i == 1 ? 1 : 0;
}

template <typename T>
__device__ __forceinline__ float as_f32(T x) {
  if constexpr (std::is_same_v<T, float>) return x;
  else return __bfloat162float(x);
}

// (v0, v1) as a bf16 pair hi and the pair of what it leaves, lo
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = bf16_pair(v0, v1);
  lo = bf16_pair(v0 - __uint_as_float(hi << 16),
                 v1 - __uint_as_float(hi & 0xffff0000u));
}

// (v0, v1) into AP bf16 pairs f0 (hi) and, for two, f1 (lo)
template <int AP>
__device__ __forceinline__ void to_parts(float v0, float v1, uint32_t& f0,
                                         uint32_t& f1) {
  if constexpr (AP == 1) f0 = bf16_pair(v0, v1);
  else split2(v0, v1, f0, f1);
}

// The recomputation's terms A_a.B_b^T over the head dim: A the 64 rows
// at `a`, B the N rows at `b`, both K-major tiles of 128-byte column
// blocks `a_cb` and `b_cb` bytes apart, part p's blocks `a_part` or
// `b_part` bytes after part 0's.  One part: D = A.B^T into `d`.  Three
// parts: the five cross terms into `d` and hi.hi into `hh`, which the
// caller adds after the wait (sum_terms).  The tensor cores align the
// addends of an accumulation to the largest and drop the bits below
// (truncation, not rounding), so one accumulator over all six terms
// would carry the hi.hi sum's truncation into the small terms' sum; two
// keep each truncation within its own magnitude.
template <int N, int PARTS>
__device__ __forceinline__ void parts_rows_product(
    float (&d)[N / 2], float (&hh)[N / 2], uint32_t a, uint32_t a_part,
    uint32_t a_cb, uint32_t b, uint32_t b_part, uint32_t b_cb, int ksteps) {
  constexpr int NT = RTERMS<PARTS>;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const uint32_t ai = a + rterm_a(i, NT) * a_part;
    const uint32_t bi = b + rterm_b(i, NT) * b_part;
    const bool last = PARTS == 3 && i == NT - 1;
    for (int t = 0; t < ksteps; ++t) {
      const uint32_t off = (t % 4) * 32;
      const uint64_t da = smem_desc(ai + (t / 4) * a_cb + off, 16, 1024);
      const uint64_t db = smem_desc(bi + (t / 4) * b_cb + off, 16, 1024);
      if (last) wgmma_ss<N>(hh, da, db, t > 0);
      else wgmma_ss<N>(d, da, db, i > 0 || t > 0);
    }
  }
}

// d += hh where parts_rows_product split the terms (three parts)
template <int PARTS, int N>
__device__ __forceinline__ void sum_terms(float (&d)[N], const float (&hh)[N]) {
  if constexpr (PARTS == 3) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] += hh[i];
  }
}

// row `src` (Dh elements of T) as three bf16 parts whose sum is x exactly
// (8 + 8 + 8 bits) into dst[0, DP) (hi), dst[DP, 2 DP) (mid) and dst[2
// DP, 3 DP) (lo), zeros past Dh; one warp a row
template <typename T>
__device__ __forceinline__ void split_row(__nv_bfloat16* dst, const T* src,
                                          int Dh, int DP, int lane) {
  for (int d = lane; d < DP; d += 32) {
    const float x = d < Dh ? as_f32(src[d]) : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float r = x - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(r);
    dst[d] = hi;
    dst[DP + d] = mid;
    dst[2 * DP + d] = __float2bfloat16_rn(r - __bfloat162float(mid));
  }
}

}  // namespace
