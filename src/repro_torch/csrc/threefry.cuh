// jax.random's threefry2x32 on the card, shared by the draw-table kernels
// (csrc/qn_streams.cu, csrc/dag_streams.cu): the block cipher (20 rounds),
// fold_in / split, the partitionable counter scheme's bits (counter
// (0, index), output word 0 xor word 1), a unit exponential -log1pf(-u)
// as torch's log1p computes it on the card, and randint's reduction of its
// two words.  All of it but the logarithm is uint32 arithmetic, exact.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1,
                                             unsigned x0, unsigned x1,
                                             unsigned& y0, unsigned& y1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  unsigned a = x0 + ks[0], b = x1 + ks[1];
#pragma unroll
  for (int blk = 0; blk < 5; ++blk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a += b;
      b = rotl(b, kRot[blk % 2][r]) ^ a;
    }
    a += ks[(blk + 1) % 3];
    b += ks[(blk + 2) % 3] + (unsigned)(blk + 1);
  }
  y0 = a;
  y1 = b;
}

// fold_in / split: the key hashed at counter (0, d)
__device__ __forceinline__ void derive(unsigned k0, unsigned k1, unsigned d,
                                       unsigned& o0, unsigned& o1) {
  threefry2x32(k0, k1, 0u, d, o0, o1);
}

// random_bits(key, shape)[idx]
__device__ __forceinline__ unsigned bits_at(unsigned k0, unsigned k1,
                                            unsigned idx) {
  unsigned y0, y1;
  threefry2x32(k0, k1, 0u, idx, y0, y1);
  return y0 ^ y1;
}

__device__ __forceinline__ float unit_exponential(unsigned bits) {
  const float u = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  return -log1pf(-u);
}

// randint(key, (), 0, span) from its two words, with uint32 wrap-around
__device__ __forceinline__ unsigned randint(unsigned higher, unsigned lower,
                                            int n) {
  const unsigned span = n > 0 ? (unsigned)n : 1u;
  unsigned mult = 65536u % span;
  mult = (mult * mult) % span;
  const unsigned off = (higher % span) * mult + lower % span;
  return off % span;
}

}  // namespace
