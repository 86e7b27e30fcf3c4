// Pieces the flash backward's kernels share (flash_attention_bwd.cu: the
// simt kernels and the bf16 wgmma pair; flash_attention_bwd_parts.cuh:
// the parts kernels): the band's mask, the wgmma products over
// 128-byte-swizzled tiles, p as one FMA and an ex2, bf16 pairs and splits,
// the TMA ring's producer, and the rows buffer's padding.  Each source
// that includes this header gets its own copy (internal linkage).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ bool live(int qpos, int kpos, int S, int causal,
                                     int window) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos) &&
         (!window || kpos > qpos - window);
}

constexpr float LOG2E = 1.4426950408889634f;

#define FA_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// m64nNk16, f32 += bf16 * bf16, beside hopper.cuh's: _ss_n32 with A and B
// from shared memory, both K-major (the parts dkdv kernel's S^T and dP^T
// over a warpgroup's 32 q columns); _ss_t with A from shared memory
// K-major and B MN-major (its dV += P^T.dO and dK += dS^T.Q, P^T and dS^T
// staged in shared memory).
__device__ __forceinline__ void wgmma_ss_n32(
    float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_t_n64(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_t_n128(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40),
        FA_D8(48), FA_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_t_n192(
    float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40),
        FA_D8(48), FA_D8(56), FA_D8(64), FA_D8(72), FA_D8(80), FA_D8(88)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_t_n256(
    float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40),
        FA_D8(48), FA_D8(56), FA_D8(64), FA_D8(72), FA_D8(80), FA_D8(88),
        FA_D8(96), FA_D8(104), FA_D8(112), FA_D8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}



#undef FA_D8

template <int N>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_t_n64(d, da, db, scale_d);
  else if constexpr (N == 128) wgmma_ss_t_n128(d, da, db, scale_d);
  else if constexpr (N == 192) wgmma_ss_t_n192(d, da, db, scale_d);
  else wgmma_ss_t_n256(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 128) wgmma_ss_n128(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n32(d, da, db, scale_d);
}

// D = A.B^T over the head dim (16 columns a step): A the 64 rows of a
// warpgroup at `a`, B the N rows at `b`, both K-major tiles of 128-byte
// column blocks `a_cb` and `b_cb` bytes apart
template <int N>
__device__ __forceinline__ void rows_product(float (&d)[N / 2], uint32_t a,
                                             uint32_t a_cb, uint32_t b,
                                             uint32_t b_cb, int ksteps) {
  for (int t = 0; t < ksteps; ++t) {
    const uint32_t off = (t % 4) * 32;          // within the 128-byte row
    wgmma_ss<N>(d, smem_desc(a + (t / 4) * a_cb + off, 16, 1024),
                smem_desc(b + (t / 4) * b_cb + off, 16, 1024), t);
  }
}

// D += F.B over KT rows of B (16 a step): F the bf16 A fragments of a
// (64, KT) accumulator, B a (KT, DP) tile at `b`, Dh contiguous (MN-major:
// column blocks KT * 128 bytes apart, 8-row groups 1024)
template <int DP, int KT>
__device__ __forceinline__ void frag_product(float (&d)[DP / 2],
                                             const uint32_t (&f)[KT / 4],
                                             uint32_t b) {
#pragma unroll
  for (int t = 0; t < KT / 16; ++t) {
    const uint32_t a[4] = {f[4 * t], f[4 * t + 1], f[4 * t + 2],
                           f[4 * t + 3]};
    wgmma_rs<DP>(d, a, smem_desc(b + t * 16 * 128, KT * 128, 1024));
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p = 2^(s * scale_log2 - l): one fused multiply-add (the library is
// built with --fmad=false, so it is spelled) and the SFU's ex2 (relative
// error 2^-22; results below 2^-126 flush to 0, far under a bf16 p's
// rounding)
__device__ __forceinline__ float prob(float s, float scale_log2, float l) {
  float p;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(p) : "f"(__fmaf_rn(s, scale_log2, -l)));
  return p;
}

// the next stage of a ring, and its phase: flips when the ring wraps
template <int STAGES>
__device__ __forceinline__ void ring_next(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// The ring's producer, run by thread 0 between its own tiles: the next
// tile goes to the stage of the oldest one once every warp has released
// that, so up to STAGES - 1 tiles are in flight ahead of the consumers.
template <int STAGES>
struct Ring {
  int next = 0, stage = 0;
  uint32_t phase = 0;
  template <typename Load>
  __device__ __forceinline__ void issue(uint32_t bar_full,
                                        uint32_t bar_empty, Load load) {
    mbar_wait(bar_empty + 8 * stage, phase ^ 1);
    load(stage, bar_full + 8 * stage);
    ++next;
    ring_next<STAGES>(stage, phase);
  }
};

// the rows buffer's padded length: S rounded up to the dkdv ring's tile
int rows_pad(int S) { return (S + 63) / 64 * 64; }

// the softmax scale 1/sqrt(Dh), and in log2 units
float scale_of(int Dh) { return (float)(1.0 / sqrt((double)Dh)); }
float scale_log2_of(int Dh) {
  return (float)(1.4426950408889634 / sqrt((double)Dh));
}

}  // namespace
