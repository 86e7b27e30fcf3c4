// Mamba2 SSD chunked scan, backward, bfloat16 route: the vjp of the
// forward at (dy, dstate) on Hopper's TMA, mbarriers and wgmma.
//
// Replaces: src/repro/kernels/ssd_scan/ops.py:28, _bwd (a jax.vjp through
// the plain chunked scan, no Pallas kernel).  What it computes, what
// bounds it and the design are in the header note of ssd_scan_bwd.cu
// (both routes); this header holds the route's five kernels and their
// launch (ssd_scan_bwd_wgmma.cu has the C entry point,
// ssd_bwd_wgmma_launch, and the P <= 64 instances, ssd_scan_bwd_wgmma_p128.cu
// the others):
//   ssd_bwd_wgmma_state_kernel<PP, NP, true>   the cotangent's reverse walk
//   ssd_bwd_wgmma_state_kernel<PP, NP, false>  the states' replay
//   ssd_bwd_wgmma_chunk_kernel<PP, NP>         dx, dcs's G terms, sum dG
//   ssd_bwd_wgmma_dbdc_kernel<PP, NP>          dC, dB over the heads; ddt
//   ssd_bwd_wgmma_reduce_kernel                dB, dC over head groups; dA
// PP and NP are P and N rounded up to 64 or 128 (TMA's zero fill pads the
// tiles).  Every tile is 128-byte swizzled (TMA's layout, and the one the
// kernels write); a state's image is its f32 values split into three bf16
// parts, hi + mid + lo (exact), each part in that layout (NP / 64 column
// blocks of PP rows x 128 bytes), which bulk copies move whole.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "hopper.cuh"

// Shared by the two sources of the SSD backward's bfloat16 route: the
// launch's arguments, and the routes past P = 64, which
// ssd_scan_bwd_wgmma_p128.cu instantiates (each source compiles its half
// of the kernels' instances, in parallel).
namespace ssd_bwd_wgmma {
struct Launch {
  const void *x, *dt, *A, *B, *C, *dy;
  const float* dstate;
  void *dx, *ddt, *dA, *dB, *dC;
  uint8_t *s_img, *ds_img;
  float *dgsum, *rows, *chunks, *dbc;
  int Bb, S, H, P, N, Q, G2, G3;
  long long xsb, xss, xsh, bsb, bss, csb, css, ysb, yss, ysh;
  long long db, ds, dh, as;
  int dt_bf16, a_bf16;
};

cudaError_t launch_p128(const Launch& L, cudaStream_t stream);
}  // namespace ssd_bwd_wgmma

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int QP = 128;                  // rows of a chunk tile (chunk <= 128)
constexpr uint32_t BLK = QP * 128;       // one 64-column block of a chunk tile
constexpr uint32_t SMEM_MAX = 232448;    // dynamic shared memory of a block
// a chunk's scalars, QP floats each: dt, cs, exp(cs), decay = exp(cs[Q-1]
// - cs), w = dt decay (0 past the chunk)
constexpr int SC_DT = 0, SC_CS = 1, SC_E = 2, SC_DECAY = 3, SC_W = 4;
constexpr uint32_t SCAL = 5 * QP * 4;

__device__ __forceinline__ float ldv(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void stv(void* p, long long i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// L = exp(d) for d = cs[l] - cs[s] <= 0, the difference taken in f32 (near
// each other it is exact), with expf as the plain version takes it: 2^(d
// log2(e)) would round d log2(e) first, a relative error of up to |d|
// 2^-24 in L, which grows with l - s, as the weights (the sums of dt
// between s and l) of dA's terms do.
__device__ __forceinline__ float exp_diff(float d) {
  return expf(d);
}

// Four 8 x 8 b16 matrices: lane 8m + r gives the address of row r of
// matrix m; register m gets (row lane/4, columns 2(lane%4), +1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

// (v0, v1) rounded to a bf16 pair, v0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float v0, float v1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(v1), "f"(v0));
  return r;
}

// (v0, v1) as a bf16 pair hi and the pair of what it leaves, lo: hi + lo
// holds v to ~2^-17 of it (one bf16 alone: 2^-9).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  lo = pack_bf16(v0 - __uint_as_float(hi << 16),
                 v1 - __uint_as_float(hi & 0xffff0000u));
}

// the two floats of a bf16 pair (bf16 to f32 is a shift)
__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// (v0, v1) as three bf16 pairs whose sum is v exactly (8 + 8 + 8 bits):
// where a product feeds dx, ddt or dcs two parts (2^-17) are not enough,
// since dcs's reverse cumulative sum and dA's sum multiply an error at
// a chunk's last step by the chunk's sum of dt.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float r0 = v0 - bf_lo(hi), r1 = v1 - bf_hi(hi);
  mid = pack_bf16(r0, r1);
  lo = pack_bf16(r0 - bf_lo(mid), r1 - bf_hi(mid));
}

__device__ __forceinline__ void stsf(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ uint32_t ldsu(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// The byte offset of element (row, col) in a 128-byte-swizzled tile of
// column blocks `cb` bytes apart (col even: the pair col, col + 1).
__device__ __forceinline__ uint32_t swz(int row, int col, uint32_t cb) {
  return (col / 64) * cb + row * 128 + ((((col % 64) / 8) ^ (row % 8)) * 16) +
         (col % 8) * 2;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// the sum over a quad of lanes (the four that share an accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// the sum over the eight lanes that share an accumulator column
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 8);
  return v + __shfl_xor_sync(FULL, v, 16);
}

// dt of steps 4 lane .. 4 lane + 3 of the chunk at t0 (0 past Q).
__device__ __forceinline__ void load_dt(float (&dtv)[4], const void* dt,
                                        long long base, long long ds,
                                        int t0, int Q, int bf16, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = 4 * lane + j;
    dtv[j] = s < Q ? ldv(dt, base + (t0 + s) * ds, bf16) : 0.f;
  }
}

// One warp writes a chunk's scalars from its dt (lane j: steps 4j ..
// 4j+3); the cumulative sum of dt A in f64, rounded once to f32, as the
// forward and the plain version take it.
__device__ __forceinline__ void chunk_scalars(uint32_t sc,
                                              const float (&dtv)[4],
                                              float Ah, int Q, int lane) {
  double part[4], run = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    run += (double)(dtv[j] * Ah);
    part[j] = run;
  }
  double tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(FULL, tot, off);
    if (lane >= off) tot += v;
  }
  const double before = tot - run;
  // steps past Q add dt = 0: the warp's total is cs[Q-1]
  const float cl = (float)__shfl_sync(FULL, tot, 31);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = 4 * lane + j;
    const bool in = s < Q;
    const float cs = (float)(before + part[j]);
    const float decay = in ? expf(cl - cs) : 0.f;
    stsf(sc + 4 * (SC_DT * QP + s), dtv[j]);
    stsf(sc + 4 * (SC_CS * QP + s), in ? cs : 0.f);
    stsf(sc + 4 * (SC_E * QP + s), in ? expf(cs) : 0.f);
    stsf(sc + 4 * (SC_DECAY * QP + s), decay);
    stsf(sc + 4 * (SC_W * QP + s), dtv[j] * decay);
  }
}

// A chunk's x, dy (P columns), B or C (N columns) tile: the TMA boxes of
// its Q rows, one per 64-column block, completing on `bar`.
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int blocks, int head,
                                          int t0, int b) {
  for (int k = 0; k < blocks; ++k)
    tma_load(dst + k * BLK, m, bar, 64 * k, head, t0, b);
}

// ------------------------------------------------------------------ states
//
// A block of two warpgroups per (b, h) walks the chunks, the state as
// wgmma accumulators in f32:
//   REV false: S <- exp(cs[Q-1]) S + (x o w)^T B, from 0; before each
//     chunk's update, the state entering it goes out as that chunk's image;
//     after it, <dS, S1> with the chunk's dS image (S1 the state leaving),
//     each thread's elements of it loaded into registers as the chunk
//     starts (in the ring they would leave room for one block an SM).
//   REV true:  dS <- exp(cs[Q-1]) dS + (dy o exp(cs))^T C, from dstate, the
//     chunks in reverse; before each update, the cotangent of the state
//     leaving the chunk goes out as its image.
// The products are the forward's state update (ssd_scan.cu, ssd_update):
// (U o w)^T's A fragments by ldmatrix.trans from U's tile, scaled in f32
// and split into three bf16 parts, V's tile the MN-major B operand.  As in
// the forward, at P <= 64 and N > 64 each warpgroup holds one 64-column
// half of the state, at P > 64 warpgroup g its rows 64 g .. 64 g + 63, and
// at P, N <= 64 warpgroup 0 all of it: two chains of products a block
// where there are two shares.  Each thread writes its own elements of the
// image (three 4-byte pairs each).

template <int PP, int NP, bool REV>
struct StCfg {
  static constexpr int PT = PP / 64, NT = NP / 64;
  static constexpr bool SPLIT_N = PT == 1 && NT == 2;
  static constexpr int OWNERS = PT == 2 || SPLIT_N ? 2 : 1;
  static constexpr int NW = SPLIT_N ? 64 : NP;      // an owner's columns
  static constexpr uint32_t U_BYTES = PT * BLK, V_BYTES = NT * BLK;
  static constexpr uint32_t PART = PP * NP * 2, IMG = 3 * PART;
  static constexpr uint32_t STAGE = U_BYTES + V_BYTES;    // U's, V's tile
  static constexpr uint32_t REST = 2 * SCAL + 32 + 16 + 1024;
  static constexpr int STAGES = 2 * STAGE + REST <= SMEM_MAX ? 2 : 1;
  static constexpr uint32_t OFF_SCAL = STAGES * STAGE;
  static constexpr uint32_t OFF_RED = OFF_SCAL + 2 * SCAL;   // 8 floats
  static constexpr uint32_t OFF_BAR = OFF_RED + 32;
  static constexpr uint32_t SMEM = OFF_BAR + 8 * STAGES + 1024;
};

struct StArgs {
  const void *dt, *A;
  const float* dstate;                 // (B, H, P, N) f32 contiguous
  uint8_t* img;                        // (B, H, nc) images written here
  const uint8_t* ds_img;               // REV false: the dS images
  float* dots;                         // REV false: <dS, S1>, (B, H, nc)
  int S, H, P, N, Q;
  long long db, ds, dh, as;
  int dt_bf16, a_bf16;
};

// st (64 rows p of the state, NW columns) += (U o w)^T V over the chunk's
// kq k-steps of 16 steps; U's column block at sUp, V's at sV.
template <int NW>
__device__ __forceinline__ void state_update(float (&st)[NW / 2],
                                             uint32_t sUp, uint32_t sV,
                                             uint32_t w, int wq, int lane,
                                             int kq) {
  constexpr int KB = NW == 128 ? 2 : 4;
  const int m = lane / 8, r = lane % 8, cq = 2 * (lane % 4);
  const int j = 2 * wq + m % 2;
#pragma unroll
  for (int t0 = 0; t0 < 8; t0 += KB) {
    if (t0 >= kq) break;
    uint32_t hi[KB][4], mid[KB][4], lo[KB][4];
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t0 + t >= kq) break;
      ldsm_x4_trans(hi[t], sUp + (16 * (t0 + t) + r + 8 * (m / 2)) * 128 +
                               ((j ^ r) * 16));
    }
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t0 + t >= kq) break;
      const float2 w0 = lds2(w + 4 * (16 * (t0 + t) + cq));
      const float2 w1 = lds2(w + 4 * (16 * (t0 + t) + cq + 8));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 wv = q < 2 ? w0 : w1;
        const uint32_t x = hi[t][q];
        split3(bf_lo(x) * wv.x, bf_hi(x) * wv.y, hi[t][q], mid[t][q],
               lo[t][q]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t0 + t >= kq) break;
      const uint64_t db = smem_desc(sV + (t0 + t) * 16 * 128, BLK, 1024);
      wgmma_rs<NW>(st, hi[t], db);
      wgmma_rs<NW>(st, mid[t], db);
      wgmma_rs<NW>(st, lo[t], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(st);
  }
}

template <int PP, int NP, bool REV>
__global__ void __launch_bounds__(256, 1)
ssd_bwd_wgmma_state_kernel(const __grid_constant__ CUtensorMap tu,
                           const __grid_constant__ CUtensorMap tv,
                           const StArgs a) {
  using C = StCfg<PP, NP, REV>;
  constexpr int NW = C::NW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(FULL, tid / 32, 0);
  const int wg = warp / 4, wq = warp % 4;
  const bool own = wg < C::OWNERS;
  // this warpgroup's share: rows 64 pi .., columns n0 .. n0 + NW - 1
  const int pi = C::PT == 2 ? wg : 0, n0 = C::SPLIT_N ? 64 * wg : 0;
  const int h = blockIdx.x, b = blockIdx.y;
  const int Q = a.Q, nc = a.S / Q;
  const float Ah = ldv(a.A, h * a.as, a.a_bf16);
  const long long dbase = b * a.db + h * a.dh;
  const long long bh = (long long)b * a.H + h;

  for (uint32_t o = 16 * tid; o < C::OFF_BAR; o += 16 * 256)
    *reinterpret_cast<uint4*>(smem_raw + (base - raw) + o) =
        make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(base + C::OFF_BAR + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();

  // the chunk visited k-th, and its loads into stage k % STAGES
  auto chunk_of = [&](int k) { return REV ? nc - 1 - k : k; };
  auto load = [&](int k) {
    const int c = chunk_of(k);
    const uint32_t full = base + C::OFF_BAR + 8 * (k % C::STAGES);
    const uint32_t sU = base + (k % C::STAGES) * C::STAGE;
    mbar_expect_tx(full, (C::PT + C::NT) * Q * 128);
    load_tile(sU, &tu, full, C::PT, h, c * Q, b);
    load_tile(sU + C::U_BYTES, &tv, full, C::NT, 0, c * Q, b);
  };
  if (tid == 0)
    for (int k = 0; k < C::STAGES && k < nc; ++k) load(k);
  float dtv[4];
  if (warp == 0) {
    load_dt(dtv, a.dt, dbase, a.ds, chunk_of(0) * Q, Q, a.dt_bf16, lane);
    chunk_scalars(base + C::OFF_SCAL, dtv, Ah, Q, lane);
  }

  // this thread's accumulator rows are r0 and r0 + 8, its columns 8j + cq
  // and + 1, of its warpgroup's share
  const int r0 = 16 * wq + lane / 4, cq = 2 * (lane % 4);
  float st[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int p = 64 * pi + r0 + (i % 4 < 2 ? 0 : 8);
    const int n = n0 + 8 * (i / 4) + cq + i % 2;
    st[i] = REV && own && p < a.P && n < a.N
                ? a.dstate[(bh * a.P + p) * a.N + n] : 0.f;
  }
  __syncthreads();
  const int kq = (Q + 15) / 16;

  for (int k = 0; k < nc; ++k) {
    uint32_t bs = base;
    asm volatile("" : "+r"(bs));
    const int c = chunk_of(k), stage = k % C::STAGES;
    if (warp == 0 && k + 1 < nc)
      load_dt(dtv, a.dt, dbase, a.ds, chunk_of(k + 1) * Q, Q, a.dt_bf16,
              lane);
    // REV false: this thread's pairs of the chunk's dS image, each the
    // sum of its three parts (exact), for the dot after the update
    float2 dsv[REV ? 1 : NW / 4];
    if (!REV && own) {
      const uint8_t* dsi = a.ds_img + (bh * nc + c) * C::IMG;
#pragma unroll
      for (int i = 0; i < NW / 2; i += 2) {
        const int p = 64 * pi + r0 + (i % 4 < 2 ? 0 : 8);
        const uint32_t off = swz(p, n0 + 8 * (i / 4) + cq, PP * 128);
        const uint32_t hi = *reinterpret_cast<const uint32_t*>(dsi + off);
        const uint32_t mid =
            *reinterpret_cast<const uint32_t*>(dsi + C::PART + off);
        const uint32_t lo =
            *reinterpret_cast<const uint32_t*>(dsi + 2 * C::PART + off);
        dsv[i / 2] = make_float2(bf_lo(hi) + bf_lo(mid) + bf_lo(lo),
                                 bf_hi(hi) + bf_hi(mid) + bf_hi(lo));
      }
    }
    mbar_wait(bs + C::OFF_BAR + 8 * stage, (k / C::STAGES) & 1);
    __syncwarp();
    const uint32_t sU = bs + stage * C::STAGE, sV = sU + C::U_BYTES;
    const uint32_t sc = bs + C::OFF_SCAL + (k % 2) * SCAL;
    if (own) {
      // the image of the state as it stands
      uint8_t* img = a.img + (bh * nc + c) * C::IMG;
#pragma unroll
      for (int i = 0; i < NW / 2; i += 2) {
        const int p = 64 * pi + r0 + (i % 4 < 2 ? 0 : 8);
        const uint32_t off = swz(p, n0 + 8 * (i / 4) + cq, PP * 128);
        uint32_t hi, mid, lo;
        split3(st[i], st[i + 1], hi, mid, lo);
        *reinterpret_cast<uint32_t*>(img + off) = hi;
        *reinterpret_cast<uint32_t*>(img + C::PART + off) = mid;
        *reinterpret_cast<uint32_t*>(img + 2 * C::PART + off) = lo;
      }
      const float e_last = lds(sc + 4 * (SC_E * QP + Q - 1));
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) st[i] *= e_last;
      state_update<NW>(st, sU + pi * BLK, sV + (n0 / 64) * BLK,
                       sc + 4 * (REV ? SC_E : SC_W) * QP, wq, lane, kq);
      if (!REV) {                      // <dS, S1>, S1 the state leaving c
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < NW / 2; i += 2) {
          v = __fmaf_rn(st[i], dsv[i / 2].x, v);
          v = __fmaf_rn(st[i + 1], dsv[i / 2].y, v);
        }
        v = warp_sum(v);
        if (lane == 0) stsf(bs + C::OFF_RED + 4 * warp, v);
      }
    }
    if (warp == 0 && k + 1 < nc)
      chunk_scalars(bs + C::OFF_SCAL + ((k + 1) % 2) * SCAL, dtv, Ah, Q,
                    lane);
    __syncthreads();                   // the stage's readers are done
    if (tid == 0) {
      if (!REV) {
        float t = 0.f;
        for (int w = 0; w < 4 * C::OWNERS; ++w)
          t += lds(bs + C::OFF_RED + 4 * w);
        a.dots[bh * nc + c] = t;
      }
      if (k + C::STAGES < nc) load(k + C::STAGES);
    }
  }
}

// ------------------------------------------------------------------- chunk
//
// A block of two warpgroups per (b, chunk, group of heads).  Warpgroup wg
// owns the chunk's steps s = 64 wg .. 64 wg + 63 and the steps l >= 64 wg
// (its LB blocks of 64): G^T[s, l] = B[s].C[l] once per block, then for
// each head of the group, in order:
//   M^T = x dy^T (wgmma, exact: bf16 inputs), dG^T = M^T o L^T o dt[s],
//   dcs's terms sum_l (dG o G)[l, s] (rows of dG^T o G^T) and sum_s (dG o
//   G)[t, s] (its columns, summed over lanes, then over warps in a fixed
//   order), dGsum^T += dG^T (registers, the group's heads);
//   U = B dS^T (dS's image, three parts), to_state[s] = decay dt x.U,
//   then d xdt = decay U + (G^T o L^T) dy (the A fragments of G^T o L^T
//   split into three bf16 parts, dy's tile MN-major) in passes of 64
//   columns p; dx = d xdt dt, sum_p d xdt x.
// Out: dx; rows[0] = sum_s (dG o G)[t, s] - sum_l (dG o G)[l, t] -
// to_state[t], rows[1] = sum_p d xdt x; the group's dGsum^T (QP x QP f32).
// C's tile is needed for G^T alone, so it arrives in the last stage of the
// ring, which takes its first head once G^T is computed.

template <int PP, int NP>
struct ChCfg {
  static constexpr int PT = PP / 64, NT = NP / 64;
  static constexpr uint32_t X_BYTES = PT * BLK, BC_BYTES = NT * BLK;
  static constexpr uint32_t PART = PP * NP * 2, IMG = 3 * PART;
  static constexpr uint32_t STAGE = 2 * X_BYTES + IMG;   // x, dy, dS image
  static constexpr uint32_t OFF_ST = BC_BYTES;           // after B
  // warpgroup 0's sum of dG^T over its second block of steps l (32
  // floats a thread): in registers it pushed ptxas into spills, which
  // serialized the wgmmas
  static constexpr uint32_t DSUM = 32 * 128 * 4;
  static constexpr uint32_t REST = 2 * SCAL + 8 * QP * 4 + 2 * QP * 4 +
                                   DSUM + 8 * 3 + 1024;
  static constexpr int STAGES =
      OFF_ST + 2 * STAGE + REST <= SMEM_MAX ? 2 : 1;
  static constexpr uint32_t OFF_SCAL = OFF_ST + STAGES * STAGE;
  static constexpr uint32_t OFF_COL = OFF_SCAL + 2 * SCAL;   // 8 x QP
  static constexpr uint32_t OFF_ROW = OFF_COL + 8 * QP * 4;  // 2 x QP
  static constexpr uint32_t OFF_DSUM = OFF_ROW + 2 * QP * 4;
  static constexpr uint32_t OFF_BAR = OFF_DSUM + DSUM;       // fixed, full
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (1 + STAGES) + 1024;
};

struct ChArgs {
  const void *dt, *A;
  const uint8_t* ds_img;               // (B, H, nc) images
  __nv_bfloat16* dx;                   // (B, S, H, P) contiguous
  float* dgsum;                        // (B, nc, G, QP, QP)
  float* rows;                         // (2, B, H, S)
  int Bb, S, H, P, N, Q, G, HG;
  long long db, ds, dh, as;
  int dt_bf16, a_bf16;
};

// The head loop of one warpgroup (LB blocks of 64 steps l).  A warpgroup
// whose rows lie past the chunk (chunks of at most 64) runs it too, every
// term masked: a third instance in the kernel, an idle loop that only
// kept the barriers, made ptxas serialize the wgmmas.
template <int PP, int NP, int LB>
__device__ __forceinline__ void chunk_heads(const ChArgs& a, uint32_t base,
                                            const CUtensorMap* tx,
                                            const CUtensorMap* ty, int wg,
                                            int wq, int lane, int warp,
                                            float (&dtv)[4], float& Anext) {
  using C = ChCfg<PP, NP>;
  constexpr int W = 32 * LB;
  const int tid = threadIdx.x;
  const int c = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int Q = a.Q, nc = a.S / Q, P = a.P;
  const int h0 = g * a.HG, nh = min(a.HG, a.H - h0);
  const int r0 = 16 * wq + lane / 4, cq = 2 * (lane % 4);
  const int sb = 64 * wg;
  const int sa = sb + r0, sbb = sa + 8;          // this thread's rows s
  const int kp = (P + 15) / 16, kn = (a.N + 15) / 16;
  const uint32_t sB = base;
  const uint32_t sC = base + C::OFF_ST + (C::STAGES - 1) * C::STAGE;
  const long long t0 = (long long)c * Q;

  auto load = [&](int k) {
    const int h = h0 + k;
    const uint32_t full = base + C::OFF_BAR + 8 * (1 + k % C::STAGES);
    const uint32_t sX = base + C::OFF_ST + (k % C::STAGES) * C::STAGE;
    mbar_expect_tx(full, 2 * C::PT * Q * 128 + C::IMG);
    load_tile(sX, tx, full, C::PT, h, c * Q, b);
    load_tile(sX + C::X_BYTES, ty, full, C::PT, h, c * Q, b);
    bulk_load(sX + 2 * C::X_BYTES,
              a.ds_img + (((long long)b * a.H + h) * nc + c) * C::IMG,
              C::IMG, full);
  };

  // G^T for this warpgroup's rows s and its LB blocks of steps l
  // the sum of dG^T: the first block of steps l in registers, the second
  // (warpgroup 0's, at chunks over 64) in shared memory, a float a thread
  // 128 floats apart
  float gt[W], dsum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dsum[i] = 0.f;
  const uint32_t sdsum = base + C::OFF_DSUM + 4 * (tid & 127);
  mbar_wait(base + C::OFF_BAR, 0);
  __syncwarp();
  {
#pragma unroll
    for (int lb = 0; lb < LB; ++lb) {
      float acc[32];
      const int l0 = sb + 64 * lb;
      wgmma_fence();
      for (int t = 0; t < kn; ++t) {
        const uint32_t off = (t / 4) * BLK + (t % 4) * 32;
        wgmma_ss_n64(acc, smem_desc(sB + off + sb * 128, 16, 1024),
                     smem_desc(sC + off + l0 * 128, 16, 1024), t);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) gt[32 * lb + i] = l0 < Q ? acc[i] : 0.f;
    }
  }
  __syncthreads();                     // C's tile is read: its stage is free
  if (tid == 0 && C::STAGES - 1 < nh) load(C::STAGES - 1);

  for (int k = 0; k < nh; ++k) {
    uint32_t bs = base;
    asm volatile("" : "+r"(bs));
    const int h = h0 + k, stage = k % C::STAGES;
    if (warp == 0 && k + 1 < nh) {
      load_dt(dtv, a.dt, (long long)b * a.db + (h + 1) * a.dh, a.ds,
              c * Q, Q, a.dt_bf16, lane);
      Anext = ldv(a.A, (h + 1) * a.as, a.a_bf16);
    }
    mbar_wait(bs + C::OFF_BAR + 8 * (1 + stage), (k / C::STAGES) & 1);
    __syncwarp();
    const uint32_t sX = bs + C::OFF_ST + stage * C::STAGE;
    const uint32_t sY = sX + C::X_BYTES, sD = sY + C::X_BYTES;
    const uint32_t sc = bs + C::OFF_SCAL + (k % 2) * SCAL;
    const uint32_t scs = sc + 4 * SC_CS * QP;

    {
      const float cs_a = lds(scs + 4 * sa), cs_b = lds(scs + 4 * sbb);
      const float dt_a = lds(sc + 4 * sa), dt_b = lds(sc + 4 * sbb);
      const float dec_a = lds(sc + 4 * (SC_DECAY * QP + sa));
      const float dec_b = lds(sc + 4 * (SC_DECAY * QP + sbb));
      float rs_a = 0.f, rs_b = 0.f;
      // dG^T and the sums of dG^T o G^T, a block of 64 steps l at a time
#pragma unroll
      for (int lb = 0; lb < LB; ++lb) {
        const int l0 = sb + 64 * lb;
        if (l0 >= Q) break;
        float mt[32];
        wgmma_fence();
        for (int t = 0; t < kp; ++t) {
          const uint32_t off = (t / 4) * BLK + (t % 4) * 32;
          wgmma_ss_n64(mt, smem_desc(sX + off + sb * 128, 16, 1024),
                       smem_desc(sY + off + l0 * 128, 16, 1024), t);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(mt);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int l = l0 + 8 * j + cq;
          const float2 cl = lds2(scs + 4 * l);
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, row = e < 2 ? sa : sbb;
            const int ll = l + (e & 1);
            const float cll = (e & 1) ? cl.y : cl.x;
            const float dg =
                ll < Q && ll >= row
                    ? mt[i] * exp_diff(cll - (e < 2 ? cs_a : cs_b)) *
                          (e < 2 ? dt_a : dt_b)
                    : 0.f;
            v[e] = dg * gt[32 * lb + i];
            if (lb == 0) {
              dsum[i] += dg;
            } else {
              const uint32_t at = sdsum + 4 * 128 * i;
              stsf(at, lds(at) + dg);
            }
          }
          rs_a += v[0] + v[1];
          rs_b += v[2] + v[3];
          const float c0 = column_sum(v[0] + v[2]);
          const float c1 = column_sum(v[1] + v[3]);
          if (lane < 4) {
            const uint32_t at = bs + C::OFF_COL + 4 * (warp * QP + l);
            stsf(at, c0);
            stsf(at + 4, c1);
          }
        }
      }
      rs_a = quad_sum(rs_a);
      rs_b = quad_sum(rs_b);

      // d xdt in passes of 64 columns p
      float ts_a = 0.f, ts_b = 0.f, xx_a = 0.f, xx_b = 0.f;
#pragma unroll 1
      for (int ph = 0; ph < C::PT; ++ph) {
        if (64 * ph >= P) break;
        float u[32];
        wgmma_fence();
        for (int t = 0; t < kn; ++t) {
          const uint64_t da = smem_desc(
              sB + (t / 4) * BLK + sb * 128 + (t % 4) * 32, 16, 1024);
          const uint32_t off =
              (t / 4) * PP * 128 + 64 * ph * 128 + (t % 4) * 32;
          wgmma_ss_n64(u, da, smem_desc(sD + off, 16, 1024), t);
          wgmma_ss_n64(u, da, smem_desc(sD + C::PART + off, 16, 1024), 1);
          wgmma_ss_n64(u, da, smem_desc(sD + 2 * C::PART + off, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(u);
        // to_state's sum and the decay of U
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 64 * ph + 8 * j + cq;
          const uint32_t xa = ldsu(sX + swz(sa, p, BLK));
          const uint32_t xb = ldsu(sX + swz(sbb, p, BLK));
          ts_a = __fmaf_rn(bf_lo(xa), u[4 * j], ts_a);
          ts_a = __fmaf_rn(bf_hi(xa), u[4 * j + 1], ts_a);
          ts_b = __fmaf_rn(bf_lo(xb), u[4 * j + 2], ts_b);
          ts_b = __fmaf_rn(bf_hi(xb), u[4 * j + 3], ts_b);
          u[4 * j] *= dec_a;
          u[4 * j + 1] *= dec_a;
          u[4 * j + 2] *= dec_b;
          u[4 * j + 3] *= dec_b;
        }
        // += (G^T o L^T) dy over the steps l, a k-step of 16 at a time
#pragma unroll
        for (int lb = 0; lb < LB; ++lb) {
          const int l0 = sb + 64 * lb;
          if (l0 >= Q) break;
          const int steps = min(4, (Q - l0 + 15) / 16);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (t >= steps) break;
            uint32_t fh[4], fm[4], fl[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int i = 32 * lb + 8 * t + 2 * q;
              const int row = (q & 1) ? sbb : sa;
              const float csr = (q & 1) ? cs_b : cs_a;
              const int l = l0 + 16 * t + cq + (q >= 2 ? 8 : 0);
              const float2 cl = lds2(scs + 4 * l);
              const float v0 =
                  l < Q && l >= row ? gt[i] * exp_diff(cl.x - csr) : 0.f;
              const float v1 = l + 1 < Q && l + 1 >= row
                                   ? gt[i + 1] * exp_diff(cl.y - csr)
                                   : 0.f;
              split3(v0, v1, fh[q], fm[q], fl[q]);
            }
            const uint64_t db = smem_desc(
                sY + ph * BLK + (l0 + 16 * t) * 128, BLK, 1024);
            wgmma_fence();
            wgmma_rs_n64(u, fh, db);
            wgmma_rs_n64(u, fm, db);
            wgmma_rs_n64(u, fl, db);
            wgmma_commit();
            wgmma_wait_all();
            reg_fence(u);
          }
        }
        // u = d xdt: dx = d xdt dt, and sum_p d xdt x
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 64 * ph + 8 * j + cq;
          const uint32_t xa = ldsu(sX + swz(sa, p, BLK));
          const uint32_t xb = ldsu(sX + swz(sbb, p, BLK));
          xx_a = __fmaf_rn(u[4 * j], bf_lo(xa), xx_a);
          xx_a = __fmaf_rn(u[4 * j + 1], bf_hi(xa), xx_a);
          xx_b = __fmaf_rn(u[4 * j + 2], bf_lo(xb), xx_b);
          xx_b = __fmaf_rn(u[4 * j + 3], bf_hi(xb), xx_b);
          if (p < P) {
            if (sa < Q)
              *reinterpret_cast<uint32_t*>(
                  a.dx + (((long long)b * a.S + t0 + sa) * a.H + h) * P + p) =
                  pack_bf16(u[4 * j] * dt_a, u[4 * j + 1] * dt_a);
            if (sbb < Q)
              *reinterpret_cast<uint32_t*>(
                  a.dx + (((long long)b * a.S + t0 + sbb) * a.H + h) * P +
                  p) = pack_bf16(u[4 * j + 2] * dt_b, u[4 * j + 3] * dt_b);
          }
        }
      }
      ts_a = quad_sum(ts_a);
      ts_b = quad_sum(ts_b);
      xx_a = quad_sum(xx_a);
      xx_b = quad_sum(xx_b);
      if (lane % 4 == 0) {
        const uint32_t rw = bs + C::OFF_ROW;
        stsf(rw + 4 * sa, -rs_a - dec_a * dt_a * ts_a);
        stsf(rw + 4 * sbb, -rs_b - dec_b * dt_b * ts_b);
        stsf(rw + 4 * (QP + sa), xx_a);
        stsf(rw + 4 * (QP + sbb), xx_b);
      }
    }
    __syncthreads();                   // the stage and the sums are done
    if (tid == 0 && k + C::STAGES < nh) load(k + C::STAGES);
    // the head's per-step terms: the column sums over the warps in order
    // (warps 4-7 hold steps l >= 64 only)
    if (tid < Q) {
      const uint32_t col = bs + C::OFF_COL + 4 * tid;
      float d = 0.f;
      for (int w = 0; w < 4; ++w) d += lds(col + 4 * w * QP);
      if (tid >= 64)
        for (int w = 4; w < 8; ++w) d += lds(col + 4 * w * QP);
      d += lds(bs + C::OFF_ROW + 4 * tid);
      const long long r = ((long long)b * a.H + h) * a.S + t0 + tid;
      const long long plane = (long long)a.Bb * a.H * a.S;
      a.rows[r] = d;
      a.rows[plane + r] = lds(bs + C::OFF_ROW + 4 * (QP + tid));
    }
    if (warp == 0 && k + 1 < nh)
      chunk_scalars(bs + C::OFF_SCAL + ((k + 1) % 2) * SCAL, dtv, Anext, Q,
                    lane);
    __syncthreads();
  }

  {
    float* out = a.dgsum + (((long long)b * nc + c) * a.G + g) * QP * QP;
#pragma unroll
    for (int lb = 0; lb < LB; ++lb)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int s = i % 4 < 2 ? sa : sbb;
        const int l = sb + 64 * lb + 8 * (i / 4) + cq;
        *reinterpret_cast<float2*>(out + s * QP + l) =
            lb == 0 ? make_float2(dsum[i], dsum[i + 1])
                    : make_float2(lds(sdsum + 4 * 128 * i),
                                  lds(sdsum + 4 * 128 * (i + 1)));
      }
  }
}

template <int PP, int NP>
__global__ void __launch_bounds__(256, 1)
ssd_bwd_wgmma_chunk_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap ty,
                           const __grid_constant__ CUtensorMap tb,
                           const __grid_constant__ CUtensorMap tc,
                           const ChArgs a) {
  using C = ChCfg<PP, NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(FULL, tid / 32, 0);
  const int c = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int Q = a.Q, nc = a.S / Q;
  const int h0 = g * a.HG, nh = min(a.HG, a.H - h0);

  for (uint32_t o = 16 * tid; o < C::OFF_BAR; o += 16 * 256)
    *reinterpret_cast<uint4*>(smem_raw + (base - raw) + o) =
        make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s <= C::STAGES; ++s) mbar_init(base + C::OFF_BAR + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    const uint32_t fixed = base + C::OFF_BAR;
    mbar_expect_tx(fixed, 2 * C::NT * Q * 128);
    load_tile(base, &tb, fixed, C::NT, 0, c * Q, b);
    load_tile(base + C::OFF_ST + (C::STAGES - 1) * C::STAGE, &tc, fixed,
              C::NT, 0, c * Q, b);
    for (int k = 0; k < C::STAGES - 1 && k < nh; ++k) {
      const int h = h0 + k;
      const uint32_t full = base + C::OFF_BAR + 8 * (1 + k);
      const uint32_t sX = base + C::OFF_ST + k * C::STAGE;
      mbar_expect_tx(full, 2 * C::PT * Q * 128 + C::IMG);
      load_tile(sX, &tx, full, C::PT, h, c * Q, b);
      load_tile(sX + C::X_BYTES, &ty, full, C::PT, h, c * Q, b);
      bulk_load(sX + 2 * C::X_BYTES,
                a.ds_img + (((long long)b * a.H + h) * nc + c) * C::IMG,
                C::IMG, full);
    }
  }
  float dtv[4], Anext = 0.f;
  if (warp == 0) {
    load_dt(dtv, a.dt, (long long)b * a.db + h0 * a.dh, a.ds, c * Q, Q,
            a.dt_bf16, lane);
    chunk_scalars(base + C::OFF_SCAL, dtv, ldv(a.A, h0 * a.as, a.a_bf16), Q,
                  lane);
  }
  __syncthreads();
  const int wg = warp / 4, wq = warp % 4;
  if (wg == 0 && Q > 64)
    chunk_heads<PP, NP, 2>(a, base, &tx, &ty, wg, wq, lane, warp, dtv,
                           Anext);
  else
    chunk_heads<PP, NP, 1>(a, base, &tx, &ty, wg, wq, lane, warp, dtv,
                           Anext);
}

// -------------------------------------------------------------------- dbdc
//
// A block of two warpgroups per (b, chunk, role, group of heads);
// warpgroup wg owns the chunk's rows 64 wg .. 64 wg + 63 of one output,
// an m64nNP accumulator summed over the group's heads in order:
//   role 0: dC += (exp(cs) o dy) S0 (three products: the A fragments of
//     exp(cs) o dy, from dy's tile by ldmatrix and scaled in f32, split
//     hi and lo, against S0's image hi and mid, MN-major), and per head
//     W = C S0^T (the image's three parts) for dcs's term exp(cs[t])
//     dy[t].W[t]; then, with the
//     chunk pass's terms and <dS, S1>, the head's dcs, its reverse
//     cumulative sum da (f64, rounded once), ddt and the chunk's share of
//     dA (one warp);
//   role 1: dB += (decay dt o x) dS, the same way.
// Group 0 then adds the G terms, (sum_g dGsum_g) B to dC and (sum_g
// dGsum_g)^T C to dB (A fragments of the groups' sums read from device
// memory in f32, split hi and lo; B's or C's tile MN-major).  Out: the
// group's f32 partials of dC and dB.

template <int PP, int NP>
struct DbCfg {
  static constexpr int PT = PP / 64, NT = NP / 64;
  static constexpr uint32_t U_BYTES = PT * BLK, BC_BYTES = NT * BLK;
  static constexpr uint32_t PART = PP * NP * 2, IMG = 3 * PART;
  static constexpr uint32_t STAGE = U_BYTES + IMG;        // dy or x, image
  static constexpr uint32_t OFF_ST = 2 * BC_BYTES;
  static constexpr uint32_t REST = 2 * SCAL + QP * 4 + 8 * 3 + 1024;
  static constexpr int STAGES =
      OFF_ST + 2 * STAGE + REST <= SMEM_MAX ? 2 : 1;
  static constexpr uint32_t OFF_SCAL = OFF_ST + STAGES * STAGE;
  static constexpr uint32_t OFF_W = OFF_SCAL + 2 * SCAL;      // QP floats
  static constexpr uint32_t OFF_BAR = OFF_W + QP * 4;
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (1 + STAGES) + 1024;
};

struct DbArgs {
  const void *dt, *A;
  const uint8_t *s_img, *ds_img;       // (B, H, nc) images
  const float* dgsum;                  // (B, nc, G2, QP, QP)
  const float* rows;                   // (2, B, H, S)
  float* chunks;                       // (2, B, H, nc): <dS, S1>, dA's share
  void* ddt;                           // (B, S, H)
  float* dbc;                          // (2, B, G3, S, N): dC, dB partials
  int Bb, S, H, P, N, Q, G2, G3, HG;
  long long db, ds, dh, as;
  int dt_bf16, a_bf16;
};

// acc (64 rows from `row0` of U's tile, NP columns) += (U o w) I over the
// kp k-steps of 16 columns p: U's rows by ldmatrix, scaled by w[row] and
// split into bf16 hi and lo; the image I (rows p, MN-major), its hi and
// mid parts: hi.hi + hi.mid + lo.hi (dB and dC only, bf16 outputs: two
// parts of each operand are enough).
template <int PP, int NP>
__device__ __forceinline__ void scaled_product(float (&acc)[NP / 2],
                                               uint32_t sU, int row0,
                                               uint32_t img, uint32_t w,
                                               int kp, int wq, int lane) {
  constexpr int KB = 4;
  constexpr uint32_t PART = PP * NP * 2;
  const int m = lane / 8, r = lane % 8;
  const int rr = row0 + 16 * wq + r + 8 * (m % 2);    // ldmatrix's row
  const int ra = row0 + 16 * wq + lane / 4;           // the fragment's rows
  const float wa = lds(w + 4 * ra), wb = lds(w + 4 * (ra + 8));
#pragma unroll
  for (int t0 = 0; t0 < 8; t0 += KB) {
    if (t0 >= kp) break;
    uint32_t hi[KB][4], lo[KB][4];
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t0 + t >= kp) break;
      ldsm_x4(hi[t], sU + swz(rr, 16 * (t0 + t) + 8 * (m / 2), BLK));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float wv = (q & 1) ? wb : wa;
        const uint32_t x = hi[t][q];
        split2(bf_lo(x) * wv, bf_hi(x) * wv, hi[t][q], lo[t][q]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t0 + t >= kp) break;
      const uint32_t at = img + (t0 + t) * 16 * 128;
      const uint64_t dh = smem_desc(at, PP * 128, 1024);
      const uint64_t dl = smem_desc(at + PART, PP * 128, 1024);
      wgmma_rs<NP>(acc, hi[t], dh);
      wgmma_rs<NP>(acc, hi[t], dl);
      wgmma_rs<NP>(acc, lo[t], dh);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
  }
}

// acc += F V over the k-steps [t_lo, t_hi) of 16 steps: F (64 rows from
// row0, the steps as columns) read in f32 from the groups' dGsum^T (TR
// false: F[row, k] = sum_g dGsum^T_g[row, k]; TR true: F[row, k] = sum_g
// dGsum^T_g[k, row]), split into bf16 hi and lo; V's tile MN-major.
template <int NP, bool TR>
__device__ __forceinline__ void gsum_product(float (&acc)[NP / 2],
                                             const float* dgs, int G,
                                             int row0, uint32_t sV,
                                             int t_lo, int t_hi, int wq,
                                             int lane) {
  const int ra = row0 + 16 * wq + lane / 4, cq = 2 * (lane % 4);
  for (int t = t_lo; t < t_hi; ++t) {
    uint32_t fh[4], fl[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = ra + ((q & 1) ? 8 : 0);
      const int k = 16 * t + cq + (q >= 2 ? 8 : 0);
      float v0 = 0.f, v1 = 0.f;
      for (int g = 0; g < G; ++g) {
        const float* m = dgs + (long long)g * QP * QP;
        if (TR) {
          v0 += m[k * QP + row];
          v1 += m[(k + 1) * QP + row];
        } else {
          const float2 v = *reinterpret_cast<const float2*>(m + row * QP + k);
          v0 += v.x;
          v1 += v.y;
        }
      }
      split2(v0, v1, fh[q], fl[q]);
    }
    wgmma_fence();
    const uint64_t db = smem_desc(sV + t * 16 * 128, BLK, 1024);
    wgmma_rs<NP>(acc, fh, db);
    wgmma_rs<NP>(acc, fl, db);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
  }
}

template <int PP, int NP>
__global__ void __launch_bounds__(256, 1)
ssd_bwd_wgmma_dbdc_kernel(const __grid_constant__ CUtensorMap tdy,
                          const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tb,
                          const __grid_constant__ CUtensorMap tc,
                          const DbArgs a) {
  using C = DbCfg<PP, NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(FULL, tid / 32, 0);
  const int wg = warp / 4, wq = warp % 4;
  const int c = blockIdx.x, b = blockIdx.y;
  const int role = blockIdx.z & 1, g3 = blockIdx.z >> 1;
  const int Q = a.Q, nc = a.S / Q, P = a.P, N = a.N;
  const int h0 = g3 * a.HG, nh = min(a.HG, a.H - h0);
  const long long t0 = (long long)c * Q;
  const bool active = 64 * wg < Q;
  const int row0 = 64 * wg;
  const CUtensorMap* tu = role == 0 ? &tdy : &tx;
  const uint8_t* images = role == 0 ? a.s_img : a.ds_img;
  const uint32_t sB = base, sC = base + C::BC_BYTES;

  for (uint32_t o = 16 * tid; o < C::OFF_BAR; o += 16 * 256)
    *reinterpret_cast<uint4*>(smem_raw + (base - raw) + o) =
        make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s <= C::STAGES; ++s) mbar_init(base + C::OFF_BAR + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  auto load = [&](int k) {
    const int h = h0 + k;
    const uint32_t full = base + C::OFF_BAR + 8 * (1 + k % C::STAGES);
    const uint32_t sU = base + C::OFF_ST + (k % C::STAGES) * C::STAGE;
    mbar_expect_tx(full, C::PT * Q * 128 + C::IMG);
    load_tile(sU, tu, full, C::PT, h, c * Q, b);
    bulk_load(sU + C::U_BYTES,
              images + (((long long)b * a.H + h) * nc + c) * C::IMG, C::IMG,
              full);
  };
  if (tid == 0) {
    const uint32_t fixed = base + C::OFF_BAR;
    mbar_expect_tx(fixed, 2 * C::NT * Q * 128);
    load_tile(sB, &tb, fixed, C::NT, 0, c * Q, b);
    load_tile(sC, &tc, fixed, C::NT, 0, c * Q, b);
    for (int k = 0; k < C::STAGES && k < nh; ++k) load(k);
  }
  // warp 0: the scalars of each head and, for role 0, what the head's dcs
  // needs from the earlier passes (steps 4 lane .. 4 lane + 3)
  float dtv[4], rp[4], rx[4], dot = 0.f, Ah = ldv(a.A, h0 * a.as, a.a_bf16);
  const long long plane = (long long)a.Bb * a.H * a.S;
  auto fetch = [&](int h) {
    load_dt(dtv, a.dt, (long long)b * a.db + h * a.dh, a.ds, c * Q, Q,
            a.dt_bf16, lane);
    if (role == 0) {
      const long long r = ((long long)b * a.H + h) * a.S + t0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 4 * lane + j;
        rp[j] = s < Q ? a.rows[r + s] : 0.f;
        rx[j] = s < Q ? a.rows[plane + r + s] : 0.f;
      }
      dot = a.chunks[((long long)b * a.H + h) * nc + c];
    }
  };
  if (warp == 0) {
    fetch(h0);
    chunk_scalars(base + C::OFF_SCAL, dtv, Ah, Q, lane);
  }
  __syncthreads();
  mbar_wait(base + C::OFF_BAR, 0);
  __syncwarp();

  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  const int kp = (P + 15) / 16, kn = (N + 15) / 16;
  const int r0 = 16 * wq + lane / 4, cq = 2 * (lane % 4);
  const int ra = row0 + r0, rb = ra + 8;

  for (int k = 0; k < nh; ++k) {
    uint32_t bs = base;
    asm volatile("" : "+r"(bs));
    const int h = h0 + k, stage = k % C::STAGES;
    mbar_wait(bs + C::OFF_BAR + 8 * (1 + stage), (k / C::STAGES) & 1);
    __syncwarp();
    const uint32_t sU = bs + C::OFF_ST + stage * C::STAGE;
    const uint32_t sI = sU + C::U_BYTES;
    const uint32_t sc = bs + C::OFF_SCAL + (k % 2) * SCAL;
    if (active) {
      scaled_product<PP, NP>(acc, sU, row0, sI,
                             sc + 4 * (role == 0 ? SC_E : SC_W) * QP, kp, wq,
                             lane);
      if (role == 0) {                 // exp(cs[t]) dy[t].(C S0^T)[t]
        float wa = 0.f, wb = 0.f;
#pragma unroll 1
        for (int ph = 0; ph < C::PT; ++ph) {
          if (64 * ph >= P) break;
          float wt[32];
          wgmma_fence();
          for (int t = 0; t < kn; ++t) {
            const uint64_t da = smem_desc(
                sC + (t / 4) * BLK + row0 * 128 + (t % 4) * 32, 16, 1024);
            const uint32_t off =
                (t / 4) * PP * 128 + 64 * ph * 128 + (t % 4) * 32;
            wgmma_ss_n64(wt, da, smem_desc(sI + off, 16, 1024), t);
            wgmma_ss_n64(wt, da, smem_desc(sI + C::PART + off, 16, 1024), 1);
            wgmma_ss_n64(wt, da,
                         smem_desc(sI + 2 * C::PART + off, 16, 1024), 1);
          }
          wgmma_commit();
          wgmma_wait_all();
          reg_fence(wt);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int p = 64 * ph + 8 * j + cq;
            const uint32_t ya = ldsu(sU + swz(ra, p, BLK));
            const uint32_t yb = ldsu(sU + swz(rb, p, BLK));
            wa = __fmaf_rn(bf_lo(ya), wt[4 * j], wa);
            wa = __fmaf_rn(bf_hi(ya), wt[4 * j + 1], wa);
            wb = __fmaf_rn(bf_lo(yb), wt[4 * j + 2], wb);
            wb = __fmaf_rn(bf_hi(yb), wt[4 * j + 3], wb);
          }
        }
        wa = quad_sum(wa);
        wb = quad_sum(wb);
        if (lane % 4 == 0) {
          stsf(bs + C::OFF_W + 4 * ra, lds(sc + 4 * (SC_E * QP + ra)) * wa);
          stsf(bs + C::OFF_W + 4 * rb, lds(sc + 4 * (SC_E * QP + rb)) * wb);
        }
      }
    }
    __syncthreads();                   // the stage and the W terms are done
    if (tid == 0 && k + C::STAGES < nh) load(k + C::STAGES);
    if (warp == 0) {
      if (role == 0) {
        // dcs, da = its reverse cumulative sum (f64, rounded once), ddt and
        // the chunk's share of dA; lane j holds steps 4j .. 4j + 3
        double d[4], tot = 0.0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * lane + j;
          const float v = s < Q ? rp[j] + lds(bs + C::OFF_W + 4 * s) +
                                      (s == Q - 1 ? dot : 0.f)
                                : 0.f;
          d[j] = (double)v;
          tot += d[j];
        }
        double after = tot;              // the lanes from this one on
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double v = __shfl_down_sync(FULL, after, off);
          if (lane + off < 32) after += v;
        }
        after -= tot;                    // the later lanes' sum
        double run = after, share = 0.0;
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          const int s = 4 * lane + j;
          run += d[j];
          if (s < Q) {
            const float da = (float)run;
            const float pa = da * Ah;
            stv(a.ddt, ((long long)b * a.S + t0 + s) * a.H + h,
                a.dt_bf16 ? bf16r(rx[j]) + bf16r(pa) : rx[j] + pa,
                a.dt_bf16);
            share += (double)(da * dtv[j]);
          }
        }
#pragma unroll
        for (int off = 16; off; off >>= 1)
          share += __shfl_xor_sync(FULL, share, off);
        if (lane == 0)
          a.chunks[plane / a.S * nc + ((long long)b * a.H + h) * nc + c] =
              (float)share;
      }
      if (k + 1 < nh) {
        Ah = ldv(a.A, (h + 1) * a.as, a.a_bf16);
        fetch(h + 1);
        chunk_scalars(bs + C::OFF_SCAL + ((k + 1) % 2) * SCAL, dtv, Ah, Q,
                      lane);
      }
    }
    __syncthreads();
  }

  if (active) {
    if (g3 == 0) {
      const float* dgs = a.dgsum + ((long long)b * nc + c) * a.G2 * QP * QP;
      if (role == 0)     // dC[l] += sum_s dGsum[l, s] B[s], s <= l
        gsum_product<NP, true>(acc, dgs, a.G2, row0, sB, 0,
                               min(4 * wg + 4, (Q + 15) / 16), wq, lane);
      else               // dB[s] += sum_l dGsum[l, s] C[l], l >= s
        gsum_product<NP, false>(acc, dgs, a.G2, row0, sC, 4 * wg,
                                (Q + 15) / 16, wq, lane);
    }
    float* out = a.dbc + (((long long)role * a.Bb + b) * a.G3 + g3) * a.S * N;
#pragma unroll
    for (int i = 0; i < NP / 2; i += 2) {
      const int row = i % 4 < 2 ? ra : rb;
      const int n = 8 * (i / 4) + cq;
      if (row < Q && n < N) {
        float* at = out + (t0 + row) * N + n;
        at[0] = acc[i];
        if (n + 1 < N) at[1] = acc[i + 1];
      }
    }
  }
}

// ------------------------------------------------------------------ reduce
// dC and dB summed over the head groups in order, in B's and C's dtype;
// dA over (b, chunk) in order (f64, rounded once).
struct RdArgs {
  const float* dbc;
  const float* chunks;
  void *dB, *dC, *dA;
  int Bb, S, H, N, nc, G3, bc_bf16, a_bf16;
};

__global__ void __launch_bounds__(256) ssd_bwd_wgmma_reduce_kernel(RdArgs a) {
  const long long SN = (long long)a.S * a.N;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i < a.Bb * SN) {
    const long long b = i / SN, r = i - b * SN;
    const long long plane = (long long)a.Bb * a.G3 * SN;
    const float* pc = a.dbc + b * a.G3 * SN + r;
    float sc = 0.f, sb = 0.f;
    for (int g = 0; g < a.G3; ++g) {
      sc += pc[g * SN];
      sb += pc[plane + g * SN];
    }
    stv(a.dC, i, sc, a.bc_bf16);
    stv(a.dB, i, sb, a.bc_bf16);
  }
  if (i < a.H) {
    const float* share = a.chunks + (long long)a.Bb * a.H * a.nc;
    double acc = 0.0;
    for (int b = 0; b < a.Bb; ++b)
      for (int c = 0; c < a.nc; ++c)
        acc += (double)share[((long long)b * a.H + i) * a.nc + c];
    stv(a.dA, i, (float)acc, a.a_bf16);
  }
}

bool tma_ok(const void* p, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0;
}

template <class K>
cudaError_t smem_attr(K kernel, uint32_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int PP, int NP>
cudaError_t launch_route(const ssd_bwd_wgmma::Launch& L,
                         cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  // x and dy as (P, H, S, B), B and C as (N, 1, S, B): boxes of 64 columns
  // x one chunk
  CUtensorMap tx, ty, tb, tc;
  const Strides xs{L.xsb, L.xss, L.xsh}, ys{L.ysb, L.yss, L.ysh};
  const Strides bs{L.bsb, L.bss, L.bss}, cs{L.csb, L.css, L.css};
  if (!encode(fn, &tx, L.x, L.Bb, L.S, L.H, L.P, xs, L.Q) ||
      !encode(fn, &ty, L.dy, L.Bb, L.S, L.H, L.P, ys, L.Q) ||
      !encode(fn, &tb, L.B, L.Bb, L.S, 1, L.N, bs, L.Q) ||
      !encode(fn, &tc, L.C, L.Bb, L.S, 1, L.N, cs, L.Q))
    return cudaErrorInvalidValue;
  const int nc = L.S / L.Q;
  const int HG2 = (L.H + L.G2 - 1) / L.G2, HG3 = (L.H + L.G3 - 1) / L.G3;
  cudaError_t err;

  using SR = StCfg<PP, NP, true>;
  using SF = StCfg<PP, NP, false>;
  StArgs st{L.dt, L.A, L.dstate, L.ds_img, nullptr, nullptr, L.S, L.H, L.P,
            L.N, L.Q, L.db, L.ds, L.dh, L.as, L.dt_bf16, L.a_bf16};
  auto rev = ssd_bwd_wgmma_state_kernel<PP, NP, true>;
  auto fwd = ssd_bwd_wgmma_state_kernel<PP, NP, false>;
  if ((err = smem_attr(rev, SR::SMEM)) != cudaSuccess ||
      (err = smem_attr(fwd, SF::SMEM)) != cudaSuccess)
    return err;
  rev<<<dim3(L.H, L.Bb), 256, SR::SMEM, stream>>>(ty, tc, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  st.img = L.s_img;
  st.ds_img = L.ds_img;
  st.dots = L.chunks;
  fwd<<<dim3(L.H, L.Bb), 256, SF::SMEM, stream>>>(tx, tb, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  using Ch = ChCfg<PP, NP>;
  const ChArgs ch{L.dt, L.A, L.ds_img, static_cast<__nv_bfloat16*>(L.dx),
                  L.dgsum, L.rows, L.Bb, L.S, L.H, L.P, L.N, L.Q, L.G2, HG2,
                  L.db, L.ds, L.dh, L.as, L.dt_bf16, L.a_bf16};
  auto chunk = ssd_bwd_wgmma_chunk_kernel<PP, NP>;
  if ((err = smem_attr(chunk, Ch::SMEM)) != cudaSuccess) return err;
  chunk<<<dim3(nc, L.Bb, L.G2), 256, Ch::SMEM, stream>>>(tx, ty, tb, tc, ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  using Db = DbCfg<PP, NP>;
  const DbArgs db{L.dt, L.A, L.s_img, L.ds_img, L.dgsum, L.rows, L.chunks,
                  L.ddt, L.dbc, L.Bb, L.S, L.H, L.P, L.N, L.Q, L.G2, L.G3,
                  HG3, L.db, L.ds, L.dh, L.as, L.dt_bf16, L.a_bf16};
  auto dbdc = ssd_bwd_wgmma_dbdc_kernel<PP, NP>;
  if ((err = smem_attr(dbdc, Db::SMEM)) != cudaSuccess) return err;
  dbdc<<<dim3(nc, L.Bb, 2 * L.G3), 256, Db::SMEM, stream>>>(ty, tx, tb, tc,
                                                             db);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const RdArgs rd{L.dbc, L.chunks, L.dB, L.dC, L.dA, L.Bb, L.S, L.H, L.N,
                  nc, L.G3, 1, L.a_bf16};
  const long long total = (long long)L.Bb * L.S * L.N;
  const long long work = total > L.H ? total : L.H;
  ssd_bwd_wgmma_reduce_kernel<<<(unsigned)((work + 255) / 256), 256, 0,
                                stream>>>(rd);
  return cudaGetLastError();
}

}  // namespace
