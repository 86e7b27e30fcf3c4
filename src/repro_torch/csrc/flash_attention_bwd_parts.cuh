// FlashAttention backward, the parts kernels: the wgmma route's kernels
// for bfloat16 at head dims in (128, 256] and for float32 at head dims up
// to 128, where the bf16 pair of flash_attention_bwd.cu (bf16, Dh <= 128)
// does not reach.  What they compute is that file's header note: p =
// exp(q.k * scale - lse), ds = p * (dp - delta) * scale, dv = P^T.dO, dk
// = dS^T.Q, dq = dS.K, masked to the band, with GQA; they replace the
// same reference, src/repro/kernels/flash_attention/jnp_impl.py,
// _bwd_vjp.
//
// Every product runs on wgmma with bf16 operands and f32 accumulators.
// An operand is held in PARTS bf16 parts: one for bfloat16 inputs, three
// for float32 (hi, mid, lo: 8 + 8 + 8 bits, their sum the value
// exactly).  A float32 recomputation (S = Q.K^T, dP = dO.V^T) sums the
// six terms down to 2^-16 of the product (lo.hi, mid.mid, hi.lo, mid.hi,
// hi.mid, hi.hi); an accumulation (dV += P^T.dO, dK += dS^T.Q, dQ +=
// dS.K, P and dS split in two, hi and lo) three (lo.hi, hi.mid, hi.hi).
// Two parts an operand (hi + lo, 2^-17 of the value, with hi.hi + hi.lo +
// lo.hi everywhere) measured 1.10e-4 from plain at Dh 192 on the card
// (tolerance 1e-4 + 1e-4 |x|): dp - delta cancels where a row sees few
// keys, and dP's 2^-16 error shows there; the recomputations need the
// third part.  bf16 and not TF32: wgmma reads a TF32 operand from shared
// memory only K-major, and three of the five products (P^T.dO, dS^T.Q,
// dS.K) read an operand MN-major, which bf16 allows.
//
// What bounds them on the H100: operations.  At nemotron-4-340b's
// attention (B=1, S=4096, H=96, KV=8, Dh=192, bf16, causal) dq's three
// products are 0.93 TFLOP (0.94 ms at 989 TFLOP/s) against 0.48 GB (0.14
// ms at 3.35 TB/s), dkdv's four 1.24 TFLOP against 0.36 GB; in float32
// the six-term recomputations and three-term accumulations multiply the
// bf16 work by 5 (dq) and 4.5 (dkdv).  The design keeps the tensor cores
// fed as the pair does (TMA rings, wgmma from shared memory, P and dS in
// registers or in one 64 x 64 tile each) and adds only what the wide
// heads and the parts force (dkdv's split of dK and dV between
// warpgroups, its two block barriers a tile).
//
// Three launches on one stream:
//  (1) fa_bwd_prep_kernel<T, PARTS>: one warp a row.  Writes each q row's
//      (lse * log2(e), delta = rowsum(dO * O)) into the rows buffer (B,
//      H, S_pad, 2) f32, zeros past S, delta summed in f32 from the
//      inputs themselves, and, for float32, the parts of Q, dO, K and V:
//      (B, S, heads, 3 DP) bf16 rows, hi, mid and lo in columns [0, DP),
//      [DP, 2 DP), [2 DP, 3 DP), zero past Dh (DP = Dh rounded up to 64).
//      The split is a pass of its own, written to global memory, so that
//      TMA loads the parts as it loads bf16 tiles: a split at staging
//      would need the f32 tile in shared memory beside its parts, or
//      every thread on the load path.  The pass reads 4 and writes 6
//      bytes an element.
//  (2) fa_bwd_dq_parts_kernel<DP, WGS, STAGES, PARTS>: one block per (b,
//      q head, tile of 64 WGS q rows), WGS warpgroups of 64 rows.  TMA
//      loads the Q and dO tiles (every part) once; a ring of STAGES K/V
//      tiles of BK = 64 keys runs over the band.  S = Q.K^T and dP =
//      dO.V^T by wgmma from shared memory, P and dS in f32 registers, dS
//      as register A fragments (hi, and lo for float32), dQ += dS.K.
//      (lse, delta) from the rows buffer.  The last q tiles start first.
//  (3) fa_bwd_dkdv_parts_kernel<DP, STAGES, PARTS>: one block per (b, kv
//      head, tile of 64 keys), two warpgroups.  K and V (every part) stay
//      resident; a ring of Q, dO and rows tiles (64 q rows) runs over the
//      G q heads of the group and the band's q tiles.  Warpgroup w
//      computes S^T and dP^T for the tile's q columns [32 w, 32 w + 32)
//      (m64n32 products, K the A operand), P^T and dS^T in f32, and
//      writes their bf16 parts into shared memory (64 x 64, the
//      128-byte-swizzled K-major layout wgmma reads as A).  After a block
//      barrier warpgroup 0 runs dV += P^T.dO and warpgroup 1 dK += dS^T.Q
//      over all 64 q rows, A from shared memory, B the dO or Q tile
//      MN-major, N = DP: each warpgroup holds one (64, DP) accumulator,
//      DP / 2 registers a thread (DP at Dh 256, beside S^T and dP^T, would
//      not fit if one warpgroup held both dK and dV).  A second barrier
//      frees P^T and dS^T for the next tile.  The group's sum stays in the
//      block: no atomics, and two calls give the same bits.
//
// Shared memory (bytes; a block may use 232,448, of which 1,024 go to
// aligning the swizzle atoms):
//                 Q+dO            K/V ring             total
//  dq <192,2,2,1> 2*128*192*2     2 * 2*64*192*2       197,672
//  dq <256,1,2,1> 2*64*256*2      2 * 2*64*256*2       197,672
//  dq <64,2,2,3>  2*3*128*64*2    2 * 2*3*64*64*2      197,672
//  dq <128,1,1,3> 2*3*64*128*2    1 * 2*3*64*128*2     197,656
//                 K+V (resident)  Q/dO/rows ring        P^T,dS^T total
//  dkdv <192,3,1> 2*64*192*2      3 * (2*64*192*2+512)  2*8192  215,608
//  dkdv <256,2,1> 2*64*256*2      2 * (2*64*256*2+512)  2*8192  215,080
//  dkdv <64,3,3>  2*3*64*64*2     3 * (2*3*64*64*2+512) 4*8192  231,992
//  dkdv <128,1,3> 2*3*64*128*2    1 * (2*3*64*128*2+512) 4*8192 230,936
// Float32 past Dh 128 does not fit: at DP 192 K and V resident in three
// parts take 144 KB and one Q/dO stage another 144 KB (288 KB before
// P^T and dS^T; the dq kernel's Q and dO alone at 64 rows 144 KB beside
// a 144 KB K/V stage), so float32 at Dh in (128, 256] stays on the simt
// kernels (ops.bwd_route).  A single-stage ring (Dh 128's dq and dkdv)
// loads the next tile only after the block is done with the last.
//
// Registers a thread: dq: dQ's DP/2 + S's and dP's 32 each + the dS
// fragments' 16 a part (at <256,1,2,1>: 128 + 64 + 16 = 208, one
// warpgroup a block); dkdv: the accumulator's DP/2 + S^T's and dP^T's 16
// each (at DP 256: 160).  Blocks are 128 or 256 threads, no producer
// warp (see flash_attention_bwd.cu's note 4): thread 0 issues the loads,
// up to STAGES - 1 tiles ahead.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_attention_parts.cuh"

namespace fa_bwd_parts {
// element strides of (B, S, heads), as hopper.cuh's Strides (which has
// internal linkage, so cannot cross between the two sources)
struct Str {
  long long b, s, h;
};

// one launch of the dq or dkdv kernel: the operands the products read
// (the parts for float32; q, k, v, dout themselves for bfloat16), the
// rows buffer and the outputs
struct Args {
  const void *qp, *kp, *vp, *dop;
  const float* rows;
  void *dq, *dk, *dv;
  int B, S, H, KV, Dh;
  Str qps, kps, vps, dops, dqs, dks, dvs;
  int causal, window;
};

// the float32 instances (flash_attention_bwd_parts_f32.cu)
cudaError_t dq_f32(const Args& a, cudaStream_t st);
cudaError_t dkdv_f32(const Args& a, cudaStream_t st);
}  // namespace fa_bwd_parts

namespace {

using fa_bwd_parts::Args;

Strides strides(fa_bwd_parts::Str x) { return Strides{x.b, x.s, x.h}; }

template <int PARTS>
using Out = std::conditional_t<PARTS == 3, float, __nv_bfloat16>;

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" :: "r"(addr), "r"(v) : "memory");
}

// the byte offset of (row, col), col even, in a 64 x 64 bf16 tile of
// 128-byte swizzled rows (one column block)
__device__ __forceinline__ uint32_t swz64(int row, int col) {
  return row * 128 + ((((col / 8) ^ (row % 8)) * 16) | ((col % 8) * 2));
}

// ---------------------------------------------------------------- prep
template <typename T, int PARTS>
__global__ void __launch_bounds__(256)
fa_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ o,
                   const T* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ rows,
                   __nv_bfloat16* __restrict__ qp,
                   __nv_bfloat16* __restrict__ kp,
                   __nv_bfloat16* __restrict__ vp,
                   __nv_bfloat16* __restrict__ dop, int B, int S, int S_pad,
                   int H, int KV, int Dh, int DP, Strides qs, Strides ks,
                   Strides vs, Strides os, Strides dos) {
  const int lane = threadIdx.x % 32;
  const long long w = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const long long nq = (long long)B * H * S_pad;
  if (w < nq) {                      // a q row: w = (b * H + h) * S_pad + s
    const int s = (int)(w % S_pad), h = (int)(w / S_pad % H);
    const int b = (int)(w / S_pad / H);
    float l = 0.f, del = 0.f;
    if (s < S) {
      const T* orow = o + b * os.b + s * os.s + h * os.h;
      const T* drow = dout + b * dos.b + s * dos.s + h * dos.h;
      for (int d = lane; d < Dh; d += 32)
        del = __fmaf_rn(as_f32(drow[d]), as_f32(orow[d]), del);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        del += __shfl_xor_sync(0xffffffffu, del, off);
      l = lse[((long long)b * H + h) * S + s] * LOG2E;
      if constexpr (PARTS == 3) {
        const long long r = ((long long)b * S + s) * H + h;
        split_row(qp + r * 3 * DP, q + b * qs.b + s * qs.s + h * qs.h, Dh,
                  DP, lane);
        split_row(dop + r * 3 * DP, drow, Dh, DP, lane);
      }
    }
    if (lane == 0) reinterpret_cast<float2*>(rows)[w] = make_float2(l, del);
    return;
  }
  if constexpr (PARTS == 3) {        // a kv row: (b * S + s) * KV + kvh
    const long long r = w - nq;
    if (r >= (long long)B * S * KV) return;
    const int kvh = (int)(r % KV), s = (int)(r / KV % S);
    const int b = (int)(r / KV / S);
    split_row(kp + r * 3 * DP, k + b * ks.b + s * ks.s + kvh * ks.h, Dh, DP,
              lane);
    split_row(vp + r * 3 * DP, v + b * vs.b + s * vs.s + kvh * vs.h, Dh, DP,
              lane);
  }
}

// ------------------------------------------------------------------ dq
template <int DP, int WGS, int STAGES, int PARTS>
struct DqPartsCfg {
  static constexpr int BK = 64;                    // keys of a ring tile
  static constexpr int QROWS = 64 * WGS;
  static constexpr int CB = DP / 64;               // column blocks a part
  static constexpr int THREADS = 128 * WGS;
  static constexpr uint32_t Q_BYTES = PARTS * QROWS * DP * 2;  // Q or dO
  static constexpr uint32_t KV_BYTES = PARTS * BK * DP * 2;    // K or V
  static constexpr uint32_t OFF_DO = Q_BYTES;
  static constexpr uint32_t OFF_K = 2 * Q_BYTES;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // barriers: q, full[STAGES], empty[STAGES]
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(SMEM <= SMEM_LIMIT, "dq parts tiles exceed shared memory");
};

template <int DP, int WGS, int STAGES, int PARTS>
__global__ void __launch_bounds__(128 * WGS, 1)
fa_bwd_dq_parts_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ rows,
                       Out<PARTS>* __restrict__ dq, int S, int S_pad,
                       int group, int Dh, Strides dqs, int causal,
                       int window, float scale, float scale_log2) {
  using C = DqPartsCfg<DP, WGS, STAGES, PARTS>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + C::OFF_DO, sK = base + C::OFF_K,
                 sV = base + C::OFF_V;
  const uint32_t bar_q = base + C::OFF_BAR;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::QROWS;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int k_end = causal ? min(q0 + C::QROWS, S) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int k_first = (k_begin / BK) * BK;
  const int ntiles = (k_end - k_first + BK - 1) / BK;

  Ring<STAGES> ring;
  auto load_kv = [&](int stage, uint32_t full) {
    const int k0 = k_first + ring.next * BK;
    mbar_expect_tx(full, 2 * C::KV_BYTES);
    for (int p = 0; p < PARTS; ++p)
      for (int c = 0; c < C::CB; ++c) {
        const uint32_t off = stage * C::KV_BYTES + (p * C::CB + c) * BK * 128;
        tma_load(sK + off, &tk, full, p * DP + 64 * c, kvh, k0, b);
        tma_load(sV + off, &tv, full, p * DP + 64 * c, kvh, k0, b);
      }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * WGS);     // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
    for (int p = 0; p < PARTS; ++p)
      for (int c = 0; c < C::CB; ++c) {
        const uint32_t off = (p * C::CB + c) * C::QROWS * 128;
        tma_load(sQ + off, &tq, bar_q, p * DP + 64 * c, h, q0, b);
        tma_load(sdO + off, &tdo, bar_q, p * DP + 64 * c, h, q0, b);
      }
  }
  __syncthreads();

  // warpgroup wg: rows qw0 .. qw0+63; this thread holds rows qpos0 and
  // qpos0 + 8 of every accumulator, at columns 8j + cq, +1
  const int wg = warp / 4;
  const int qw0 = q0 + 64 * wg;
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;
  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
  const int cq = 2 * (lane % 4);
  const int ksteps = (Dh + 15) / 16;
  const uint32_t rows_off = 64 * wg * 128;
  constexpr uint32_t Q_PART = C::CB * C::QROWS * 128;
  constexpr uint32_t KV_PART = C::CB * BK * 128;

  const long long bh = (long long)b * gridDim.y + h;
  const float2* rr = reinterpret_cast<const float2*>(rows) + bh * S_pad;
  const float2 rw0 = qpos0 < S_pad ? rr[qpos0] : make_float2(0.f, 0.f);
  const float2 rw1 = qpos1 < S_pad ? rr[qpos1] : make_float2(0.f, 0.f);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);
  __syncwarp();
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    if (tid == 0)
      while (ring.next < min(ntiles, t + STAGES))
        ring.issue(bar_full, bar_empty, load_kv);
    const int k0 = k_first + t * BK;
    mbar_wait(bar_full + 8 * stage, phase);
    __syncwarp();
    const bool dead = qw0 >= S || (causal && k0 > qw0 + 63) ||
                      (window && k0 + BK - 1 <= qw0 - window);
    if (!dead) {
      const uint32_t sKs = sK + stage * C::KV_BYTES;
      const uint32_t sVs = sV + stage * C::KV_BYTES;
      float s[BK / 2], dp[BK / 2], s_hh[BK / 2], dp_hh[BK / 2];
      wgmma_fence();
      parts_rows_product<BK, PARTS>(s, s_hh, sQ + rows_off, Q_PART,
                                    C::QROWS * 128, sKs, KV_PART, BK * 128,
                                    ksteps);
      parts_rows_product<BK, PARTS>(dp, dp_hh, sdO + rows_off, Q_PART,
                                    C::QROWS * 128, sVs, KV_PART, BK * 128,
                                    ksteps);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);
      reg_fence(dp);
      if constexpr (PARTS == 3) {
        reg_fence(s_hh);
        reg_fence(dp_hh);
      }
      sum_terms<PARTS>(s, s_hh);
      sum_terms<PARTS>(dp, dp_hh);

      const bool edge = k0 + BK > S || qw0 + 64 > S ||
                        (causal && k0 + BK - 1 > qw0) ||
                        (window && k0 <= qw0 + 63 - window);
      constexpr int AP = APARTS<PARTS>;
      uint32_t fa[AP][BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const bool lo = i % 4 < 2;
        const float2 rw = lo ? rw0 : rw1;
        float p0 = prob(s[i], scale_log2, rw.x);
        float p1 = prob(s[i + 1], scale_log2, rw.x);
        if (edge) {
          const int kpos = k0 + 8 * (i / 4) + cq, qpos = lo ? qpos0 : qpos1;
          if (!live(qpos, kpos, S, causal, window)) p0 = 0.f;
          if (!live(qpos, kpos + 1, S, causal, window)) p1 = 0.f;
        }
        to_parts<AP>(p0 * (dp[i] - rw.y) * scale,
                     p1 * (dp[i + 1] - rw.y) * scale, fa[0][i / 2],
                     fa[AP - 1][i / 2]);
      }
      // dQ += dS.K, term by term (into dQ itself: a row's band is at most
      // S / 64 tiles, and an accumulator of the tile's own, as the dkdv
      // kernel's, moved no error measured at the float32 rows and spilled
      // at Dh 128)
      constexpr int NT = ATERMS<PARTS>;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NT; ++j)
        frag_product<DP, BK>(acc, fa[aterm_a(j, NT)],
                             sKs + aterm_b(j, NT) * KV_PART);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
    }
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
    ring_next<STAGES>(stage, phase);
  }

  Out<PARTS>* qb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const bool lo = i % 4 < 2;
    const int qpos = lo ? qpos0 : qpos1, col = 8 * (i / 4) + cq;
    if (qpos < S && col < Dh)
      store_pair(qb + qpos * dqs.s + col, acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------- dkdv
template <int DP, int STAGES, int PARTS>
struct KvPartsCfg {
  static constexpr int KROWS = 64;                 // keys of a block
  static constexpr int BQ = 64;                    // q rows of a ring tile
  static constexpr int CB = DP / 64;
  static constexpr int THREADS = 256;              // two warpgroups
  static constexpr uint32_t KV_BYTES = PARTS * KROWS * DP * 2;  // K or V
  static constexpr uint32_t Q_BYTES = PARTS * BQ * DP * 2;   // Q or dO
  static constexpr uint32_t ROW_BYTES = BQ * 8;              // (lse2, delta)
  static constexpr uint32_t PT_BYTES = KROWS * BQ * 2;       // a P^T part
  static constexpr int AP = APARTS<PARTS>;
  static constexpr uint32_t OFF_V = KV_BYTES;
  static constexpr uint32_t OFF_Q = 2 * KV_BYTES;
  static constexpr uint32_t OFF_DO = OFF_Q + STAGES * Q_BYTES;
  static constexpr uint32_t OFF_P = OFF_DO + STAGES * Q_BYTES;
  static constexpr uint32_t OFF_DS = OFF_P + AP * PT_BYTES;
  static constexpr uint32_t OFF_ROWS = OFF_DS + AP * PT_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_ROWS + STAGES * ROW_BYTES;
  // barriers: kv, full[STAGES], empty[STAGES]
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(SMEM <= SMEM_LIMIT, "dkdv parts tiles exceed shared memory");
};

template <int DP, int STAGES, int PARTS>
__global__ void __launch_bounds__(256, 1)
fa_bwd_dkdv_parts_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ rows,
                         Out<PARTS>* __restrict__ dk,
                         Out<PARTS>* __restrict__ dv, int S, int S_pad,
                         int H, int group, int Dh, Strides dks, Strides dvs,
                         int causal, int window, float scale,
                         float scale_log2) {
  using C = KvPartsCfg<DP, STAGES, PARTS>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* sp = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + C::OFF_V, sQ = base + C::OFF_Q,
                 sdO = base + C::OFF_DO, sP = base + C::OFF_P,
                 sdS = base + C::OFF_DS, sR = base + C::OFF_ROWS;
  const uint32_t bar_kv = base + C::OFF_BAR;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * C::KROWS;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window ? min(S, k0 + C::KROWS - 1 + window) : S;
  const int q_first = (q_begin / BQ) * BQ;
  const int nq = (q_end - q_first + BQ - 1) / BQ;
  const int ntiles = group * nq;

  Ring<STAGES> ring;
  auto load_q = [&](int stage, uint32_t full) {
    const int h = kvh * group + ring.next / nq;
    const int q0 = q_first + (ring.next % nq) * BQ;
    mbar_expect_tx(full, 2 * C::Q_BYTES + C::ROW_BYTES);
    for (int p = 0; p < PARTS; ++p)
      for (int c = 0; c < C::CB; ++c) {
        const uint32_t off = stage * C::Q_BYTES + (p * C::CB + c) * BQ * 128;
        tma_load(sQ + off, &tq, full, p * DP + 64 * c, h, q0, b);
        tma_load(sdO + off, &tdo, full, p * DP + 64 * c, h, q0, b);
      }
    bulk_load(sR + stage * C::ROW_BYTES,
              rows + 2 * (((long long)b * H + h) * S_pad + q0), C::ROW_BYTES,
              full);
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);          // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
    for (int p = 0; p < PARTS; ++p)
      for (int c = 0; c < C::CB; ++c) {
        const uint32_t off = (p * C::CB + c) * C::KROWS * 128;
        tma_load(sK + off, &tk, bar_kv, p * DP + 64 * c, kvh, k0, b);
        tma_load(sV + off, &tv, bar_kv, p * DP + 64 * c, kvh, k0, b);
      }
  }
  __syncthreads();

  // warpgroup wg: S^T and dP^T at the tile's q columns [32 wg, 32 wg +
  // 32), then dV (wg 0) or dK (wg 1); this thread holds key rows kpos0
  // and kpos0 + 8 of every accumulator, at columns 8j + cq, +1
  const int wg = warp / 4;
  const int krow0 = 16 * (warp % 4) + lane / 4;
  const int kpos0 = k0 + krow0, kpos1 = kpos0 + 8;
  const int cq = 2 * (lane % 4);
  const int ksteps = (Dh + 15) / 16;
  constexpr uint32_t K_PART = C::CB * C::KROWS * 128;
  constexpr uint32_t Q_PART = C::CB * BQ * 128;
  constexpr int NT = ATERMS<PARTS>;
  const uint32_t sA = wg == 0 ? sP : sdS;          // P^T or dS^T
  const uint32_t sB = wg == 0 ? sdO : sQ;          // dO or Q

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_kv, 0);
  __syncwarp();
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    if (tid == 0)
      while (ring.next < min(ntiles, t + STAGES))
        ring.issue(bar_full, bar_empty, load_q);
    const int q0 = q_first + (t % nq) * BQ;
    mbar_wait(bar_full + 8 * stage, phase);
    __syncwarp();
    const bool dead = k0 >= S || (causal && q0 + BQ - 1 < k0) ||
                      (window && q0 - (k0 + 63) >= window);
    if (!dead) {                                   // the same for the block
      const uint32_t sQs = sQ + stage * C::Q_BYTES;
      const uint32_t sdOs = sdO + stage * C::Q_BYTES;
      const int qc0 = q0 + 32 * wg;                // this warpgroup's q rows
      const bool idle = qc0 >= S || (causal && qc0 + 31 < k0) ||
                        (window && qc0 - (k0 + 63) >= window);
      float st[16], dpt[16], st_hh[16], dpt_hh[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;
      if (!idle) {
        wgmma_fence();
        parts_rows_product<32, PARTS>(st, st_hh, sK, K_PART,
                                      C::KROWS * 128, sQs + 32 * wg * 128,
                                      Q_PART, BQ * 128, ksteps);
        parts_rows_product<32, PARTS>(dpt, dpt_hh, sV, K_PART,
                                      C::KROWS * 128, sdOs + 32 * wg * 128,
                                      Q_PART, BQ * 128, ksteps);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(st);
        reg_fence(dpt);
        if constexpr (PARTS == 3) {
          reg_fence(st_hh);
          reg_fence(dpt_hh);
        }
        sum_terms<PARTS>(st, st_hh);
        sum_terms<PARTS>(dpt, dpt_hh);
      }
      // P^T and dS^T (lse2, delta by the accumulator's column), their
      // parts into shared memory at (key row, q column)
      const float4* r = reinterpret_cast<const float4*>(
          sp + C::OFF_ROWS + stage * C::ROW_BYTES);
      const bool edge = k0 + 64 > S || q0 + BQ > S ||
                        (causal && k0 + 63 > q0) ||
                        (window && k0 <= q0 + BQ - 1 - window);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const bool lo = i % 4 < 2;
        const int col = 32 * wg + 8 * (i / 4) + cq;
        float p0 = 0.f, p1 = 0.f, d0 = 0.f, d1 = 0.f;
        if (!idle) {
          const float4 ld = r[col / 2];            // lse2, delta of col, +1
          p0 = prob(st[i], scale_log2, ld.x);
          p1 = prob(st[i + 1], scale_log2, ld.z);
          if (edge) {
            const int kpos = lo ? kpos0 : kpos1;
            if (!live(q0 + col, kpos, S, causal, window)) p0 = 0.f;
            if (!live(q0 + col + 1, kpos, S, causal, window)) p1 = 0.f;
          }
          d0 = p0 * (dpt[i] - ld.y) * scale;
          d1 = p1 * (dpt[i + 1] - ld.w) * scale;
        }
        const uint32_t at = swz64(krow0 + (lo ? 0 : 8), col);
        uint32_t ph, pl, dh, dl;
        to_parts<C::AP>(p0, p1, ph, pl);
        to_parts<C::AP>(d0, d1, dh, dl);
        sts_u32(sP + at, ph);
        sts_u32(sdS + at, dh);
        if constexpr (C::AP == 2) {
          sts_u32(sP + C::PT_BYTES + at, pl);
          sts_u32(sdS + C::PT_BYTES + at, dl);
        }
      }
      fence_proxy_async();
      __syncthreads();                             // P^T and dS^T complete
      // dV += P^T.dO (warpgroup 0) or dK += dS^T.Q (warpgroup 1) over the
      // tile's 64 q rows, term by term; for three parts the tile's terms
      // in an accumulator of their own, added to dK or dV in f32 (round to
      // nearest), so that the truncation does not build up over the G
      // heads' q tiles (at the float32 check row's G S / 64 = 64 tiles the
      // largest error fell from 0.695 to 0.374 of the tolerance, with the
      // recomputations' hi.hi split off)
      const uint32_t sBs = sB + stage * C::Q_BYTES;
      auto terms = [&](float (&d)[DP / 2], bool fresh) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t a = sA + aterm_a(j, NT) * C::PT_BYTES;
          const uint32_t bb = sBs + aterm_b(j, NT) * Q_PART;
#pragma unroll
          for (int tt = 0; tt < BQ / 16; ++tt)
            wgmma_ss_t<DP>(d, smem_desc(a + tt * 32, 16, 1024),
                           smem_desc(bb + tt * 16 * 128, BQ * 128, 1024),
                           !fresh || j > 0 || tt > 0);
        }
      };
      if constexpr (PARTS == 3) {
        float part[DP / 2];
        wgmma_fence();
        terms(part, true);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(part);
        sum_terms<PARTS>(acc, part);
      } else {
        wgmma_fence();
        terms(acc, false);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
      }
      __syncthreads();                   // P^T and dS^T read: free to write
    }
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
    ring_next<STAGES>(stage, phase);
  }

  Out<PARTS>* ob = wg == 0 ? dv + b * dvs.b + kvh * dvs.h
                           : dk + b * dks.b + kvh * dks.h;
  const long long os = wg == 0 ? dvs.s : dks.s;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const bool lo = i % 4 < 2;
    const int kpos = lo ? kpos0 : kpos1, col = 8 * (i / 4) + cq;
    if (kpos < S && col < Dh)
      store_pair(ob + kpos * os + col, acc[i], acc[i + 1]);
  }
}

// --------------------------------------------------------------- launch
// the columns of the operand tensors' maps: Dh for bfloat16 (TMA's zero
// fill pads it to DP), the parts' 3 DP for float32
template <int DP, int PARTS>
int map_cols(int Dh) {
  return PARTS == 1 ? Dh : PARTS * DP;
}


template <int DP, int WGS, int STAGES, int PARTS>
cudaError_t launch_dq_parts(const Args& a, cudaStream_t st) {
  using C = DqPartsCfg<DP, WGS, STAGES, PARTS>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int cols = map_cols<DP, PARTS>(a.Dh);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(fn, &tq, a.qp, a.B, a.S, a.H, cols, strides(a.qps),
              C::QROWS) ||
      !encode(fn, &tk, a.kp, a.B, a.S, a.KV, cols, strides(a.kps), C::BK) ||
      !encode(fn, &tv, a.vp, a.B, a.S, a.KV, cols, strides(a.vps), C::BK) ||
      !encode(fn, &tdo, a.dop, a.B, a.S, a.H, cols, strides(a.dops),
              C::QROWS))
    return cudaErrorInvalidValue;
  auto kernel = fa_bwd_dq_parts_kernel<DP, WGS, STAGES, PARTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + C::QROWS - 1) / C::QROWS, a.H, a.B);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, tdo, a.rows, static_cast<Out<PARTS>*>(a.dq), a.S,
      rows_pad(a.S), a.H / a.KV, a.Dh, strides(a.dqs), a.causal,
      a.window, scale_of(a.Dh), scale_log2_of(a.Dh));
  return cudaGetLastError();
}

template <int DP, int STAGES, int PARTS>
cudaError_t launch_dkdv_parts(const Args& a, cudaStream_t st) {
  using C = KvPartsCfg<DP, STAGES, PARTS>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int cols = map_cols<DP, PARTS>(a.Dh);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(fn, &tq, a.qp, a.B, a.S, a.H, cols, strides(a.qps), C::BQ) ||
      !encode(fn, &tk, a.kp, a.B, a.S, a.KV, cols, strides(a.kps),
              C::KROWS) ||
      !encode(fn, &tv, a.vp, a.B, a.S, a.KV, cols, strides(a.vps),
              C::KROWS) ||
      !encode(fn, &tdo, a.dop, a.B, a.S, a.H, cols, strides(a.dops),
              C::BQ))
    return cudaErrorInvalidValue;
  auto kernel = fa_bwd_dkdv_parts_kernel<DP, STAGES, PARTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + C::KROWS - 1) / C::KROWS, a.KV, a.B);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, tdo, a.rows, static_cast<Out<PARTS>*>(a.dk),
      static_cast<Out<PARTS>*>(a.dv), a.S, rows_pad(a.S), a.H, a.H / a.KV,
      a.Dh, strides(a.dks), strides(a.dvs), a.causal, a.window,
      scale_of(a.Dh), scale_log2_of(a.Dh));
  return cudaGetLastError();
}

}  // namespace
