// FlashAttention backward: dq, dk and dv of softmax attention from the
// forward's saved (q, k, v, out, lse), recomputing the probabilities tile
// by tile, causal, windowed or non-causal, with GQA.
//
// Replaces: src/repro/kernels/flash_attention/jnp_impl.py, _bwd_vjp -- the
// jnp FA2 two-pass backward that the reference's custom VJP
// (kernels/flash_attention/ops.py, _bwd) runs under its Pallas forward: a
// scan over k blocks (dK/dV), a scan over q blocks (dQ), each recomputing
// what _block_grads computes.  Not a Pallas kernel; ported by hand all the
// same, since it is the one piece of attention training that would
// otherwise run as a chain of eager ops.
//
// What it computes, per (q row i, key j) inside the band (causal j <= i,
// window j > i - window) and inside S:
//   p  = exp(q_i.k_j * scale - lse_i)                (f32)
//   dp = do_i.v_j                                     (f32)
//   ds = p * (dp - delta_i) * scale,   delta_i = rowsum(do_i * out_i)
// and outside the band p = ds = 0 (the reference's finite NEG_INF gives
// exp(NEG_INF - lse) = 0 exactly, and it zeroes ds there).  p and ds are
// rounded to q's type before their products, as p.astype(q.dtype) and
// ds.astype(q.dtype) do; dv = P^T.dO, dk = dS^T.Q and dq = dS.K are summed
// in f32 and cast to the inputs' types once.  The reference rounds q.k and
// do.v to q's type (its einsums return bf16) and each block's partial
// products too; these kernels keep all of them in f32.  The SIMT route
// forms p with expf, as the plain version does; the wgmma route as
// exp2(fma(q.k, scale * log2(e), -lse * log2(e))), a few f32 ulps from
// it, so p or ds rounds to the other bf16 neighbour in ~5e-5 of the pairs
// and, with the tensor cores' order of summation, dk and dv differ from
// the plain version's by one bf16 step in ~0.4% of elements
// (benchmarks/torch_flash_bwd_ulps.py).
//
// Two routes, chosen by ops.bwd_route from the inputs' dtype and head
// dim; neither falls back to the other.  The wgmma route is this file's
// pair for bfloat16 with Dh <= 128 and, for bfloat16 past 128 and float32
// up to 128, the parts kernels of flash_attention_bwd_parts.cuh; the simt
// route (float32 past Dh 128) is this file's SIMT kernels.
//
// bfloat16 with Dh <= 128, the pair: two kernels on Hopper's TMA,
// mbarriers and wgmma, launched in this order on one stream:
//  (1) fa_bwd_dq_wgmma_kernel: one block per (b, q head, tile of 128 q
//      rows), two warpgroups of 64 rows.  TMA loads the block's Q, dO and
//      O tiles; the warpgroups compute delta = rowsum(dO * O) in f32 from
//      shared memory (a row's 16-byte chunks are swizzled within the row,
//      the same way in both tiles, so the products pair up unswizzled) and
//      write each row's (lse * log2(e), delta) into the rows buffer (B, H,
//      S_pad, 2), zeros past S.  Then over the K/V tiles of the band (a
//      3-stage TMA ring): S = Q.K^T and dP = dO.V^T by wgmma from shared
//      memory, P and dS in f32 registers, dQ += dS.K by wgmma with dS as
//      the register A operand.  (BK = 128 keys at Dh <= 64, 64 above.)  The
//      last q tiles, which visit the most k tiles, start first.
//  (2) fa_bwd_dkdv_wgmma_kernel: one block per (b, kv head, tile of 64
//      keys), one warpgroup (two blocks an SM; 128 keys in two warpgroups
//      measured slower at every shape of chip_smoke.py's FA_BWD_CHECKS
//      but gemma3-27b's local window, PERF.md).  The K and V tiles are
//      loaded once and stay resident; a ring of Q and dO tiles (TMA) and of their 64 rows'
//      (lse * log2(e), delta) pairs (one 512-byte bulk copy from the rows
//      buffer, which S_pad keeps aligned) runs over the G q heads of the
//      GQA group and the q tiles of the band.  For each: S^T = K.Q^T and
//      dP^T = V.dO^T (lse and delta indexed by the accumulator's column),
//      P^T and dS^T rounded to bf16 as register A operands, dV += P^T.dO
//      and dK += dS^T.Q.  The group's sum stays in the block's registers:
//      no atomics, and two calls give the same bits.  The first key tiles,
//      which see the most q tiles under the causal mask, start first.
// What the design does about each limit of the SIMT version below:
//  1. Arithmetic.  All seven products (q.k and do.v recomputed in each
//     kernel, P^T.dO, dS^T.Q, dS.K) run on the tensor cores, bf16 in and
//     f32 accumulation: the recomputations in the forward's S = Q.K^T form
//     (both operands K-major from shared memory), the three accumulations
//     in its O += P.V form (A the bf16 register fragment made pair by pair
//     from an f32 accumulator, B a (rows, Dh) tile with Dh contiguous,
//     MN-major, the forward's V descriptor).
//  2. Staging.  TMA copies whole bf16 tiles through the 4-D (Dh, heads,
//     S, B) maps of the tensors' own strides, 128-byte swizzled, the
//     layout wgmma reads without bank conflicts; its zero fill pads Dh to
//     64 or 128 and the rows past S.  No thread converts or addresses an
//     element of a tile on the way in.
//  3. Shared-memory reads.  P, dS and their transposes never touch shared
//     memory: each is the accumulator of one product and, rounded to bf16
//     pair by pair, the A operand of the next.  Shared memory is read only
//     by wgmma's operand fetch.  delta is computed once, by the dq pass,
//     from the O and dO tiles it loads anyway: the separate delta kernel
//     and its launch are gone from this route.
//  4. Tiles and registers.  A block is two (dq) or one (dkdv) warpgroups
//     and nothing else: ptxas holds a block of more than 8 warps at 168
//     registers a thread, with or without setmaxnreg (the SSD kernel's
//     finding, seen again here with a 9th, producer warp: every instance
//     spilled and ptxas serialized its wgmmas), while 8 warps get 255,
//     which dq's S and dP (64 each at BK 128) and dkdv's dK and dV (64
//     each at Dh 128) beside S^T and dP^T need.  Only tiles that cross
//     the band's edge or S are masked; a warpgroup whose rows see no key
//     of a tile skips its products (it still waits for the tile, so its
//     release of the stage counts toward the right phase).
//  5. Overlap.  Across warpgroups: one's products fill the tensor cores
//     while another does its exponentials (two warpgroups a block, and
//     two 64-key dkdv blocks an SM).  Within a warpgroup the products and
//     the element-wise work alternate: splitting the recomputations into
//     two commit groups, or running a tile's accumulating products on
//     under the next tile's, made ptxas serialize the wgmmas or spill,
//     and was slower on the card.  One thread of warpgroup 0 issues the
//     loads (no producer warp: see 4), up to two tiles ahead in a 3-stage
//     ring (one in the 2-stage ring of the 64-key dkdv block at Dh 128,
//     whose 97 KB let two blocks share an SM: 0.26 -> 0.20 ms at gemma3's
//     window shape on an H100 80GB HBM3 at 700 W).
// p = exp2(s * log2(e)/sqrt(Dh) - lse * log2(e)) (one FMA and one ex2: the
// SFU's rate, 16 a clock an SM, bounds the element-wise work), ds = p *
// (dp - delta) * scale, as above; q.k and do.v are f32 accumulators.
//
// float32 with Dh in (128, 256] (and any input a test or chip_smoke.py
// hands their wrappers): the SIMT kernels below, launched in this order
// on one stream:
//  (a) fa_bwd_delta_kernel: delta = rowsum(dO * O) in f32, one warp a row.
//  (b) fa_bwd_dkdv_kernel: one block per (b, kv head, tile of BK keys).
//      It loops over the G q heads of its GQA group and, for each, over
//      the q tiles that hold a row inside the keys' band, and accumulates
//      dK and dV in registers: the group's sum happens inside the block,
//      so there are no atomics and the result is deterministic.  Blocks of
//      the first k tiles, which see the most q tiles under the causal mask,
//      start first.
//  (c) fa_bwd_dq_kernel: one block per (b, q head, tile of BQ rows), over
//      the k tiles of its band (the forward's loop); the last q tiles,
//      which visit the most k tiles, start first.
//
// The SIMT kernels are the first, simple design: f32 on the CUDA cores,
// with every tile
// staged in shared memory as f32 through the tensors' strides (no
// transposed copy, no alignment needed) and rows padded by one word so
// that a warp's column reads hit 32 banks.  256 threads as a 16 x 16 grid:
// thread (ty, tx) owns rows ty + 16r and columns tx + 16c of each tile it
// computes.  (BQ, BK) = (64, 64) for head dims up to 128, (32, 32) up to
// 256 (shared memory: 100, 166 and 141 KB at DMAX 64, 128, 256).
//
// What bounds it on the H100: at granite-3-2b's training shape (B=8,
// S=1024, H=32, KV=8, Dh=64, bf16, causal) the function's five products
// over its live query-key pairs (q.k and do.v recomputed, P^T.dO, dS^T.Q,
// dS.K) are 5 * 2 * B*H*Dh*S(S+1)/2 = 86.0 GFLOP, 0.087 ms at the tensor
// cores' 989 TFLOP/s, against 0.050 ms for its 169 MB at 3.35 TB/s:
// operations bound it.  The wgmma route runs seven products (both kernels
// recompute q.k and do.v), so its own floor is 7/5 of that, 0.122 ms.
// The SIMT kernels run on the CUDA cores (67 TFLOP/s f32 at best), and
// their inner products are bounded by their shared-memory reads (each
// thread reads 2 words a multiply-add), so they stay far above the bound.
//
// The library is built with --fmad=false: every multiply-add that should
// fuse is spelled __fmaf_rn.  Parity with the plain version is held by
// tolerance, not bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "flash_attention_bwd.cuh"

namespace {

constexpr int BW_TX = 16;            // threads along keys / head dim
constexpr int BW_TY = 16;            // threads along rows
constexpr int BW_THREADS = BW_TX * BW_TY;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: p.astype(q.dtype) before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// rows r0 .. r0+ROWS-1 of a (B,S,heads,Dh) tensor's (b, head) slice into
// shared memory as f32, ROWS x LD, zero past S and past Dh
template <typename T, int ROWS, int DMAX>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int r0, int S, int Dh) {
  constexpr int LD = DMAX + 1;
  for (int e = threadIdx.x; e < ROWS * DMAX; e += BW_THREADS) {
    const int i = e / DMAX, d = e % DMAX;
    dst[i * LD + d] =
        r0 + i < S && d < Dh ? to_f32<T>(src[(r0 + i) * ss + d]) : 0.f;
  }
}

// ---------------------------------------------------------------- (a) delta
template <typename T>
__global__ void __launch_bounds__(256)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, int B, int S, int H, int Dh,
                    Strides os, Strides dos) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= (long long)B * H * S) return;
  const int s = (int)(row % S), h = (int)(row / S % H), b = (int)(row / S / H);
  const T* orow = o + b * os.b + s * os.s + h * os.h;
  const T* drow = dout + b * dos.b + s * dos.s + h * dos.h;
  float sum = 0.f;
  for (int d = lane; d < Dh; d += 32)
    sum = __fmaf_rn(to_f32<T>(drow[d]), to_f32<T>(orow[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;       // (B, H, S): row = (b*H + h)*S + s
}

// The tile's p and ds (rounded to T) into sP and sS (BQ x BK, padded),
// from the staged Q, dO (rows q0..) and K, V (keys k0..)
template <typename T, int DMAX, int BQ, int BK>
__device__ __forceinline__ void probs(const float* sQ, const float* sdO,
                                      const float* sK, const float* sV,
                                      const float* sL, const float* sDel,
                                      float* sP, float* sS, int q0, int k0,
                                      int S, int Dh, int causal, int window,
                                      float scale) {
  constexpr int LD = DMAX + 1, LDP = BK + 1;
  constexpr int RQ = BQ / BW_TY, CK = BK / BW_TX;
  const int tx = threadIdx.x % BW_TX, ty = threadIdx.x / BW_TX;
  float s[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < CK; ++c) s[r][c] = dp[r][c] = 0.f;
  for (int d = 0; d < Dh; ++d) {
    float qr[RQ], dr[RQ], kc[CK], vc[CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      qr[r] = sQ[(ty + r * BW_TY) * LD + d];
      dr[r] = sdO[(ty + r * BW_TY) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      kc[c] = sK[(tx + c * BW_TX) * LD + d];
      vc[c] = sV[(tx + c * BW_TX) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        s[r][c] = __fmaf_rn(qr[r], kc[c], s[r][c]);
        dp[r][c] = __fmaf_rn(dr[r], vc[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = ty + r * BW_TY;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      const int j = tx + c * BW_TX;
      float p = 0.f, ds = 0.f;
      if (live(q0 + i, k0 + j, S, causal, window)) {
        p = expf(s[r][c] * scale - sL[i]);
        ds = p * (dp[r][c] - sDel[i]) * scale;
      }
      sP[i * LDP + j] = round_to<T>(p);
      sS[i * LDP + j] = round_to<T>(ds);
    }
  }
}

// ----------------------------------------------------------------- (b) dkdv
template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(BW_THREADS)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int S, int H, int group, int Dh,
                   Strides qs, Strides ks, Strides vs, Strides dos,
                   Strides dks, Strides dvs, int causal, int window,
                   float scale) {
  constexpr int LD = DMAX + 1, LDP = BK + 1;
  constexpr int RK = BK / BW_TY;     // key rows a thread owns in dK, dV
  constexpr int CD = DMAX / BW_TX;   // head-dim columns a thread owns
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;
  float* sS = sP + BQ * LDP;
  float* sL = sS + BQ * LDP;
  float* sDel = sL + BQ;

  const int tx = threadIdx.x % BW_TX, ty = threadIdx.x / BW_TX;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  stage<T, BK, DMAX>(sK, k + b * ks.b + kvh * ks.h, ks.s, k0, S, Dh);
  stage<T, BK, DMAX>(sV, v + b * vs.b + kvh * vs.h, vs.s, k0, S, Dh);

  float acc_k[RK][CD], acc_v[RK][CD];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  // q rows that see a key of k0 .. k0+BK-1: from k0 under the causal mask,
  // below k0+BK-1+window under a window
  const int q_begin = causal ? k0 : 0;
  const int q_end = window ? min(S, k0 + BK - 1 + window) : S;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * dos.b + h * dos.h;
    const float* lrow = lse + ((long long)b * H + h) * S;
    const float* drow = delta + ((long long)b * H + h) * S;
    for (int q0 = (q_begin / BQ) * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();               // the previous tile's readers are done
      stage<T, BQ, DMAX>(sQ, qb, qs.s, q0, S, Dh);
      stage<T, BQ, DMAX>(sdO, db, dos.s, q0, S, Dh);
      for (int i = threadIdx.x; i < BQ; i += BW_THREADS) {
        sL[i] = q0 + i < S ? lrow[q0 + i] : 0.f;
        sDel[i] = q0 + i < S ? drow[q0 + i] : 0.f;
      }
      __syncthreads();
      probs<T, DMAX, BQ, BK>(sQ, sdO, sK, sV, sL, sDel, sP, sS, q0, k0, S,
                             Dh, causal, window, scale);
      __syncthreads();
      // dV += P^T.dO, dK += dS^T.Q over the tile's rows (zero past S)
      for (int i = 0; i < BQ; ++i) {
        float pr[RK], sr[RK], dc[CD], qc[CD];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          pr[r] = sP[i * LDP + ty + r * BW_TY];
          sr[r] = sS[i * LDP + ty + r * BW_TY];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dc[c] = sdO[i * LD + tx + c * BW_TX];
          qc[c] = sQ[i * LD + tx + c * BW_TX];
        }
#pragma unroll
        for (int r = 0; r < RK; ++r)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            acc_v[r][c] = __fmaf_rn(pr[r], dc[c], acc_v[r][c]);
            acc_k[r][c] = __fmaf_rn(sr[r], qc[c], acc_k[r][c]);
          }
      }
    }
  }

  T* kout = dk + b * dks.b + kvh * dks.h;
  T* vout = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int kpos = k0 + ty + r * BW_TY;
    if (kpos >= S) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + c * BW_TX;
      if (d < Dh) {
        kout[kpos * dks.s + d] = from_f32<T>(acc_k[r][c]);
        vout[kpos * dvs.s + d] = from_f32<T>(acc_v[r][c]);
      }
    }
  }
}

// ------------------------------------------------------------------- (c) dq
template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(BW_THREADS)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int S,
                 int H, int group, int Dh, Strides qs, Strides ks, Strides vs,
                 Strides dos, Strides dqs, int causal, int window,
                 float scale) {
  constexpr int LD = DMAX + 1, LDP = BK + 1;
  constexpr int RQ = BQ / BW_TY;     // q rows a thread owns in dQ
  constexpr int CD = DMAX / BW_TX;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sS = sP + BQ * LDP;
  float* sL = sS + BQ * LDP;
  float* sDel = sL + BQ;

  const int tx = threadIdx.x % BW_TX, ty = threadIdx.x / BW_TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  stage<T, BQ, DMAX>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, S, Dh);
  stage<T, BQ, DMAX>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, S, Dh);
  const float* lrow = lse + ((long long)b * H + h) * S;
  const float* drow = delta + ((long long)b * H + h) * S;
  for (int i = threadIdx.x; i < BQ; i += BW_THREADS) {
    sL[i] = q0 + i < S ? lrow[q0 + i] : 0.f;
    sDel[i] = q0 + i < S ? drow[q0 + i] : 0.f;
  }
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  float acc[RQ][CD];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.f;

  // k tiles holding a key inside the band of rows q0 .. q0+BQ-1
  const int k_end = causal ? min(q0 + BQ, S) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<T, BK, DMAX>(sK, kb, ks.s, k0, S, Dh);
    stage<T, BK, DMAX>(sV, vb, vs.s, k0, S, Dh);
    __syncthreads();
    probs<T, DMAX, BQ, BK>(sQ, sdO, sK, sV, sL, sDel, sP, sS, q0, k0, S, Dh,
                           causal, window, scale);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float sr[RQ], kc[CD];
#pragma unroll
      for (int r = 0; r < RQ; ++r) sr[r] = sS[(ty + r * BW_TY) * LDP + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) kc[c] = sK[j * LD + tx + c * BW_TX];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[r][c] = __fmaf_rn(sr[r], kc[c], acc[r][c]);
    }
  }

  T* qout = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int qpos = q0 + ty + r * BW_TY;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + c * BW_TX;
      if (d < Dh) qout[qpos * dqs.s + d] = from_f32<T>(acc[r][c]);
    }
  }
}

template <int DMAX, int BQ, int BK>
constexpr size_t bwd_smem() {
  return sizeof(float) * ((size_t)(BQ + BQ + BK + BK) * (DMAX + 1) +
                          2 * (size_t)BQ * (BK + 1) + 2 * (size_t)BQ);
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, S, H, KV, Dh;
  Strides qs, ks, vs, dos;
  int causal, window;
  float scale;
};

template <typename T, int DMAX, int BQ, int BK>
cudaError_t launch_dkdv(const BwdArgs& a, void* dk, void* dv, Strides dks,
                        Strides dvs, cudaStream_t st) {
  constexpr size_t smem = bwd_smem<DMAX, BQ, BK>();
  auto kernel = fa_bwd_dkdv_kernel<T, DMAX, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BK - 1) / BK, a.KV, a.B);
  kernel<<<grid, BW_THREADS, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.S, a.H,
      a.H / a.KV, a.Dh, a.qs, a.ks, a.vs, a.dos, dks, dvs, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int DMAX, int BQ, int BK>
cudaError_t launch_dq(const BwdArgs& a, void* dq, Strides dqs,
                      cudaStream_t st) {
  constexpr size_t smem = bwd_smem<DMAX, BQ, BK>();
  auto kernel = fa_bwd_dq_kernel<T, DMAX, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, BW_THREADS, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.S, a.H, a.H / a.KV, a.Dh, a.qs, a.ks,
      a.vs, a.dos, dqs, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// the instance of a head dim: DMAX 64, 128 at 64 x 64 tiles, 256 at 32 x 32
template <typename F64, typename F128, typename F256>
cudaError_t by_head_dim(int Dh, F64 f64, F128 f128, F256 f256) {
  if (Dh <= 64) return f64();
  if (Dh <= 128) return f128();
  return f256();
}

bool bad_shape(int B, int S, int H, int KV, int Dh, int window, int dtype) {
  return B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || Dh <= 0 ||
         Dh % 8 || Dh > 256 || B > 65535 || H > 65535 || window < 0 ||
         (dtype != 0 && dtype != 1);
}

// ---------------------------------------------------- bf16 route: wgmma
// acc + the dot product of two 16-byte chunks of 8 bf16 each (exact
// products, f32 sums)
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 u = __bfloat1622float2(a[j]), w = __bfloat1622float2(b[j]);
    acc = __fmaf_rn(u.x, w.x, acc);
    acc = __fmaf_rn(u.y, w.y, acc);
  }
  return acc;
}

template <int DP, int BK>
struct DqCfg {
  static constexpr int QROWS = 128;                // two warpgroups
  static constexpr int CB = DP / 64;               // 128-byte column blocks
  static constexpr int STAGES = 3;                 // K/V ring
  static constexpr int THREADS = 256;
  static constexpr uint32_t Q_BYTES = QROWS * DP * 2;   // Q, dO or O
  static constexpr uint32_t KV_BYTES = BK * DP * 2;     // a K or V tile
  static constexpr uint32_t OFF_DO = Q_BYTES;
  static constexpr uint32_t OFF_O = 2 * Q_BYTES;
  static constexpr uint32_t OFF_K = 3 * Q_BYTES;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // barriers: q, full[STAGES], empty[STAGES]; + 1024 for the alignment of
  // the swizzle atoms
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// rows (B, H, S_pad, 2) f32: (lse * log2(e), delta) of each q row, zero
// past S; S_pad = S rounded up to a multiple of 64, so a 64-row tile's
// 512 bytes are one aligned bulk copy
template <int DP, int BK>
__global__ void __launch_bounds__(DqCfg<DP, BK>::THREADS, 1)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       float* __restrict__ rows,
                       __nv_bfloat16* __restrict__ dq, int S, int S_pad,
                       int group, int Dh, Strides dqs, int causal,
                       int window, float scale, float scale_log2) {
  using C = DqCfg<DP, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* sp = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base, sdO = base + C::OFF_DO, sK = base + C::OFF_K,
                 sV = base + C::OFF_V;
  const uint32_t bar_q = base + C::OFF_BAR;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::QROWS;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  // k tiles holding a key inside the band of rows q0 .. min(q0+QROWS, S)-1
  const int k_end = causal ? min(q0 + C::QROWS, S) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int k_first = (k_begin / BK) * BK;
  const int ntiles = (k_end - k_first + BK - 1) / BK;

  Ring<C::STAGES> ring;
  auto load_kv = [&](int stage, uint32_t full) {
    const int k0 = k_first + ring.next * BK;
    mbar_expect_tx(full, 2 * C::KV_BYTES);
    for (int c = 0; c < C::CB; ++c) {
      const uint32_t off = stage * C::KV_BYTES + c * BK * 128;
      tma_load(sK + off, &tk, full, 64 * c, kvh, k0, b);
      tma_load(sV + off, &tv, full, 64 * c, kvh, k0, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);          // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_q, 3 * C::Q_BYTES);
    for (int c = 0; c < C::CB; ++c) {
      const uint32_t off = c * C::QROWS * 128;
      tma_load(sQ + off, &tq, bar_q, 64 * c, h, q0, b);
      tma_load(sdO + off, &tdo, bar_q, 64 * c, h, q0, b);
      tma_load(base + C::OFF_O + off, &to, bar_q, 64 * c, h, q0, b);
    }
    while (ring.next < min(ntiles, C::STAGES - 1))
      ring.issue(bar_full, bar_empty, load_kv);
  }
  __syncthreads();

  // warpgroup wg: rows qw0 .. qw0+63; this thread holds rows qpos0 and
  // qpos0 + 8 of every accumulator, at columns 8j + cq, +1
  const int wg = warp / 4;
  const int qw0 = q0 + 64 * wg;
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;   // row in the tile
  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
  const int cq = 2 * (lane % 4);
  const int ksteps = (Dh + 15) / 16;
  const uint32_t rows_off = 64 * wg * 128;         // the warpgroup's rows

  // lse of the two rows in log2 units (plain loads), while TMA lands
  const long long bh = (long long)b * gridDim.y + h;
  const float l0 = qpos0 < S ? lse[bh * S + qpos0] * LOG2E : 0.f;
  const float l1 = qpos1 < S ? lse[bh * S + qpos1] * LOG2E : 0.f;

  mbar_wait(bar_q, 0);
  // delta of the two rows: each lane of the row's quad sums two 16-byte
  // chunks of each column block of dO * O, then the quad adds up
  float del0 = 0.f, del1 = 0.f;
#pragma unroll
  for (int c = 0; c < C::CB; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t at = (c * C::QROWS + r0) * 128 + (cq + j) * 16;
      const uint8_t* d = sp + C::OFF_DO + at;
      const uint8_t* o = sp + C::OFF_O + at;
      del0 = dot8(*reinterpret_cast<const uint4*>(d),
                  *reinterpret_cast<const uint4*>(o), del0);
      del1 = dot8(*reinterpret_cast<const uint4*>(d + 8 * 128),
                  *reinterpret_cast<const uint4*>(o + 8 * 128), del1);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    del0 += __shfl_xor_sync(0xffffffffu, del0, off);
    del1 += __shfl_xor_sync(0xffffffffu, del1, off);
  }
  if (lane % 4 == 0) {            // rows past S (up to S_pad) get zeros
    float2* rrow = reinterpret_cast<float2*>(rows) + bh * S_pad;
    if (qpos0 < S_pad) rrow[qpos0] = make_float2(l0, qpos0 < S ? del0 : 0.f);
    if (qpos1 < S_pad) rrow[qpos1] = make_float2(l1, qpos1 < S ? del1 : 0.f);
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  __syncwarp();                      // wgmma wants the warp converged
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_first + t * BK;
    mbar_wait(bar_full + 8 * stage, phase);
    if (tid == 0 && ring.next < ntiles)
      ring.issue(bar_full, bar_empty, load_kv);
    __syncwarp();
    const bool dead = qw0 >= S || (causal && k0 > qw0 + 63) ||
                      (window && k0 + BK - 1 <= qw0 - window);
    if (!dead) {
      const uint32_t sKs = sK + stage * C::KV_BYTES;
      const uint32_t sVs = sV + stage * C::KV_BYTES;
      // S = Q.K^T and dP = dO.V^T, one commit
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
      rows_product<BK>(s, sQ + rows_off, C::QROWS * 128, sKs, BK * 128,
                       ksteps);
      rows_product<BK>(dp, sdO + rows_off, C::QROWS * 128, sVs, BK * 128,
                       ksteps);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);
      reg_fence(dp);

      // p and ds in f32 (masked only on a tile that crosses the band's
      // edge or S), ds rounded to bf16 pairs: pair i/2 of the accumulator
      // is register i/2 % 4 of k-step i/8's A fragment
      const bool edge = k0 + BK > S || qw0 + 64 > S ||
                        (causal && k0 + BK - 1 > qw0) ||
                        (window && k0 <= qw0 + 63 - window);
      uint32_t fa[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const bool lo = i % 4 < 2;                 // row qpos0, else qpos1
        const float l = lo ? l0 : l1, dl = lo ? del0 : del1;
        float p0 = prob(s[i], scale_log2, l);
        float p1 = prob(s[i + 1], scale_log2, l);
        if (edge) {
          const int kpos = k0 + 8 * (i / 4) + cq, qpos = lo ? qpos0 : qpos1;
          if (!live(qpos, kpos, S, causal, window)) p0 = 0.f;
          if (!live(qpos, kpos + 1, S, causal, window)) p1 = 0.f;
        }
        fa[i / 2] = bf16_pair(p0 * (dp[i] - dl) * scale,
                              p1 * (dp[i + 1] - dl) * scale);
      }
      // dQ += dS.K over the tile's keys
      wgmma_fence();
      frag_product<DP, BK>(acc, fa, sKs);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
    }
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);   // stage is free
    ring_next<C::STAGES>(stage, phase);
  }

  __nv_bfloat16* qb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const bool lo = i % 4 < 2;
    const int qpos = lo ? qpos0 : qpos1, col = 8 * (i / 4) + cq;
    if (qpos < S && col < Dh)
      *reinterpret_cast<__nv_bfloat162*>(qb + qpos * dqs.s + col) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

template <int DP>
struct KvCfg {
  static constexpr int KROWS = 64;                 // keys of a block
  static constexpr int BQ = 64;                    // q rows of a ring tile
  static constexpr int CB = DP / 64;
  // Q/dO/rows ring: 2 stages at Dh 128, so that two blocks fit an SM
  // (97 KB each), else 3
  static constexpr int STAGES = DP == 128 ? 2 : 3;
  static constexpr int THREADS = 128;              // one warpgroup
  static constexpr uint32_t KV_BYTES = KROWS * DP * 2;  // K or V
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;      // a Q or dO tile
  static constexpr uint32_t ROW_BYTES = BQ * 8;         // (lse2, delta)
  static constexpr uint32_t OFF_V = KV_BYTES;
  static constexpr uint32_t OFF_Q = 2 * KV_BYTES;
  static constexpr uint32_t OFF_DO = OFF_Q + STAGES * Q_BYTES;
  static constexpr uint32_t OFF_ROWS = OFF_DO + STAGES * Q_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_ROWS + STAGES * ROW_BYTES;
  // barriers: kv, full[STAGES], empty[STAGES]
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(KvCfg<DP>::THREADS, 1)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ rows,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int S, int S_pad,
                         int H, int group, int Dh, Strides dks, Strides dvs,
                         int causal, int window, float scale,
                         float scale_log2) {
  using C = KvCfg<DP>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* sp = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + C::OFF_V, sQ = base + C::OFF_Q,
                 sdO = base + C::OFF_DO, sR = base + C::OFF_ROWS;
  const uint32_t bar_kv = base + C::OFF_BAR;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * C::KROWS;
  const int kvh = blockIdx.y, b = blockIdx.z;
  // q rows that see a key of k0 .. k0+KROWS-1: from k0 under the causal
  // mask, below k0+KROWS-1+window under a window; the ring's tiles are
  // the group's G heads, each over those q tiles
  const int q_begin = causal ? k0 : 0;
  const int q_end = window ? min(S, k0 + C::KROWS - 1 + window) : S;
  const int q_first = (q_begin / BQ) * BQ;
  const int nq = (q_end - q_first + BQ - 1) / BQ;
  const int ntiles = group * nq;

  Ring<C::STAGES> ring;
  auto load_q = [&](int stage, uint32_t full) {
    const int h = kvh * group + ring.next / nq;
    const int q0 = q_first + (ring.next % nq) * BQ;
    mbar_expect_tx(full, 2 * C::Q_BYTES + C::ROW_BYTES);
    for (int c = 0; c < C::CB; ++c) {
      const uint32_t off = stage * C::Q_BYTES + c * BQ * 128;
      tma_load(sQ + off, &tq, full, 64 * c, h, q0, b);
      tma_load(sdO + off, &tdo, full, 64 * c, h, q0, b);
    }
    bulk_load(sR + stage * C::ROW_BYTES,
              rows + 2 * (((long long)b * H + h) * S_pad + q0), C::ROW_BYTES,
              full);
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4);          // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
    for (int c = 0; c < C::CB; ++c) {
      const uint32_t off = c * C::KROWS * 128;
      tma_load(sK + off, &tk, bar_kv, 64 * c, kvh, k0, b);
      tma_load(sV + off, &tv, bar_kv, 64 * c, kvh, k0, b);
    }
    while (ring.next < min(ntiles, C::STAGES - 1))
      ring.issue(bar_full, bar_empty, load_q);
  }
  __syncthreads();

  // this thread holds key rows kpos0 and kpos0 + 8 of every accumulator,
  // at q columns 8j + cq, +1
  const int kpos0 = k0 + 16 * warp + lane / 4, kpos1 = kpos0 + 8;
  const int cq = 2 * (lane % 4);
  const int ksteps = (Dh + 15) / 16;

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(bar_kv, 0);
  __syncwarp();
  // thread 0 issues the next load as a tile arrives with a 2-stage ring
  // (else its next tile would wait for it), after the tile with 3 (which
  // measured faster at Dh 64)
  constexpr bool EARLY = C::STAGES == 2;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int q0 = q_first + (t % nq) * BQ;
    mbar_wait(bar_full + 8 * stage, phase);
    if (EARLY && tid == 0 && ring.next < ntiles)
      ring.issue(bar_full, bar_empty, load_q);
    __syncwarp();
    const bool dead = k0 >= S || (causal && q0 + BQ - 1 < k0) ||
                      (window && q0 - (k0 + 63) >= window);
    if (!dead) {
      const uint32_t sQs = sQ + stage * C::Q_BYTES;
      const uint32_t sdOs = sdO + stage * C::Q_BYTES;
      // S^T = K.Q^T and dP^T = V.dO^T, one commit
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
      rows_product<BQ>(st, sK, C::KROWS * 128, sQs, BQ * 128, ksteps);
      rows_product<BQ>(dpt, sV, C::KROWS * 128, sdOs, BQ * 128, ksteps);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(st);
      reg_fence(dpt);

      // P^T and dS^T: (lse2, delta) by the accumulator's column (q row)
      const float4* r = reinterpret_cast<const float4*>(
          sp + C::OFF_ROWS + stage * C::ROW_BYTES);
      const bool edge = k0 + 64 > S || q0 + BQ > S ||
                        (causal && k0 + 63 > q0) ||
                        (window && k0 <= q0 + BQ - 1 - window);
      uint32_t pa[BQ / 4], sa[BQ / 4];
#pragma unroll
      for (int i = 0; i < BQ / 2; i += 2) {
        const bool lo = i % 4 < 2;               // key kpos0, else kpos1
        const int col = 8 * (i / 4) + cq;
        const float4 ld = r[col / 2];            // lse2, delta of col, +1
        float p0 = prob(st[i], scale_log2, ld.x);
        float p1 = prob(st[i + 1], scale_log2, ld.z);
        if (edge) {
          const int kpos = lo ? kpos0 : kpos1;
          if (!live(q0 + col, kpos, S, causal, window)) p0 = 0.f;
          if (!live(q0 + col + 1, kpos, S, causal, window)) p1 = 0.f;
        }
        pa[i / 2] = bf16_pair(p0, p1);
        sa[i / 2] = bf16_pair(p0 * (dpt[i] - ld.y) * scale,
                              p1 * (dpt[i + 1] - ld.w) * scale);
      }
      // dV += P^T.dO and dK += dS^T.Q over the tile's q rows
      wgmma_fence();
      frag_product<DP, BQ>(dva, pa, sdOs);
      frag_product<DP, BQ>(dka, sa, sQs);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dva);
      reg_fence(dka);
    }
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
    if (!EARLY && tid == 0 && ring.next < ntiles)
      ring.issue(bar_full, bar_empty, load_q);
    ring_next<C::STAGES>(stage, phase);
  }

  __nv_bfloat16* kout = dk + b * dks.b + kvh * dks.h;
  __nv_bfloat16* vout = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const bool lo = i % 4 < 2;
    const int kpos = lo ? kpos0 : kpos1, col = 8 * (i / 4) + cq;
    if (kpos < S && col < Dh) {
      *reinterpret_cast<__nv_bfloat162*>(kout + kpos * dks.s + col) =
          __floats2bfloat162_rn(dka[i], dka[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vout + kpos * dvs.s + col) =
          __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

struct WgArgs {
  const void *q, *k, *v, *dout;
  int B, S, H, KV, Dh;
  Strides qs, ks, vs, dos;
  int causal, window;
  float scale, scale_log2;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, uint32_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DP, int BK>
cudaError_t launch_dq_wgmma(const WgArgs& a, const void* o, Strides os,
                            const float* lse, float* rows, void* dq,
                            Strides dqs, cudaStream_t st) {
  using C = DqCfg<DP, BK>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to, tdo;
  if (!encode(fn, &tq, a.q, a.B, a.S, a.H, a.Dh, a.qs, C::QROWS) ||
      !encode(fn, &tk, a.k, a.B, a.S, a.KV, a.Dh, a.ks, BK) ||
      !encode(fn, &tv, a.v, a.B, a.S, a.KV, a.Dh, a.vs, BK) ||
      !encode(fn, &to, o, a.B, a.S, a.H, a.Dh, os, C::QROWS) ||
      !encode(fn, &tdo, a.dout, a.B, a.S, a.H, a.Dh, a.dos, C::QROWS))
    return cudaErrorInvalidValue;
  auto kernel = fa_bwd_dq_wgmma_kernel<DP, BK>;
  cudaError_t err = allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + C::QROWS - 1) / C::QROWS, a.H, a.B);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, to, tdo, lse, rows, static_cast<__nv_bfloat16*>(dq), a.S,
      rows_pad(a.S), a.H / a.KV, a.Dh, dqs, a.causal, a.window, a.scale,
      a.scale_log2);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkdv_wgmma(const WgArgs& a, const float* rows, void* dk,
                              void* dv, Strides dks, Strides dvs,
                              cudaStream_t st) {
  using C = KvCfg<DP>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(fn, &tq, a.q, a.B, a.S, a.H, a.Dh, a.qs, C::BQ) ||
      !encode(fn, &tk, a.k, a.B, a.S, a.KV, a.Dh, a.ks, C::KROWS) ||
      !encode(fn, &tv, a.v, a.B, a.S, a.KV, a.Dh, a.vs, C::KROWS) ||
      !encode(fn, &tdo, a.dout, a.B, a.S, a.H, a.Dh, a.dos, C::BQ))
    return cudaErrorInvalidValue;
  auto kernel = fa_bwd_dkdv_wgmma_kernel<DP>;
  cudaError_t err = allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + C::KROWS - 1) / C::KROWS, a.KV, a.B);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(
      tq, tk, tv, tdo, rows, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.S, rows_pad(a.S), a.H, a.H / a.KV,
      a.Dh, dks, dvs, a.causal, a.window, a.scale, a.scale_log2);
  return cudaGetLastError();
}

WgArgs wg_args(const void* q, const void* k, const void* v, const void* dout,
               int B, int S, int H, int KV, int Dh, Strides qs, Strides ks,
               Strides vs, Strides dos, int causal, int window) {
  return WgArgs{q, k, v, dout, B, S, H, KV, Dh, qs, ks, vs, dos, causal,
                window, scale_of(Dh), scale_log2_of(Dh)};
}

}  // namespace

// delta (B, H, S) f32 = rowsum(dout * o); dtype 0 = float32, 1 = bfloat16
// (o and dout alike).  Strides are in elements; the head dim contiguous.
extern "C" int fa_bwd_delta_launch(
    const void* o, const void* dout, void* delta, int B, int S, int H,
    int Dh, long long osb, long long oss, long long osh, long long dsb,
    long long dss, long long dsh, int dtype, void* stream) {
  if (bad_shape(B, S, H, H, Dh, 0, dtype)) return (int)cudaErrorInvalidValue;
  const Strides os{osb, oss, osh}, dos{dsb, dss, dsh};
  const long long rows = (long long)B * H * S;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    fa_bwd_delta_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(delta), B, S, H, Dh, os, dos);
  else
    fa_bwd_delta_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta),
        B, S, H, Dh, os, dos);
  return (int)cudaGetLastError();
}

// dk, dv (B,S,KV,Dh) in the inputs' type from q, k, v, dout, lse and
// delta (both (B,H,S) f32, contiguous).  Strides in elements, (b, s, head)
// of q, k, v, dout, dk, dv.
extern "C" int fa_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int KV, int Dh, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, long long dksb, long long dkss, long long dksh,
    long long dvsb, long long dvss, long long dvsh, int causal, int window,
    int dtype, void* stream) {
  if (bad_shape(B, S, H, KV, Dh, window, dtype))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), B, S, H, KV, Dh,
                  Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},
                  Strides{vsb, vss, vsh}, Strides{dsb, dss, dsh}, causal,
                  window, scale_of(Dh)};
  const Strides dks{dksb, dkss, dksh}, dvs{dvsb, dvss, dvsh};
  cudaStream_t st = (cudaStream_t)stream;
  auto run = [&](auto tag) {
    using T = decltype(tag);
    return by_head_dim(
        Dh, [&] { return launch_dkdv<T, 64, 64, 64>(a, dk, dv, dks, dvs, st); },
        [&] { return launch_dkdv<T, 128, 64, 64>(a, dk, dv, dks, dvs, st); },
        [&] { return launch_dkdv<T, 256, 32, 32>(a, dk, dv, dks, dvs, st); });
  };
  return (int)(dtype == 0 ? run(float{}) : run(__nv_bfloat16{}));
}

// dq (B,S,H,Dh) in the inputs' type; arguments as fa_bwd_dkdv_launch's,
// with dq's strides in place of dk's and dv's.
extern "C" int fa_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int H,
    int KV, int Dh, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, long long dqsb, long long dqss, long long dqsh,
    int causal, int window, int dtype, void* stream) {
  if (bad_shape(B, S, H, KV, Dh, window, dtype))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), B, S, H, KV, Dh,
                  Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},
                  Strides{vsb, vss, vsh}, Strides{dsb, dss, dsh}, causal,
                  window, scale_of(Dh)};
  const Strides dqs{dqsb, dqss, dqsh};
  cudaStream_t st = (cudaStream_t)stream;
  auto run = [&](auto tag) {
    using T = decltype(tag);
    return by_head_dim(
        Dh, [&] { return launch_dq<T, 64, 64, 64>(a, dq, dqs, st); },
        [&] { return launch_dq<T, 128, 64, 64>(a, dq, dqs, st); },
        [&] { return launch_dq<T, 256, 32, 32>(a, dq, dqs, st); });
  };
  return (int)(dtype == 0 ? run(float{}) : run(__nv_bfloat16{}));
}

// The bf16 route.  dq (B,S,H,Dh) from q, k, v, o, dout and lse (B,H,S)
// f32 contiguous: fa_bwd_dq_wgmma_kernel, which also writes `rows`
// (B, H, S_pad, 2) f32 contiguous, S_pad = S rounded up to a multiple of
// 64: each q row's (lse * log2(e), delta = rowsum(dout * o)), zeros past
// S, what fa_bwd_dkdv_wgmma_launch reads.  Strides in elements, (b, s,
// head) of q, k, v, o, dout and dq; q, k, v, o and dout need
// 16-byte-aligned bases and strides that are multiples of 8 (TMA), rows a
// 16-byte-aligned base.  Only bfloat16 (dtype 1) with Dh <= 128: anything
// else returns cudaErrorInvalidValue without a launch.
extern "C" int fa_bwd_dq_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* rows, void* dq, int B, int S,
    int H, int KV, int Dh, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, long long dsb, long long dss, long long dsh,
    long long dqsb, long long dqss, long long dqsh, int causal, int window,
    int dtype, void* stream) {
  if (bad_shape(B, S, H, KV, Dh, window, dtype) || dtype != 1 || Dh > 128)
    return (int)cudaErrorInvalidValue;
  const WgArgs a = wg_args(q, k, v, dout, B, S, H, KV, Dh,
                           Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},
                           Strides{vsb, vss, vsh}, Strides{dsb, dss, dsh},
                           causal, window);
  const Strides os{osb, oss, osh}, dqs{dqsb, dqss, dqsh};
  const float* ls = static_cast<const float*>(lse);
  float* rw = static_cast<float*>(rows);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(Dh <= 64
                   ? launch_dq_wgmma<64, 128>(a, o, os, ls, rw, dq, dqs, st)
                   : launch_dq_wgmma<128, 64>(a, o, os, ls, rw, dq, dqs, st));
}

// dk, dv (B,S,KV,Dh) from q, k, v, dout and the rows buffer that
// fa_bwd_dq_wgmma_launch wrote: fa_bwd_dkdv_wgmma_kernel.  Strides as
// fa_bwd_dkdv_launch's.  Only bfloat16 (dtype 1) with Dh <= 128: anything
// else returns cudaErrorInvalidValue without a launch.
extern "C" int fa_bwd_dkdv_wgmma_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* rows, void* dk, void* dv, int B, int S, int H, int KV,
    int Dh, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh,
    long long dksb, long long dkss, long long dksh, long long dvsb,
    long long dvss, long long dvsh, int causal, int window, int dtype,
    void* stream) {
  if (bad_shape(B, S, H, KV, Dh, window, dtype) || dtype != 1 || Dh > 128)
    return (int)cudaErrorInvalidValue;
  const WgArgs a = wg_args(q, k, v, dout, B, S, H, KV, Dh,
                           Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},
                           Strides{vsb, vss, vsh}, Strides{dsb, dss, dsh},
                           causal, window);
  const Strides dks{dksb, dkss, dksh}, dvs{dvsb, dvss, dvsh};
  const float* rw = static_cast<const float*>(rows);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(Dh <= 64
                   ? launch_dkdv_wgmma<64>(a, rw, dk, dv, dks, dvs, st)
                   : launch_dkdv_wgmma<128>(a, rw, dk, dv, dks, dvs, st));
}
