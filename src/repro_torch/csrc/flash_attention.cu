// FlashAttention forward: softmax attention with an online softmax,
// causal and sliding-window masks, and GQA.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention_fwd
// / _fa_kernel -- the Pallas kernel whose grid (batch, q head, q block,
// k block) carries (acc, m, l) in VMEM scratch across the sequential k
// axis, skips k blocks outside the causal/window band with pl.when, and
// maps q head h to kv head h / (H / KV).
//
// It computes what _fa_kernel computes: logits q.k^T * 1/sqrt(Dh) in f32,
// set to the finite NEG_INF = -0.7 * FLT_MAX where masked (causal kpos <=
// qpos, window kpos > qpos - window); m, l and acc in f32, corr =
// exp(m_prev - m_new); out = acc / max(l, 1e-37), cast to q's type.  The
// finite NEG_INF matters: a row whose keys in a visited tile are all
// masked gets m = NEG_INF and p = exp(0) = 1, and the next live tile wipes
// that out through corr = exp(NEG_INF - m) = 0; with -inf that step would
// be NaN.  Every row has at least its diagonal key.  Where the caller
// passes an lse buffer (training), both routes also write each row's
// log-sum-exp, m + log(max(l, 1e-37)) in natural-log units, as the
// reference's jnp_impl._fwd returns it for its backward; the bf16 route
// keeps m in log2 units, so its lse is m * ln 2 + log(l).
//
// What bounds it on the H100: at granite-3-2b's prefill (B=4, S=1024,
// H=32, KV=8, Dh=64, bf16, causal) the function reads and writes 42 MB
// (12.5 us at 3.35 TB/s) and does 4*B*H*Dh*S(S+1)/2 = 17.2 GFLOP on its
// live query-key pairs (17.4 us at the tensor cores' 989 TFLOP/s bf16):
// operations bound it.  At zamba2-7b's shared attention (B=4, S=896,
// H=KV=32, Dh=112) it moves 103 MB (30.7 us) for 23.0 GFLOP (23.3 us):
// bytes bound it.
//
// Two routes, chosen by ops.fwd_route from the inputs' dtype and head
// dim; neither falls back to the other.  "wgmma": bfloat16 runs this
// file's fa_wgmma_kernel, float32 at head dims up to 128 the split pass
// and fa_fwd_parts_kernel of flash_attention_fwd_parts.cu (their own
// entry points).  "simt": float32 past head dim 128 runs this file's
// fa_f32_kernel.
//
// bfloat16: fa_wgmma_kernel, built from Hopper's TMA, mbarriers and wgmma.
// One block owns one (b, q head, tile of 64 * NWG q rows): NWG consumer
// warpgroups of 64 rows each (wgmma's M) and a producer warpgroup, one
// thread of which issues the loads.  Blocks of the last q tiles, which
// visit the most k tiles under the causal mask, start first.  The k loop
// visits, in ascending order, the k tiles of BK keys that hold a key
// inside the band of the block's rows (the pl.when skip), so a tile
// wholly outside it is never loaded.  K/V tiles are not shared between
// the q heads of a GQA group: each block loads its kv head's tiles (L2
// serves the group's other heads).  What the design does about the four
// limits of the first, f32 SIMT version:
//  1. Arithmetic.  Both products run on the tensor cores:
//     S = Q.K^T as wgmma m64nBKk16 with Q and K read from shared memory,
//     O += P.V as wgmma m64nDPk16 with P as the register operand, bf16 in
//     and f32 accumulation.  P is rounded to bf16 (the reference keeps it
//     in f32): its relative error 2^-9 on weights that sum to one stays
//     well inside the reference's 2e-2 tolerance, so no hi/lo split of P
//     is needed.  The row sum l adds up the unrounded f32 p.
//  2. Staging.  TMA copies whole tiles (4-D tensor maps over the (Dh,
//     heads, S, B) layout, the byte strides taken from the tensors', so
//     no transposed copy is made) in 128-byte-swizzled boxes 64 columns
//     wide, the layout wgmma's descriptors read without bank conflicts.
//     TMA's zero fill pads Dh to a multiple of 64 and the rows past S;
//     keys past S stay masked.  The producer keeps a 2-stage K/V ring
//     ahead of the consumers, one "full" and one "empty" mbarrier per
//     stage, so the next tile's load overlaps this tile's math.
//  3. P never touches shared memory: the f32 accumulator fragment of S
//     (each quad of lanes owns a row: max and sum are two shuffles) is,
//     pair by pair, the register A fragment of the P.V product.  Only
//     tiles that cross the band's edge or S are masked.  The logits are
//     kept in log2 units (scaled by log2(e)/sqrt(Dh)), so every
//     exponential is one exp2f; the softmax's share of the issue slots
//     bounds this kernel as much as the tensor cores do.
//  4. Tiles.  128 q rows (64 at Dh 256) against BK = 128 keys at Dh <= 64
//     and 64 above, 384 threads (256 at Dh 256), one block an SM.  The
//     producer warpgroup hands its registers to the consumers
//     (setmaxnreg: 24 and 240 a thread), which hold S, P and O without
//     spilling at every head dim.
// V's tile is (keys, Dh) with Dh contiguous, so it is the MN-major B
// operand of P.V (wgmma's transpose-B form for bf16): its descriptor's
// leading byte offset steps over 64-column blocks (BK * 128 bytes), its
// stride byte offset over 8-key groups (1024 bytes).  A wait on an
// mbarrier that never completes traps after ~2^35 cycles instead of
// hanging the card.  TMA needs a 16-byte-aligned base and byte strides
// that are multiples of 16: the wrapper checks both and raises.  The
// driver's cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so the library links against the runtime
// alone.
//
// float32: on the wgmma route (Dh <= 128) the inputs go through a split
// pass into three bf16 parts each and fa_fwd_parts_kernel runs both
// products on the tensor cores (flash_attention_fwd_parts.cu's note:
// what bounds it, its design against the limits of the kernel below,
// its shared-memory table).  TF32 would break the reference's 2e-5, and
// wgmma reads TF32 operands from shared memory only K-major, while V is
// P.V's MN-major operand; bf16 parts allow both.  No served model runs
// attention in float32; the float32 training step does (chip_smoke.py).
// Past Dh 128 three parts of a Q tile and a K/V ring do not fit a
// block's shared memory, and float32 runs fa_f32_kernel, the first
// port's SIMT kernel, f32 on the CUDA cores (flash_attention_launch with
// dtype 0 runs it at any head dim: chip_smoke.py times it against the
// wgmma route at Dh 64).  One block of 128 threads per (b, h, q tile of
// BQ rows); Q, K and V tiles staged in shared memory, read through the
// strides; thread (ty, tx) of the 8 x 16 grid owns q rows ty + 8r, its
// keys tx + 16c and output columns tx + 16c, the row max and sum
// half-warp shuffles.  (BQ, BK) = (64, 64), (64, 32), (32, 32) for head
// dims up to 64, 128 and 256.  What bounds it: its products on the CUDA
// cores (0.257 ms at 67 TFLOP/s at granite-3-2b's heads, B=4, S=1024),
// each FMA paced by shared-memory loads (8 q and 4 k values a thread
// for 32 FMAs), P staged through shared memory with three block
// barriers a tile, synchronous scalar loads with no ring, and expf on
// every logit.
//
// The library is built with --fmad=false (for the bit parity of qn_event
// and amva): multiply-adds that should fuse are spelled __fmaf_rn.
// Attention parity with the plain version is held by tolerance, not bits.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float FA_NEG_INF = (float)(-0.7 * (double)FLT_MAX);
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ float32 route
constexpr int TX = 16;               // threads along keys / head dim
constexpr int TY = 8;                // threads along q rows
constexpr int THREADS = TX * TY;

template <int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int S,
              int group, int Dh, Strides qs, Strides ks, Strides vs,
              Strides os, int causal, int window, float scale) {
  constexpr int RT = BQ / TY;        // q rows per thread
  constexpr int CK = BK / TX;        // keys per thread
  constexpr int CT = DMAX / TX;      // output columns per thread
  constexpr int LDQ = DMAX + 1;      // padded: conflict-free column reads
  constexpr int LDP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                  // BQ x LDQ
  float* sK = sQ + BQ * LDQ;         // BK x LDQ
  float* sV = sK + BK * LDQ;         // BK x DMAX
  float* sP = sV + BK * DMAX;        // BQ x LDP

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < BQ * DMAX; e += THREADS) {
    const int i = e / DMAX, d = e % DMAX;
    sQ[i * LDQ + d] = q0 + i < S && d < Dh ? qb[(q0 + i) * qs.s + d] : 0.f;
  }

  float m[RT], l[RT], acc[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = FA_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;
  }

  // k tiles holding a key inside the band of rows q0 .. min(q0+BQ, S)-1
  const int k_end = causal ? min(q0 + BQ, S) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();                 // the previous tile's readers are done
    for (int e = tid; e < BK * DMAX; e += THREADS) {
      const int j = e / DMAX, d = e % DMAX;
      const bool in = k0 + j < S && d < Dh;
      sK[j * LDQ + d] = in ? kb[(k0 + j) * ks.s + d] : 0.f;
      sV[j * DMAX + d] = in ? vb[(k0 + j) * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[RT][CK];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[r][c] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      float qr[RT], kc[CK];
#pragma unroll
      for (int r = 0; r < RT; ++r) qr[r] = sQ[(ty + r * TY) * LDQ + d];
#pragma unroll
      for (int c = 0; c < CK; ++c) kc[c] = sK[(tx + c * TX) * LDQ + d];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c) s[r][c] = __fmaf_rn(qr[r], kc[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int qpos = q0 + ty + r * TY;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kpos = k0 + tx + c * TX;
        const bool live = kpos < S && (!causal || kpos <= qpos) &&
                          (!window || kpos > qpos - window);
        s[r][c] = live ? s[r][c] * scale : FA_NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = expf(s[r][c] - m_new);
        sP[(ty + r * TY) * LDP + tx + c * TX] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float pr[RT], vc[CT];
#pragma unroll
      for (int r = 0; r < RT; ++r) pr[r] = sP[(ty + r * TY) * LDP + j];
#pragma unroll
      for (int c = 0; c < CT; ++c) vc[c] = sV[j * DMAX + tx + c * TX];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < CT; ++c)
          acc[r][c] = __fmaf_rn(pr[r], vc[c], acc[r][c]);
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int qpos = q0 + ty + r * TY;
    if (qpos >= S) continue;
    const float den = fmaxf(l[r], 1e-37f);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * gridDim.y + h) * S + qpos] = m[r] + logf(den);
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int d = tx + c * TX;
      if (d < Dh) ob[qpos * os.s + d] = acc[r][c] / den;
    }
  }
}

template <int DMAX, int BQ, int BK>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int H, int group, int Dh, Strides qs,
                       Strides ks, Strides vs, Strides os, int causal,
                       int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (DMAX + 1) +
                                       (size_t)BK * (DMAX + 1) +
                                       (size_t)BK * DMAX +
                                       (size_t)BQ * (BK + 1));
  auto kernel = fa_f32_kernel<DMAX, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, group,
      Dh, qs,
      ks, vs, os, causal, window, scale);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bf16 route
template <int DP, int NWG, int BK>
struct Cfg {
  static constexpr int QROWS = 64 * NWG;          // q rows of a block
  static constexpr int CB = DP / 64;              // 128-byte column blocks
  static constexpr int STAGES = 2;                // K/V ring
  static constexpr int THREADS = 128 * NWG + 128;  // + the producer
  static constexpr uint32_t Q_BYTES = QROWS * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;   // one K or V tile
  static constexpr uint32_t OFF_K = Q_BYTES;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // barriers: q, full[STAGES], empty[STAGES]; + 1024 for the alignment
  // of the swizzle atoms
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// Shared memory holds each tile as CB column blocks of rows x 128 bytes,
// 128-byte swizzled by TMA; every block starts on a 1024-byte boundary.
template <int DP, int NWG, int BK>
__global__ void __launch_bounds__(Cfg<DP, NWG, BK>::THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int S, int group, int Dh,
                Strides os, int causal, int window, float scale_log2) {
  using C = Cfg<DP, NWG, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + C::OFF_K, sV = base + C::OFF_V;
  const uint32_t bar_q = base + C::OFF_BAR;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::QROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  // k tiles holding a key inside the band of rows q0 .. min(q0+QROWS, S)-1
  const int k_end = causal ? min(q0 + C::QROWS, S) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int k_first = (k_begin / BK) * BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * NWG);    // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The producer warpgroup: one thread issues every TMA load.  With two
  // consumer warpgroups a block launches at 168 registers a thread (three
  // warps share each quarter of the SM's register file); the producer
  // hands its registers over, so a consumer thread may use 240.
  if (warp >= 4 * NWG) {
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 128 * NWG) {
      const int kvh = h / group;
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int c = 0; c < C::CB; ++c)
        tma_load(sQ + c * C::QROWS * 128, &tq, bar_q, 64 * c, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int k0 = k_first; k0 < k_end; k0 += BK) {
        mbar_wait(bar_empty + 8 * stage, phase ^ 1);
        const uint32_t full = bar_full + 8 * stage;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
        for (int c = 0; c < C::CB; ++c) {
          const uint32_t off = stage * C::KV_BYTES + c * BK * 128;
          tma_load(sK + off, &tk, full, 64 * c, kvh, k0, b);
          tma_load(sV + off, &tv, full, 64 * c, kvh, k0, b);
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  // a consumer warpgroup: rows qw0 .. qw0+63; this thread holds rows
  // qpos0 and qpos0 + 8 of every accumulator, at columns 8j + cq, +1
  const int wg = warp / 4;
  const int qw0 = q0 + 64 * wg;
  const int qpos0 = qw0 + 16 * (warp % 4) + lane / 4, qpos1 = qpos0 + 8;
  const int cq = 2 * (lane % 4);
  const int ksteps = (Dh + 15) / 16;             // of Q.K^T, 16 columns each
  const uint32_t sQw = sQ + wg * 64 * 128;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = FA_NEG_INF, m1 = FA_NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  __syncwarp();                      // wgmma wants the warp converged
  int stage = 0;
  uint32_t phase = 0;
  for (int k0 = k_first; k0 < k_end; k0 += BK) {
    mbar_wait(bar_full + 8 * stage, phase);
    __syncwarp();
    const uint32_t sKs = sK + stage * C::KV_BYTES;
    const uint32_t sVs = sV + stage * C::KV_BYTES;

    // S = Q.K^T over the head dim, 16 columns a step
    float s[BK / 2];
    wgmma_fence();
    for (int t = 0; t < ksteps; ++t) {
      const uint32_t off = (t % 4) * 32;          // within the 128-byte row
      const uint64_t da =
          smem_desc(sQw + (t / 4) * C::QROWS * 128 + off, 16, 1024);
      const uint64_t db = smem_desc(sKs + (t / 4) * BK * 128 + off, 16, 1024);
      if constexpr (BK == 128) wgmma_ss_n128(s, da, db, t);
      else wgmma_ss_n64(s, da, db, t);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    // scale to log2 units and mask (only a tile that crosses the band's
    // edge or S)
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > qw0) ||
                      (window && k0 <= qw0 + 63 - window);
    float mx0 = FA_NEG_INF, mx1 = FA_NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * scale_log2;
      const bool lo = i % 4 < 2;                   // row qpos0, else qpos1
      if (edge) {
        const int kpos = k0 + 8 * (i / 4) + cq + i % 2;
        const int qpos = lo ? qpos0 : qpos1;
        const bool live = kpos < S && (!causal || kpos <= qpos) &&
                          (!window || kpos > qpos - window);
        x = live ? x : FA_NEG_INF;
      }
      s[i] = x;
      if (lo) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
    // a row's 4 owners are one quad of lanes
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // p = 2^(s - m) in f32 for l, rounded to bf16 pairs for P.V: pair
    // i/2 of the S fragment is register i/2 % 4 of k-step i/8's A fragment
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const bool lo = i % 4 < 2;
      const float mm = lo ? mn0 : mn1;
      const float p0 = exp2f(s[i] - mm), p1 = exp2f(s[i + 1] - mm);
      if (lo) sum0 += p0 + p1;
      else sum1 += p0 + p1;
      const __nv_bfloat162 pr = __floats2bfloat162_rn(p0, p1);
      pa[i / 2] = *reinterpret_cast<const uint32_t*>(&pr);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(FULL, sum0, off);
      sum1 += __shfl_xor_sync(FULL, sum1, off);
    }
    l0 = __fmaf_rn(l0, c0, sum0);
    l1 = __fmaf_rn(l1, c1, sum1);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= i % 4 < 2 ? c0 : c1;

    // O += P.V over the tile's keys, 16 a step
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t a[4] = {pa[4 * t], pa[4 * t + 1], pa[4 * t + 2],
                             pa[4 * t + 3]};
      wgmma_rs<DP>(acc, a, smem_desc(sVs + t * 16 * 128, BK * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);   // stage is free
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  const float d0 = fmaxf(l0, 1e-37f), d1 = fmaxf(l1, 1e-37f);
  // lse in natural-log units: m is in log2 units, l = sum 2^(x - m)
  if (lse != nullptr && lane % 4 == 0) {
    float* lrow = lse + ((long long)b * gridDim.y + h) * S;
    if (qpos0 < S) lrow[qpos0] = m0 * 0.6931471805599453f + logf(d0);
    if (qpos1 < S) lrow[qpos1] = m1 * 0.6931471805599453f + logf(d1);
  }
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const bool lo = i % 4 < 2;
    const int qpos = lo ? qpos0 : qpos1, col = 8 * (i / 4) + cq;
    const float den = lo ? d0 : d1;
    if (qpos < S && col < Dh)
      *reinterpret_cast<__nv_bfloat162*>(ob + qpos * os.s + col) =
          __floats2bfloat162_rn(acc[i] / den, acc[i + 1] / den);
  }
}

template <int DP, int NWG, int BK>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int S, int H, int KV, int Dh,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         int causal, int window, float scale_log2,
                         cudaStream_t stream) {
  using C = Cfg<DP, NWG, BK>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, B, S, H, Dh, qs, C::QROWS) ||
      !encode(fn, &tk, k, B, S, KV, Dh, ks, BK) ||
      !encode(fn, &tv, v, B, S, KV, Dh, vs, BK))
    return cudaErrorInvalidValue;
  auto kernel = fa_wgmma_kernel<DP, NWG, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + C::QROWS - 1) / C::QROWS, H, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, H / KV, Dh, os,
      causal,
      window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (fa_f32_kernel, the simt route; the wgmma route of
// float32 is flash_attention_fwd_parts.cu's entry points), 1 =
// bfloat16 (fa_wgmma_kernel); q, k, v and o alike.  Strides are in
// elements; the head dim must be contiguous.  bfloat16 also needs
// 16-byte-aligned bases and strides that are multiples of 8 (TMA).  lse,
// where not null, receives each row's log-sum-exp m + log(max(l, 1e-37))
// in natural-log units, (B, H, S) float32 contiguous (what the backward
// reads); serving passes null.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse_out,
    int B, int S,
    int H, int KV, int Dh, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || Dh <= 0 ||
      Dh % 8 || Dh > 256 || B > 65535 || H > 65535 || window < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const float scale = (float)(1.0 / sqrt((double)Dh));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)Dh));
  const int g = H / KV;
  float* lse = static_cast<float*>(lse_out);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0) {
    if (Dh <= 64)
      err = launch_f32<64, 64, 64>(q, k, v, o, lse, B, S, H, g, Dh, qs, ks, vs,
                                   os, causal, window, scale, st);
    else if (Dh <= 128)
      err = launch_f32<128, 64, 32>(q, k, v, o, lse, B, S, H, g, Dh, qs, ks, vs,
                                    os, causal, window, scale, st);
    else
      err = launch_f32<256, 32, 32>(q, k, v, o, lse, B, S, H, g, Dh, qs, ks, vs,
                                    os, causal, window, scale, st);
  } else {
    if (Dh <= 64)
      err = launch_wgmma<64, 2, 128>(q, k, v, o, lse, B, S, H, KV, Dh, qs, ks,
                                     vs, os, causal, window, scale_log2, st);
    else if (Dh <= 128)
      err = launch_wgmma<128, 2, 64>(q, k, v, o, lse, B, S, H, KV, Dh, qs, ks,
                                     vs, os, causal, window, scale_log2, st);
    else
      err = launch_wgmma<256, 1, 64>(q, k, v, o, lse, B, S, H, KV, Dh, qs, ks,
                                     vs, os, causal, window, scale_log2, st);
  }
  return (int)err;
}
