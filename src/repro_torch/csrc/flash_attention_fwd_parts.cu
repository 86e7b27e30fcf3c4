// FlashAttention forward, float32 on the tensor cores: the wgmma route of
// float32 inputs at head dims up to 128 (ops.fwd_route).  It computes
// what flash_attention.cu's header note says the forward computes (the
// reference's _fa_kernel, src/repro/kernels/flash_attention/kernel.py):
// logits q.k^T / sqrt(Dh), the finite NEG_INF where masked (causal,
// window, keys past S), an online softmax, out = acc / max(l, 1e-37) in
// float32 and, where the caller passes a buffer, each row's lse in
// natural-log units.
//
// What bounds it on the H100: at granite-3-2b's heads in float32 (B=4,
// S=1024, H=32, KV=8, Dh=64, causal) the function's two products over
// the live query-key pairs are 17.2 GFLOP, 0.257 ms at the CUDA cores'
// 67 TFLOP/s float32, which bounded the SIMT kernel (fa_f32_kernel).  On
// the tensor cores each float32 product runs as bf16 terms (below).  The
// fewest that meet the reference's 2e-5 are six for S and the backward's
// three for P.V, 9 x 8.6 GFLOP = 77.4 GFLOP, 0.078 ms at 989 TFLOP/s:
// that is the bound, beside the split pass's 126 MB (4 bytes read and 6
// written an element of Q, K and V; 0.038 ms at 3.35 TB/s).  The kernel
// runs two P.V terms more for margin (11 terms, 94.6 GFLOP).  What the
// design does
// about the four limits of fa_f32_kernel:
//  1. Arithmetic on the CUDA cores, paced by shared-memory loads.  Both
//     products run on wgmma.  Every operand is held in three bf16 parts
//     (flash_attention_parts.cuh: hi, mid, lo, their sum the value
//     exactly).  S = Q.K^T sums the backward's six recomputation terms
//     (down to 2^-16 of the product; hi.hi in an accumulator of its own).
//     P is split in two (hi, lo: 2^-17 of p) as register A fragments and
//     O += P.V sums five terms, smallest first: lo.mid, hi.lo, lo.hi,
//     hi.mid, hi.hi (all but lo.lo).  The backward's three (lo.hi,
//     hi.mid, hi.hi: V without its lo part) took 0.61 of the reference's
//     2e-5 tolerance at the float32 check row in an emulation of these
//     sums (tests/test_torch_flash_f32.py), five 0.20; the rest of that
//     is P's split.  TF32 would break the 2e-5 (10 bits of mantissa), and
//     wgmma reads a TF32 operand from shared memory only K-major, while
//     V is P.V's MN-major operand.
//  2. P through shared memory and three block barriers a tile.  P never
//     touches shared memory: the f32 accumulator fragment of S is, pair
//     by pair, the A fragment of P.V (the bf16 route's layout).  No block
//     barrier runs in the k loop: the stages are handed back through
//     mbarriers.
//  3. Synchronous scalar loads.  fa_fwd_split_kernel writes the parts of
//     Q, K and V once, (B, S, heads, 3 DP) bf16 rows, DP = Dh rounded up
//     to 64, zero past Dh (fa_bwd_prep's layout), reading the float32
//     inputs through their strides: any strides still work, and TMA
//     loads contiguous, aligned parts.  One thread keeps a ring of K/V
//     part tiles in flight, STAGES - 1 ahead (mbarriers; no producer
//     warp, see flash_attention_bwd.cu's note 4); Q's parts load once.
//  4. Small blocks and expf.  Two warpgroups a block (128 q rows), one
//     block an SM; the last q tiles start first; k tiles outside the
//     band are never loaded, and a warpgroup whose rows see no key of a
//     tile skips it.  The logits are kept in log2 units (times
//     log2(e)/sqrt(Dh)), so each exponential is one ex2.approx (2^-22
//     relative); lse = m ln 2 + log(l).
// Each k tile's P.V sums into an accumulator of its own, zeroed, which
// is added to the running O in f32 after the correction (O = O * corr +
// tile, one fused multiply-add): the tensor cores truncate as they
// accumulate, and one accumulator over the whole band carries that into
// O (the backward's dkdv parts kernel measured 0.695 of its tolerance in
// one accumulator, 0.374 with a tile's own).  The row sum l adds up the
// unrounded f32 p.  Ping-pong of the two warpgroups' S products (named
// barriers, each issuing in turn) measured 1.5x slower on the H100: a
// warpgroup then waits on the other's whole tile.
//
// Shared memory (bytes; a block may use 232,448, of which 1,024 go to
// aligning the swizzle atoms), three parts of every operand:
//                       Q (QROWS rows)   K+V ring (BK keys)     total
//  <DP 64, WGS 2, BK 64, STAGES 3>  3*128*64*2   3 * 2*3*64*64*2    197,688
//  <DP 128, WGS 2, BK 32, STAGES 2> 3*128*128*2  2 * 2*3*32*128*2   197,672
// At DP 128 a 64-key stage takes 96 KB, so two stages and a 64-row Q
// (48 KB) would need 240 KB: the ring's tiles are 32 keys.  Float32 past
// Dh 128 does not fit in three parts (at DP 192 a 128-row Q takes 144
// KB and one 32-key stage 72 KB, 216 KB before a second stage); it stays
// on fa_f32_kernel (flash_attention.cu).
//
// Registers a thread: O's DP/2 and the tile's DP/2, S's and hi.hi's BK/2
// each, P's two parts' BK/4 each (at DP 64, BK 64: 32 + 32 + 32 + 32 +
// 32); 256 threads a block, so up to 255 a thread (ptxas: 173 at DP 64,
// 196 at DP 128, no spills).
#include <cfloat>

#include "flash_attention_parts.cuh"

namespace {

constexpr float FWD_NEG_INF = (float)(-0.7 * (double)FLT_MAX);
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_DH = 128;           // three parts past it exceed a block

// O += P.V's terms, smallest first, as (P part, V part) with P's hi 0 and
// lo 1 and V's hi 0, mid 1, lo 2: lo.mid, hi.lo, lo.hi, hi.mid, hi.hi
constexpr int PV_TERMS = 5;
__device__ __forceinline__ constexpr int pv_a(int i) {
  return i == 0 || i == 2 ? 1 : 0;
}
__device__ __forceinline__ constexpr int pv_b(int i) {
  return i == 1 ? 2 : i == 0 || i == 3 ? 1 : 0;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP, int WGS, int BK, int STAGES>
struct FwdPartsCfg {
  static constexpr int QROWS = 64 * WGS;           // q rows of a block
  static constexpr int CB = DP / 64;               // column blocks a part
  static constexpr int THREADS = 128 * WGS;
  static constexpr uint32_t Q_BYTES = 3 * QROWS * DP * 2;
  static constexpr uint32_t KV_BYTES = 3 * BK * DP * 2;   // K or V
  static constexpr uint32_t OFF_K = Q_BYTES;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // barriers: q, full[STAGES], empty[STAGES]
  static constexpr uint32_t SMEM = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(SMEM <= SMEM_LIMIT, "forward parts tiles exceed shared memory");
};

// One block per (b, q head, tile of 64 WGS q rows), WGS warpgroups of 64
// rows; tq, tk, tv map the parts (B, S, heads, 3 DP) in boxes of 64
// columns, 128-byte swizzled.
template <int DP, int WGS, int BK, int STAGES>
__global__ void __launch_bounds__(128 * WGS, 1)
fa_fwd_parts_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    float* __restrict__ o, float* __restrict__ lse, int S,
                    int group, int Dh, Strides os, int causal, int window,
                    float scale_log2) {
  using C = FwdPartsCfg<DP, WGS, BK, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + C::OFF_K, sV = base + C::OFF_V;
  const uint32_t bar_q = base + C::OFF_BAR;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::QROWS;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  // k tiles holding a key inside the band of rows q0 .. min(q0+QROWS, S)-1
  const int k_end = causal ? min(q0 + C::QROWS, S) : S;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int k_first = (k_begin / BK) * BK;
  const int ntiles = (k_end - k_first + BK - 1) / BK;

  Ring<STAGES> ring;
  auto load_kv = [&](int stage, uint32_t full) {
    const int k0 = k_first + ring.next * BK;
    mbar_expect_tx(full, 2 * C::KV_BYTES);
    for (int p = 0; p < 3; ++p)
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
    mbar_expect_tx(bar_q, C::Q_BYTES);
    for (int p = 0; p < 3; ++p)
      for (int c = 0; c < C::CB; ++c)
        tma_load(sQ + (p * C::CB + c) * C::QROWS * 128, &tq, bar_q,
                 p * DP + 64 * c, h, q0, b);
  }
  __syncthreads();

  // warpgroup wg: rows qw0 .. qw0+63; this thread holds rows qpos0 and
  // qpos0 + 8 of every accumulator, at columns 8j + cq, +1
  const int wg = warp / 4;
  const int qw0 = q0 + 64 * wg;
  const int qpos0 = qw0 + 16 * (warp % 4) + lane / 4, qpos1 = qpos0 + 8;
  const int cq = 2 * (lane % 4);
  // Q.K^T's k steps of 16 columns: all DP of them (the parts are zero
  // past Dh), a trip count ptxas knows, so it unrolls the six terms'
  // loop (granite's heads: 242 -> 173 registers, 0.301 -> 0.280 ms on
  // an H100)
  constexpr int ksteps = DP / 16;
  const uint32_t sQw = sQ + 64 * wg * 128;
  constexpr uint32_t Q_PART = C::CB * C::QROWS * 128;
  constexpr uint32_t KV_PART = C::CB * BK * 128;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = FWD_NEG_INF, m1 = FWD_NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  __syncwarp();                      // wgmma wants the warp converged
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    if (tid == 0)
      while (ring.next < min(ntiles, t + STAGES))
        ring.issue(bar_full, bar_empty, load_kv);
    const int k0 = k_first + t * BK;
    mbar_wait(bar_full + 8 * stage, phase);
    __syncwarp();
    // every row of this warpgroup sees no key of the tile: p would be 0
    // (after its live keys) or wiped by the first live tile's corr = 0
    const bool dead = qw0 >= S || (causal && k0 > qw0 + 63) ||
                      (window && k0 + BK - 1 <= qw0 - window);
    if (!dead) {
      const uint32_t sKs = sK + stage * C::KV_BYTES;
      const uint32_t sVs = sV + stage * C::KV_BYTES;

      // S = Q.K^T, six terms
      float s[BK / 2], hh[BK / 2];
      wgmma_fence();
      parts_rows_product<BK, 3>(s, hh, sQw, Q_PART, C::QROWS * 128, sKs,
                                KV_PART, BK * 128, ksteps);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);
      reg_fence(hh);
      sum_terms<3>(s, hh);

      // scale to log2 units and mask (only a tile that crosses the band's
      // edge or S)
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > qw0) ||
                        (window && k0 <= qw0 + 63 - window);
      float mx0 = FWD_NEG_INF, mx1 = FWD_NEG_INF;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = s[i] * scale_log2;
        const bool lo = i % 4 < 2;                 // row qpos0, else qpos1
        if (edge && !live(lo ? qpos0 : qpos1, k0 + 8 * (i / 4) + cq + i % 2,
                          S, causal, window))
          x = FWD_NEG_INF;
        s[i] = x;
        if (lo) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
      // a row's 4 owners are one quad of lanes
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // p = 2^(s - m) in f32 for l, split into bf16 pairs hi and lo for
      // P.V: pair i/2 of the S fragment is register i/2 % 4 of k-step
      // i/8's A fragment
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t fa[2][BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const bool lo = i % 4 < 2;
        const float mm = lo ? mn0 : mn1;
        const float p0 = ex2(s[i] - mm), p1 = ex2(s[i + 1] - mm);
        if (lo) sum0 += p0 + p1;
        else sum1 += p0 + p1;
        split2(p0, p1, fa[0][i / 2], fa[1][i / 2]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = __fmaf_rn(l0, c0, sum0);
      l1 = __fmaf_rn(l1, c1, sum1);

      // the tile's P.V in an accumulator of its own, term by term, then
      // O = O * corr + tile
      float part[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) part[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < PV_TERMS; ++j)
        frag_product<DP, BK>(part, fa[pv_a(j)], sVs + pv_b(j) * KV_PART);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(part);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i)
        acc[i] = __fmaf_rn(acc[i], i % 4 < 2 ? c0 : c1, part[i]);
    }
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);   // stage is free
    ring_next<STAGES>(stage, phase);
  }

  float* ob = o + b * os.b + h * os.h;
  const float d0 = fmaxf(l0, 1e-37f), d1 = fmaxf(l1, 1e-37f);
  // lse in natural-log units: m is in log2 units, l = sum 2^(x - m)
  if (lse != nullptr && lane % 4 == 0) {
    float* lrow = lse + ((long long)b * gridDim.y + h) * S;
    if (qpos0 < S) lrow[qpos0] = m0 * LN2 + logf(d0);
    if (qpos1 < S) lrow[qpos1] = m1 * LN2 + logf(d1);
  }
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const bool lo = i % 4 < 2;
    const int qpos = lo ? qpos0 : qpos1, col = 8 * (i / 4) + cq;
    const float den = lo ? d0 : d1;
    if (qpos < S && col < Dh) {
      float* out = ob + qpos * os.s + col;
      out[0] = acc[i] / den;
      out[1] = acc[i + 1] / den;
    }
  }
}

// The split pass: one warp a row of q (the first B S H warps) or of k and
// v (the next B S KV), each into its three parts at row w of qp or kp and
// vp: (B, S, heads, 3 DP) bf16, contiguous.
__global__ void __launch_bounds__(256)
fa_fwd_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    __nv_bfloat16* __restrict__ qp,
                    __nv_bfloat16* __restrict__ kp,
                    __nv_bfloat16* __restrict__ vp, int B, int S, int H,
                    int KV, int Dh, int DP, Strides qs, Strides ks,
                    Strides vs) {
  const int lane = threadIdx.x % 32;
  const long long w = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const long long nq = (long long)B * S * H;
  if (w < nq) {                      // a q row: w = (b * S + s) * H + h
    const int h = (int)(w % H), s = (int)(w / H % S), b = (int)(w / H / S);
    split_row(qp + w * 3 * DP, q + b * qs.b + s * qs.s + h * qs.h, Dh, DP,
              lane);
    return;
  }
  const long long r = w - nq;        // a kv row: (b * S + s) * KV + kvh
  if (r >= (long long)B * S * KV) return;
  const int kvh = (int)(r % KV), s = (int)(r / KV % S);
  const int b = (int)(r / KV / S);
  split_row(kp + r * 3 * DP, k + b * ks.b + s * ks.s + kvh * ks.h, Dh, DP,
            lane);
  split_row(vp + r * 3 * DP, v + b * vs.b + s * vs.s + kvh * vs.h, Dh, DP,
            lane);
}

template <int DP, int WGS, int BK, int STAGES>
cudaError_t launch_fwd_parts(const void* qp, const void* kp, const void* vp,
                             float* o, float* lse, int B, int S, int H,
                             int KV, int Dh, Strides os, int causal,
                             int window, cudaStream_t st) {
  using C = FwdPartsCfg<DP, WGS, BK, STAGES>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const long long cols = 3 * DP;     // the parts' contiguous rows
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, qp, B, S, H, (int)cols,
              Strides{cols * H * S, cols * H, cols}, C::QROWS) ||
      !encode(fn, &tk, kp, B, S, KV, (int)cols,
              Strides{cols * KV * S, cols * KV, cols}, BK) ||
      !encode(fn, &tv, vp, B, S, KV, (int)cols,
              Strides{cols * KV * S, cols * KV, cols}, BK))
    return cudaErrorInvalidValue;
  auto kernel = fa_fwd_parts_kernel<DP, WGS, BK, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + C::QROWS - 1) / C::QROWS, H, B);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(tq, tk, tv, o, lse, S, H / KV,
                                            Dh, os, causal, window,
                                            scale_log2_of(Dh));
  return cudaGetLastError();
}

bool bad_fwd_parts(int B, int S, int H, int KV, int Dh, int window) {
  return B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || Dh <= 0 ||
         Dh % 8 || Dh > MAX_DH || B > 65535 || H > 65535 || window < 0;
}

}  // namespace

// float32 q (B,S,H,Dh), k and v (B,S,KV,Dh), element strides (b, s,
// head), the head dim contiguous, into their bf16 parts qp (B,S,H,3 DP)
// and kp, vp (B,S,KV,3 DP), contiguous, DP = Dh rounded up to 64: hi, mid
// and lo in columns [0, DP), [DP, 2 DP), [2 DP, 3 DP), zeros past Dh.
// Off the route (Dh past 128) returns cudaErrorInvalidValue without a
// launch.
extern "C" int fa_fwd_split_launch(
    const void* q, const void* k, const void* v, void* qp, void* kp,
    void* vp, int B, int S, int H, int KV, int Dh, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    void* stream) {
  if (bad_fwd_parts(B, S, H, KV, Dh, 0)) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)B * S * (H + KV);
  if ((warps + 7) / 8 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto bf = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
  fa_fwd_split_kernel<<<(unsigned)((warps + 7) / 8), 256, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bf(qp), bf(kp), bf(vp), B, S, H, KV, Dh,
      (Dh + 63) / 64 * 64, Strides{qsb, qss, qsh}, Strides{ksb, kss, ksh},
      Strides{vsb, vss, vsh});
  return (int)cudaGetLastError();
}

// o (B,S,H,Dh) float32 (element strides (b, s, head)) and, where lse_out
// is not null, each row's lse (B,H,S) float32 contiguous, from the parts
// fa_fwd_split_launch wrote.
extern "C" int fa_fwd_parts_launch(
    const void* qp, const void* kp, const void* vp, void* o, void* lse_out,
    int B, int S, int H, int KV, int Dh, long long osb, long long oss,
    long long osh, int causal, int window, void* stream) {
  if (bad_fwd_parts(B, S, H, KV, Dh, window))
    return (int)cudaErrorInvalidValue;
  const Strides os{osb, oss, osh};
  float* out = static_cast<float*>(o);
  float* lse = static_cast<float*>(lse_out);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(Dh <= 64
                   ? launch_fwd_parts<64, 2, 64, 3>(qp, kp, vp, out, lse, B,
                                                    S, H, KV, Dh, os, causal,
                                                    window, st)
                   : launch_fwd_parts<128, 2, 32, 2>(qp, kp, vp, out, lse,
                                                     B, S, H, KV, Dh, os,
                                                     causal, window, st));
}
