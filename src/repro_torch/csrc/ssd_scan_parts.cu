// Mamba2 SSD chunked scan, forward, float32 on the tensor cores: the
// "parts" route of kernels/ssd_scan/ops.py (every input the bf16 wgmma
// route does not take: float32 or mixed dtypes, and bf16 views TMA cannot
// read).  It computes what ssd_scan.cu's header note says the forward
// computes (the reference's _ssd_kernel, src/repro/kernels/ssd_scan/
// kernel.py): per chunk of Q steps, with xdt = x dt, cs = cumsum(dt A)
// (taken in f64 and rounded once, as every route and the plain version
// take it), L[l, s] = exp(cs[l] - cs[s]) for s <= l and w = exp(cs[Q-1] -
// cs),
//   y      = (C B^T o L) xdt + exp(cs) o (C state^T)
//   state' = state exp(cs[Q-1]) + (xdt o w)^T B.
//
// What bounds it on the H100: at mamba2-780m's prefill shape in float32
// (B=4, S=1024, H=48, P=64, N=128, chunk 128) the function's products are
// 8.13 GFLOP, 0.121 ms at the CUDA cores' 67 TFLOP/s, which bounded the
// SIMT kernel (ssd_f32_kernel, ssd_scan.cu).  Here every product runs on
// wgmma as bf16 terms (below): six terms a product, 48.8 GFLOP, 0.049 ms
// at 989 TFLOP/s, beside the split pass's 137 MB (4 bytes read and 6
// written an element of x, B and C; 0.041 ms at 3.35 TB/s).
//
// Numbers.  x, B and C, and the f32 operands the route computes (P = C
// B^T o L o dt, xdt o w and the entering states), are held in three bf16
// parts, hi, mid and lo (8 + 8 + 8 bits: their sum is the value exactly,
// flash_attention_parts.cuh).  Each product sums the six terms down to
// 2^-16 of it, smallest first: lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, and
// hi.hi in an accumulator of its own (the tensor cores truncate as they
// accumulate; flash_attention_parts.cuh says why two).  Chosen by an
// emulation of these sums (tests/test_torch_ssd_f32.py): with them every
// float32 check row is within 0.30 of the reference's 1e-4 + 1e-4 |y|;
// without any one of the 24, or with P in two parts, the mamba2 row
// misses 0.5 of it.
//
// Design: the chunk-parallel form of the scan (arXiv:2405.21060 §6), four
// kernels after the split, so that each block holds only the parts it
// multiplies (three parts of x, B and C at P = 64, N = 128 take 240 KB,
// more than a block's 227) and every (b, h, chunk) is a block of its own:
//  0. ssd_parts_split_kernel: x, B and C through any strides, float32 or
//     bf16, as three bf16 parts each into a contiguous layout TMA reads
//     (x (B, S, H, 3 DP), B and C (B, S, 2, 3 NP); DP and NP: P and N
//     rounded up to 64, zeros past them); one warp a row.
//  1. ssd_parts_g_kernel: G = C B^T once per (b, chunk), as the heads
//     share it (the bf16 route recomputes it per head); two warpgroups,
//     rows 0-63 and 64-127, the second over both key halves; written in
//     the y kernel's fragment order, each thread's 32 values contiguous.
//  2. ssd_parts_state_kernel: each chunk's own state term U = (xdt o w)^T
//     B per (b, h, chunk, 64 p), its A fragments read from x's parts by
//     ldmatrix.trans, joined, scaled and split in registers; a warpgroup
//     per 64 n of the state.  Also exp(cs[Q-1]) per chunk.
//  3. ssd_parts_scan_kernel: the entering states in f32, the reference's
//     recurrence S' = S exp(cs[Q-1]) + U in its order (a multiply, then an
//     add), chunk by chunk per element, eight chunks' loads in flight;
//     each chunk's U is overwritten by the state entering it; the final
//     state.
//  4. ssd_parts_y_kernel: y per (b, h, chunk, 64 p): C S^T with the state
//     split into parts in shared memory; then, per key half, P = G o L o
//     dt built in registers from G's fragments (exp on the f32 difference
//     cs[l] - cs[s], as the plain version takes it), split into A
//     fragments, and P x over x's parts (MN-major B operand); two
//     warpgroups, rows 0-63 (the first key half) and 64-127 (both).
// Tiles are 128-byte-swizzled boxes of 64 columns x the chunk's rows
// (TMA), the zero fill padding P and N; where the chunk is under 128 rows
// the x and B tiles are zeroed first, so the rows a k-step reads past it
// are zeros (never NaN times a zero weight).  No atomics: two calls agree
// bit for bit.  A wait on an mbarrier that never completes traps.
//
// Shared memory (bytes; a block may use 232,448, 1,024 of which align the
// swizzle atoms), at NP 128 / NP 64:
//   ssd_parts_g_kernel<NP>:     C and B, 3 parts each      197,640 / 99,336
//   ssd_parts_state_kernel<NP>: x (64 p), B, 3 each        149,512 / 100,360
//   ssd_parts_y_kernel<NP>:     C, x (64 p), state (64 p)  199,176 / 125,448
#include "flash_attention_parts.cuh"

namespace {

constexpr int QP = 128;                // rows of every tile (chunk <= 128)
constexpr uint32_t BLK = QP * 128;     // one 64-column block of a tile
constexpr int MAXDIM = 128;            // Q, P and N
constexpr uint32_t FULL = 0xffffffffu;
constexpr int THREADS_SPLIT = 256;

__device__ __forceinline__ float ldv(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float lo_f(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_f(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// (v0, v1) as three bf16 pairs hi, mid and lo, their sums v0 and v1
// exactly (ref.split_parts)
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = bf16_pair(v0, v1);
  const float r0 = v0 - lo_f(hi), r1 = v1 - hi_f(hi);
  mid = bf16_pair(r0, r1);
  lo = bf16_pair(r0 - lo_f(mid), r1 - hi_f(mid));
}

// One warp writes a chunk's scalars from dt (lane j: steps 4j .. 4j+3):
// dt, and the cumulative sum of dt A taken in f64 and rounded once to
// f32 (ssd_scan.cu's chunk_scalars, in natural units); 0 past Q.  Every
// kernel of the route calls it, so all see the same bits.
__device__ __forceinline__ void chunk_scalars(float* sdt, float* scs,
                                               const void* dt, int dt_bf16,
                                               long long dbase,
                                               long long ds, float Ah, int Q,
                                               int t0, int lane) {
  float dtv[4];
  double part[4], run = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = 4 * lane + j;
    dtv[j] = s < Q ? ldv(dt, dbase + (long long)(t0 + s) * ds, dt_bf16) : 0.f;
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
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = 4 * lane + j;
    sdt[s] = dtv[j];
    scs[s] = s < Q ? (float)(before + part[j]) : 0.f;
  }
}

// the six terms of a product over parts (a of A, b of B), smallest first:
// lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi (flash_attention_parts.cuh
// rterm_a / rterm_b); the last goes to an accumulator of its own
constexpr int TERMS = RTERMS<3>;

// Zero the first `bytes` of shared memory from `base` (16 a thread a step).
__device__ __forceinline__ void zero_smem(uint8_t* base, uint32_t bytes,
                                          int tid, int threads) {
  for (uint32_t o = 16 * tid; o < bytes; o += 16 * threads)
    *reinterpret_cast<uint4*>(base + o) = make_uint4(0, 0, 0, 0);
}

// ------------------------------------------------------------- 0. split
// One warp a row of x (the first B S H warps) or of B or C (the next 2 B
// S: row r is B's (r even) or C's row r / 2), into its three parts at row
// w of xp (B, S, H, 3 DP) or row r of bcp (B, S, 2, 3 NP).
template <typename TX, typename TBC>
__global__ void __launch_bounds__(THREADS_SPLIT)
ssd_parts_split_kernel(const TX* __restrict__ x, const TBC* __restrict__ Bm,
                       const TBC* __restrict__ Cm,
                       __nv_bfloat16* __restrict__ xp,
                       __nv_bfloat16* __restrict__ bcp, int Bb, int S, int H,
                       int P, int N, int DP, int NP, Strides xs,
                       long long bsb, long long bss, long long csb,
                       long long css) {
  const int lane = threadIdx.x % 32;
  const long long w = (long long)blockIdx.x * (THREADS_SPLIT / 32) +
                      threadIdx.x / 32;
  const long long nx = (long long)Bb * S * H;
  if (w < nx) {                      // w = (b * S + s) * H + h
    const int h = (int)(w % H), s = (int)(w / H % S), b = (int)(w / H / S);
    split_row(xp + w * 3 * DP, x + b * xs.b + s * xs.s + h * xs.h, P, DP,
              lane);
    return;
  }
  const long long r = w - nx;        // r = (b * S + s) * 2 + (0 B, 1 C)
  if (r >= 2LL * Bb * S) return;
  const int s = (int)(r / 2 % S), b = (int)(r / 2 / S);
  const TBC* src = r % 2 ? Cm + b * csb + s * css : Bm + b * bsb + s * bss;
  split_row(bcp + r * 3 * NP, src, N, NP, lane);
}

// ------------------------------------------------------------------ 1. G
template <int NP>
struct GCfg {
  static constexpr int NT = NP / 64;
  static constexpr uint32_t PART = NT * BLK;       // one part of C or B
  static constexpr uint32_t OFF_B = 3 * PART;      // C's parts, then B's
  static constexpr uint32_t OFF_BAR = 6 * PART;
  static constexpr uint32_t SMEM = OFF_BAR + 8 + 1024;
  static_assert(SMEM <= SMEM_LIMIT, "G's tiles exceed shared memory");
};

// One block per (chunk, b): g (B, nc, 4, 128, 32) f32, [.., 2 wg + kh,
// t, i] = fragment value i of thread t of warpgroup wg for key half kh
// (rows 64 wg + 16 (t / 32) + (t % 32) / 4 (+ 8 for i % 4 >= 2), columns
// 64 kh + 8 (i / 4) + 2 (t % 4) + i % 2).  Warpgroup 0 writes kh 0 only.
template <int NP>
__global__ void __launch_bounds__(256, 1)
ssd_parts_g_kernel(const __grid_constant__ CUtensorMap tbc,
                   float* __restrict__ g, int Q) {
  using C = GCfg<NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + C::OFF_BAR;
  const int tid = threadIdx.x, c = blockIdx.x, b = blockIdx.y;
  const int nc = gridDim.x;
  const int warp = __shfl_sync(FULL, tid / 32, 0), wg = warp / 4;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar, 6 * C::NT * Q * 128);
    for (int p = 0; p < 3; ++p)
      for (int k = 0; k < C::NT; ++k) {
        const uint32_t off = p * C::PART + k * BLK;
        tma_load(base + off, &tbc, bar, p * NP + 64 * k, 1, c * Q, b);
        tma_load(base + C::OFF_B + off, &tbc, bar, p * NP + 64 * k, 0, c * Q,
                 b);
      }
  }
  __syncthreads();
  if (64 * wg >= Q) return;          // no rows (no barrier follows)
  mbar_wait(bar, 0);
  __syncwarp();                      // wgmma wants the warp converged
  const uint32_t sCw = base + wg * 64 * 128;
  float4* out = reinterpret_cast<float4*>(
      g + (((long long)b * nc + c) * 4 + 2 * wg) * 128 * 32 +
      (tid % 128) * 32);
  if (wg == 0) {
    float d[32], hh[32];
    wgmma_fence();
    parts_rows_product<64, 3>(d, hh, sCw, C::PART, BLK, base + C::OFF_B,
                              C::PART, BLK, NP / 16);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(d);
    reg_fence(hh);
    sum_terms<3>(d, hh);
#pragma unroll
    for (int i = 0; i < 32; i += 4)
      out[i / 4] = make_float4(d[i], d[i + 1], d[i + 2], d[i + 3]);
  } else {
    float d[64], hh[64];
    wgmma_fence();
    parts_rows_product<128, 3>(d, hh, sCw, C::PART, BLK, base + C::OFF_B,
                               C::PART, BLK, NP / 16);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(d);
    reg_fence(hh);
    sum_terms<3>(d, hh);
#pragma unroll
    for (int i = 0; i < 64; i += 4)  // key half i / 32, 128 x 32 floats on
      out[(i / 32) * 128 * 8 + (i % 32) / 4] =
          make_float4(d[i], d[i + 1], d[i + 2], d[i + 3]);
  }
}

// ---------------------------------------------------------- 2. the state
// a warpgroup per 64 n: x's parts (64 p) and B's (NP), 144 KB at NP 128
template <int NP>
struct UCfg {
  static constexpr int NT = NP / 64;
  static constexpr int THREADS = 128 * NT;
  static constexpr uint32_t B_PART = NT * BLK;      // one part of B
  static constexpr uint32_t OFF_B = 3 * BLK;        // x's parts, then B's
  static constexpr uint32_t OFF_SCAL = OFF_B + 3 * B_PART;  // dt, w
  static constexpr uint32_t OFF_BAR = OFF_SCAL + 2 * QP * 4;
  static constexpr uint32_t SMEM = OFF_BAR + 8 + 1024;
  static_assert(SMEM <= SMEM_LIMIT, "the state's tiles exceed shared memory");
};

struct Dims {
  const void *dt, *A;
  int S, H, P, N, Q, DP;
  long long db, ds, dh, as;
  int dt_bf16, a_bf16;
};

// One block per (chunk, 64 p, head, b), a warpgroup per 64 n: u (B, H,
// nc, DP, NP) f32, the chunk's own state term (xdt o w)^T B at rows 64 pb
// .. (zeros past P and N), warpgroup wg its columns 64 wg .. 64 wg + 63;
// and e (B, H, nc) = exp(cs[Q-1]).  The warpgroups build the same A
// fragments from x's parts.
template <int NP>
__global__ void __launch_bounds__(UCfg<NP>::THREADS, NP == 64 ? 2 : 1)
ssd_parts_state_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tbc,
                       float* __restrict__ u, float* __restrict__ e,
                       const Dims a) {
  using C = UCfg<NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bar = base + C::OFF_BAR;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(FULL, tid / 32, 0);
  const int wg = warp / 4, wq = warp % 4;
  const int PB = a.DP / 64, nc = a.S / a.Q, Q = a.Q;
  const int c = blockIdx.x / PB, pb = blockIdx.x % PB;
  const int h = blockIdx.y, b = blockIdx.z;
  float* sdt = reinterpret_cast<float*>(gbase + C::OFF_SCAL);
  float* sw = sdt + QP;

  if (Q < QP) zero_smem(gbase, C::OFF_SCAL, tid, C::THREADS);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (3 + 3 * C::NT) * Q * 128);
    for (int p = 0; p < 3; ++p) {
      tma_load(base + p * BLK, &tx, bar, p * a.DP + 64 * pb, h, c * Q, b);
      for (int k = 0; k < C::NT; ++k)
        tma_load(base + C::OFF_B + p * C::B_PART + k * BLK, &tbc, bar,
                 p * NP + 64 * k, 0, c * Q, b);
    }
  }
  if (warp == 0) {                   // dt and w = exp(cs[Q-1] - cs)
    const float Ah = ldv(a.A, h * a.as, a.a_bf16);
    const long long dbase = b * a.db + h * a.dh;
    float* scs = sw;                 // cs first, then w in place
    chunk_scalars(sdt, scs, a.dt, a.dt_bf16, dbase, a.ds, Ah, Q, c * Q,
                  lane);
    __syncwarp();
    const float cl = scs[Q - 1];
    __syncwarp();                    // every lane has read it
    for (int s = lane; s < QP; s += 32)
      sw[s] = s < Q ? expf(cl - scs[s]) : 0.f;
    if (lane == 0 && pb == 0)
      e[((long long)b * a.H + h) * nc + c] = expf(cl);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  __syncwarp();

  // A = (xdt o w)^T, 64 p x 16 s a k-step: lane 8m + r reads step 16t +
  // r + 8(m/2), the 16-byte piece of p 16wq + 8(m%2) .. + 7 (swizzled) of
  // each part; register q holds (p 16wq + lane/4 + 8(q%2); s 16t + cq +
  // 8(q/2), + 1)
  const int m = lane / 8, r = lane % 8, cq = 2 * (lane % 4);
  const int j = 2 * wq + m % 2;
  const int kq = (Q + 15) / 16;
  const uint32_t sB = base + C::OFF_B + wg * BLK;
  float d[32], hh[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = hh[i] = 0.f;
  constexpr int KB = 4;              // k-steps a batch
#pragma unroll 1
  for (int t0 = 0; t0 < kq; t0 += KB) {
    uint32_t f[3][KB][4];
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t0 + t >= kq) break;
      const int s0 = 16 * (t0 + t);
      uint32_t xr[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        ldsm_x4_trans(xr[p], base + p * BLK +
                                 (s0 + r + 8 * (m / 2)) * 128 + ((j ^ r) * 16));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = s0 + cq + (q < 2 ? 0 : 8);
        const float x0 = (lo_f(xr[0][q]) + lo_f(xr[1][q])) + lo_f(xr[2][q]);
        const float x1 = (hi_f(xr[0][q]) + hi_f(xr[1][q])) + hi_f(xr[2][q]);
        const float v0 = (x0 * sdt[s]) * sw[s];
        const float v1 = (x1 * sdt[s + 1]) * sw[s + 1];
        split3(v0, v1, f[0][t][q], f[1][t][q], f[2][t][q]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t0 + t >= kq) break;
#pragma unroll
      for (int i = 0; i < TERMS; ++i) {
        const uint64_t db = smem_desc(
            sB + rterm_b(i, TERMS) * C::B_PART + (t0 + t) * 16 * 128, BLK,
            1024);
        if (i == TERMS - 1) wgmma_rs<64>(hh, f[0][t], db);
        else wgmma_rs<64>(d, f[rterm_a(i, TERMS)][t], db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(d);
    reg_fence(hh);
  }
  sum_terms<3>(d, hh);
  // rows p 64 pb + 16 wq + lane/4 (+ 8), columns 64 wg + 8 (i/4) + cq (+1)
  float* ub = u + ((((long long)b * a.H + h) * nc + c) * a.DP + 64 * pb +
                   16 * wq + lane / 4) * NP + 64 * wg + cq;
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    *reinterpret_cast<float2*>(ub + (i % 4 < 2 ? 0 : 8 * NP) + 8 * (i / 4)) =
        make_float2(d[i], d[i + 1]);
}

// ----------------------------------------------------------- 3. the scan
// One thread a float4 of the (DP, NP) state of one (b, h), the chunks in
// order: u[c] := the state entering chunk c (f32), state := state * e[c]
// + u[c] (two roundings, as the reference and the plain version take
// them); the final state into `state` (B, H, P, N).
__global__ void __launch_bounds__(256)
ssd_parts_scan_kernel(float* __restrict__ u, const float* __restrict__ e,
                      float* __restrict__ state, int nc, int P, int N,
                      int DP, int NP) {
  const int bh = blockIdx.y;
  const int i4 = blockIdx.x * 256 + threadIdx.x, n4 = DP * NP / 4;
  if (i4 >= n4) return;
  float4* up = reinterpret_cast<float4*>(u + (long long)bh * nc * DP * NP) +
               i4;
  const float* eb = e + (long long)bh * nc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  // SCAN_BATCH chunks' loads issued before their stores, so that they are
  // in flight together (a load after a store to the same array waits for
  // it: the compiler cannot prove them apart)
  constexpr int SCAN_BATCH = 8;
  for (int c0 = 0; c0 < nc; c0 += SCAN_BATCH) {
    float4 v[SCAN_BATCH];
    float ec[SCAN_BATCH];
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      if (c0 + k < nc) {
        v[k] = up[(long long)(c0 + k) * n4];
        ec[k] = eb[c0 + k];
      }
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      if (c0 + k < nc) {
        up[(long long)(c0 + k) * n4] = s;
        s = make_float4(s.x * ec[k] + v[k].x, s.y * ec[k] + v[k].y,
                        s.z * ec[k] + v[k].z, s.w * ec[k] + v[k].w);
      }
  }
  const float vals[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int idx = 4 * i4 + k, p = idx / NP, n = idx % NP;
    if (p < P && n < N) state[((long long)bh * P + p) * N + n] = vals[k];
  }
}

// --------------------------------------------------------------- 4. y
template <int NP>
struct YCfg {
  static constexpr int NT = NP / 64;
  static constexpr uint32_t C_PART = NT * BLK;      // C's parts
  static constexpr uint32_t OFF_X = 3 * C_PART;     // x's (64 p)
  static constexpr uint32_t S_PART = NT * 64 * 128; // the state's (64 p)
  static constexpr uint32_t OFF_S = OFF_X + 3 * BLK;
  static constexpr uint32_t OFF_SCAL = OFF_S + 3 * S_PART;   // dt, cs, e^cs
  static constexpr uint32_t OFF_BAR = OFF_SCAL + 3 * QP * 4;
  static constexpr uint32_t SMEM = OFF_BAR + 8 + 1024;
  static_assert(SMEM <= SMEM_LIMIT, "y's tiles exceed shared memory");
};

// P = G o L o dt over key half kh for this thread's rows l0 and l0 + 8
// (s <= l < Q only; exp on the f32 difference cs[l] - cs[s]), split into
// three parts: pair i/2 of the G fragment gv is register i/2 % 4 of k-step
// i/8's A fragment of P x.
__device__ __forceinline__ void build_p(uint32_t (&f)[3][16],
                                        const float (&gv)[32],
                                        const float* scs, const float* sdt,
                                        int kh, int l0, float c0, float c1,
                                        int cq, int Q) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const bool top = i % 4 < 2;
    const int l = top ? l0 : l0 + 8;
    const float cl = top ? c0 : c1;
    const int s = 64 * kh + 8 * (i / 4) + cq;
    const float p0 =
        s <= l && l < Q ? (gv[i] * expf(cl - scs[s])) * sdt[s] : 0.f;
    const float p1 = s + 1 <= l && l < Q
                         ? (gv[i + 1] * expf(cl - scs[s + 1])) * sdt[s + 1]
                         : 0.f;
    split3(p0, p1, f[0][i / 2], f[1][i / 2], f[2][i / 2]);
  }
}

// One block per (chunk, 64 p, head, b), two warpgroups: warpgroup wg
// writes y's rows 64 wg .. 64 wg + 63 of the chunk at columns 64 pb ..
// 64 pb + 63 (x's dtype; y contiguous (B, S, H, P)).
template <int NP>
__global__ void __launch_bounds__(256, 1)
ssd_parts_y_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tbc,
                   const float* __restrict__ g, const float* __restrict__ u,
                   void* __restrict__ y, int y_bf16, const Dims a) {
  using C = YCfg<NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bar = base + C::OFF_BAR;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(FULL, tid / 32, 0), wg = warp / 4;
  const int wq = warp % 4;
  const int PB = a.DP / 64, nc = a.S / a.Q, Q = a.Q;
  const int c = blockIdx.x / PB, pb = blockIdx.x % PB;
  const int h = blockIdx.y, b = blockIdx.z;
  float* sdt = reinterpret_cast<float*>(gbase + C::OFF_SCAL);
  float* scs = sdt + QP;
  float* sec = scs + QP;

  if (Q < QP)                        // x's rows past the chunk read as 0
    zero_smem(gbase + C::OFF_X, 3 * BLK, tid, 256);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (3 + 3 * C::NT) * Q * 128);
    for (int p = 0; p < 3; ++p) {
      tma_load(base + C::OFF_X + p * BLK, &tx, bar, p * a.DP + 64 * pb, h,
               c * Q, b);
      for (int k = 0; k < C::NT; ++k)
        tma_load(base + p * C::C_PART + k * BLK, &tbc, bar, p * NP + 64 * k,
                 1, c * Q, b);
    }
  }
  // the state entering the chunk (rows 64 pb .., all NP columns) as three
  // parts in the K-major layout of C S^T's B operand: 8 columns a thread
  // a step, one 16-byte piece of each part
  if (c > 0) {
    const float* ub = u + ((((long long)b * a.H + h) * nc + c) * a.DP +
                           64 * pb) * NP;
    for (int it = tid; it < 64 * NP / 8; it += 256) {
      const int p = it / (NP / 8), n8 = it % (NP / 8);
      const float4 v0 = *reinterpret_cast<const float4*>(ub + p * NP + 8 * n8);
      const float4 v1 =
          *reinterpret_cast<const float4*>(ub + p * NP + 8 * n8 + 4);
      uint4 q[3];
      split3(v0.x, v0.y, q[0].x, q[1].x, q[2].x);
      split3(v0.z, v0.w, q[0].y, q[1].y, q[2].y);
      split3(v1.x, v1.y, q[0].z, q[1].z, q[2].z);
      split3(v1.z, v1.w, q[0].w, q[1].w, q[2].w);
      const uint32_t off = (n8 / 8) * 64 * 128 + p * 128 +
                           (((n8 % 8) ^ (p % 8)) * 16);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint4*>(gbase + C::OFF_S + k * C::S_PART + off) =
            q[k];
    }
  }
  if (warp == 0) {                   // dt, cs, exp(cs)
    const float Ah = ldv(a.A, h * a.as, a.a_bf16);
    chunk_scalars(sdt, scs, a.dt, a.dt_bf16, b * a.db + h * a.dh, a.ds, Ah,
                  Q, c * Q, lane);
    __syncwarp();
    for (int s = lane; s < QP; s += 32)
      sec[s] = s < Q ? expf(scs[s]) : 0.f;
  }
  fence_proxy_async();               // the state's parts, for wgmma
  __syncthreads();
  if (64 * wg >= Q) return;          // no rows (no barrier follows)

  // this thread's rows l0, l1 = l0 + 8 and columns 8j + cq, + 1 of every
  // accumulator
  const int l0 = 64 * wg + 16 * wq + lane / 4, l1 = l0 + 8;
  const int cq = 2 * (lane % 4);
  const float4* gp = reinterpret_cast<const float4*>(
      g + (((long long)b * nc + c) * 4 + 2 * wg) * 128 * 32 +
      (tid % 128) * 32);
  float gv[32];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 v = gp[i];
    gv[4 * i] = v.x, gv[4 * i + 1] = v.y, gv[4 * i + 2] = v.z,
    gv[4 * i + 3] = v.w;
  }
  mbar_wait(bar, 0);
  __syncwarp();                      // wgmma wants the warp converged

  // y = exp(cs) o (C S^T), then P x per key half
  float yacc[32], d[32], hh[32];
  if (c > 0) {
    wgmma_fence();
    parts_rows_product<64, 3>(d, hh, base + wg * 64 * 128, C::C_PART, BLK,
                              base + C::OFF_S, C::S_PART, 64 * 128, NP / 16);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(d);
    reg_fence(hh);
    sum_terms<3>(d, hh);
    const float e0 = sec[l0], e1 = sec[l1];
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] = (i % 4 < 2 ? e0 : e1) * d[i];
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = hh[i] = 0.f;

  const float c0 = scs[l0], c1 = scs[l1];
  const uint32_t sX = base + C::OFF_X;
#pragma unroll 1
  for (int kh = 0; kh <= wg && 64 * kh < Q; ++kh) {
    if (kh == 1) {                   // the second key half's G
      const float4* gq = gp + 128 * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = gq[i];
        gv[4 * i] = v.x, gv[4 * i + 1] = v.y, gv[4 * i + 2] = v.z,
        gv[4 * i + 3] = v.w;
      }
    }
    uint32_t f[3][16];
    build_p(f, gv, scs, sdt, kh, l0, c0, c1, cq, Q);
    const int kt = min(4, (Q - 64 * kh + 15) / 16);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t >= kt) break;
#pragma unroll
      for (int i = 0; i < TERMS; ++i) {
        const int pa = rterm_a(i, TERMS);
        const uint32_t fa[4] = {f[pa][4 * t], f[pa][4 * t + 1],
                                f[pa][4 * t + 2], f[pa][4 * t + 3]};
        const uint64_t db = smem_desc(
            sX + rterm_b(i, TERMS) * BLK + (64 * kh + 16 * t) * 128, BLK,
            1024);
        if (i == TERMS - 1) wgmma_rs<64>(hh, fa, db);
        else wgmma_rs<64>(d, fa, db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(d);
    reg_fence(hh);
  }

  // y = exp(cs) o (C S^T) + (P x's cross terms + its hi.hi)
  const int p0 = 64 * pb + cq;
  const long long hp = (long long)a.H * a.P;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int l = i % 4 < 2 ? l0 : l1, p = p0 + 8 * (i / 4);
    if (l >= Q) continue;
    const long long at = ((long long)b * a.S + c * Q + l) * hp +
                         (long long)h * a.P + p;
    const float v0 = yacc[i] + (d[i] + hh[i]);
    const float v1 = yacc[i + 1] + (d[i + 1] + hh[i + 1]);
    if (y_bf16) {
      __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
      if (p < a.P) yb[at] = __float2bfloat16_rn(v0);
      if (p + 1 < a.P) yb[at + 1] = __float2bfloat16_rn(v1);
    } else {
      float* yf = static_cast<float*>(y);
      if (p < a.P) yf[at] = v0;
      if (p + 1 < a.P) yf[at + 1] = v1;
    }
  }
}

// ------------------------------------------------------------ launchers
template <int NP>
cudaError_t launch_parts(const void* xp, const void* bcp, float* g,
                         float* u, float* e, void* y, int y_bf16,
                         float* state, int Bb, const Dims& a,
                         cudaStream_t st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const long long xc = 3LL * a.DP, bc = 3LL * NP;   // the parts' row widths
  CUtensorMap tx, tbc;
  if (!encode(fn, &tx, xp, Bb, a.S, a.H, (int)xc,
              Strides{xc * a.H * a.S, xc * a.H, xc}, a.Q) ||
      !encode(fn, &tbc, bcp, Bb, a.S, 2, (int)bc,
              Strides{bc * 2 * a.S, bc * 2, bc}, a.Q))
    return cudaErrorInvalidValue;
  const int nc = a.S / a.Q, PB = a.DP / 64;
  cudaError_t err;
  auto kg = ssd_parts_g_kernel<NP>;
  auto ku = ssd_parts_state_kernel<NP>;
  auto ky = ssd_parts_y_kernel<NP>;
  if ((err = cudaFuncSetAttribute(
           kg, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)GCfg<NP>::SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           ku, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)UCfg<NP>::SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           ky, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)YCfg<NP>::SMEM)) != cudaSuccess)
    return err;
  kg<<<dim3(nc, Bb), 256, GCfg<NP>::SMEM, st>>>(tbc, g, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ku<<<dim3(nc * PB, a.H, Bb), UCfg<NP>::THREADS, UCfg<NP>::SMEM, st>>>(
      tx, tbc, u, e, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n4 = a.DP * NP / 4;
  ssd_parts_scan_kernel<<<dim3((n4 + 255) / 256, Bb * a.H), 256, 0, st>>>(
      u, e, state, nc, a.P, a.N, a.DP, NP);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ky<<<dim3(nc * PB, a.H, Bb), 256, YCfg<NP>::SMEM, st>>>(tx, tbc, g, u, y,
                                                           y_bf16, a);
  return cudaGetLastError();
}

bool bad_dims(int Bb, int S, int H, int P, int N, int chunk) {
  return Bb <= 0 || Bb > 65535 || S <= 0 || H <= 0 || H > 65535 || P <= 0 ||
         P > MAXDIM || N <= 0 || N > MAXDIM || chunk <= 0 ||
         chunk > MAXDIM || S % chunk;
}

int pad64(int d) { return (d + 63) / 64 * 64; }

}  // namespace

// x (B,S,H,P), B and C (B,S,N), each float32 (dtype 0) or bfloat16 (1),
// element strides (b, s, head) of x and (b, s) of B and C, the last axis
// contiguous, into their bf16 parts: xp (B,S,H,3 DP) and bcp (B,S,2,3
// NP), contiguous, DP and NP = P and N rounded up to 64 (hi, mid and lo
// in columns [0, D), [D, 2 D), [2 D, 3 D) of a row, zeros past P or N;
// bcp's head 0 is B's, head 1 C's).  P and N at most 128.
extern "C" int ssd_parts_split_launch(
    const void* x, const void* B, const void* C, void* xp, void* bcp,
    int Bb, int S, int H, int P, int N, long long xsb, long long xss,
    long long xsh, long long bsb, long long bss, long long csb,
    long long css, int x_dtype, int bc_dtype, void* stream) {
  if (bad_dims(Bb, S, H, P, N, 1) || (x_dtype | bc_dtype) & ~1)
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)Bb * S * (H + 2);
  const long long blocks = (warps + THREADS_SPLIT / 32 - 1) /
                           (THREADS_SPLIT / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Strides xs{xsb, xss, xsh};
  const int DP = pad64(P), NP = pad64(N);
  auto bf = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
  using F = float;
  using H16 = __nv_bfloat16;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks);
#define SSD_SPLIT(TX, TBC)                                                  \
  ssd_parts_split_kernel<TX, TBC><<<grid, THREADS_SPLIT, 0, st>>>(          \
      static_cast<const TX*>(x), static_cast<const TBC*>(B),               \
      static_cast<const TBC*>(C), bf(xp), bf(bcp), Bb, S, H, P, N, DP, NP, \
      xs, bsb, bss, csb, css)
  if (x_dtype == 0 && bc_dtype == 0) SSD_SPLIT(F, F);
  else if (x_dtype == 0) SSD_SPLIT(F, H16);
  else if (bc_dtype == 0) SSD_SPLIT(H16, F);
  else SSD_SPLIT(H16, H16);
#undef SSD_SPLIT
  return (int)cudaGetLastError();
}

// y (B,S,H,P) contiguous in y_dtype (0 float32, 1 bfloat16) and the final
// state (B,H,P,N) f32 contiguous, from the parts ssd_parts_split_launch
// wrote; dt (B,S,H) and A (H,) through their element strides, each
// float32 or bfloat16.  Scratch, f32 contiguous: g (B, nc, 4, 128, 32)
// (C B^T), u (B, H, nc, DP, NP) (each chunk's state term, then the state
// entering it), e (B, H, nc) (exp(cs[Q-1])); nc = S / chunk.  Four
// kernels on `stream`: G, the chunks' state terms, the scan, y.
extern "C" int ssd_parts_launch(
    const void* xp, const void* bcp, const void* dt, const void* A, void* y,
    void* state, void* g, void* u, void* e, int Bb, int S, int H, int P,
    int N, int chunk, long long dsb, long long dss, long long dsh,
    long long as, int dt_dtype, int a_dtype, int y_dtype, void* stream) {
  if (bad_dims(Bb, S, H, P, N, chunk) || (dt_dtype | a_dtype | y_dtype) & ~1 ||
      (long long)(S / chunk) * (pad64(P) / 64) * 2 > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(xp) % 16 ||
      reinterpret_cast<uintptr_t>(bcp) % 16)
    return (int)cudaErrorInvalidValue;
  const Dims a{dt, A, S, H, P, N, chunk, pad64(P), dsb, dss, dsh, as,
               dt_dtype, a_dtype};
  float *gf = static_cast<float*>(g), *uf = static_cast<float*>(u),
        *ef = static_cast<float*>(e), *sf = static_cast<float*>(state);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(N <= 64 ? launch_parts<64>(xp, bcp, gf, uf, ef, y, y_dtype,
                                          sf, Bb, a, st)
                       : launch_parts<128>(xp, bcp, gf, uf, ef, y, y_dtype,
                                           sf, Bb, a, st));
}
