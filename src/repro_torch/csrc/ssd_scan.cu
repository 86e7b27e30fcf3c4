// Mamba2 SSD chunked scan (arXiv:2405.21060 §6), forward.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, ssd_fwd / _ssd_kernel --
// the Pallas kernel whose grid (batch, head, chunk) walks the chunks of a
// sequence in order and carries the (P, N) f32 state in VMEM scratch from
// one chunk to the next.  Per chunk of Q steps, with xdt = x * dt,
// cs = cumsum(dt * A), L[l, s] = exp(cs[l] - cs[s]) for s <= l (else 0):
//   y      = (C B^T o L) xdt + exp(cs) o (C state^T)
//   state' = state * exp(cs[Q-1]) + (xdt o exp(cs[Q-1] - cs))^T B
// and the final state is written once, after the last chunk.  y takes x's
// type, the state is f32.  The cumulative sums are taken in f64 and
// rounded once to f32, as the plain version takes them: in f32 their
// rounding would depend on the order of the scan, and at chunk 128, where
// they reach about -100, it moves y by ~4e-4.
//
// What bounds it on the H100: at mamba2-780m's prefill (B=4, S=1024, H=48,
// P=64, N=128, chunk 128, x/B/C bf16, dt f32) the function reads and
// writes 59.5 MB (17.8 us at 3.35 TB/s) and does about 8.1 GFLOP over the
// lower triangles with C B^T shared by the heads (8.2 us on the tensor
// cores): bytes bound it.  At zamba2-7b's (B=4, S=896, H=112, P=64, N=64)
// it moves 112.6 MB (33.6 us).
//
// Two routes, chosen by the wrapper (kernels/ssd_scan/ops.py, route());
// neither falls back to the other.
//
// bfloat16 x, B and C whose layout TMA can read, P a multiple of 8:
// ssd_wgmma_kernel.  One block of two warpgroups owns one (b, h) and walks
// its chunks in order, as the TPU's sequential chunk axis does; warpgroup
// g computes y's rows 64g .. 64g + 63 of each chunk.  What the design does
// about the limits of the first, f32 SIMT version (now the float32 route
// below):
//  1. Arithmetic.  Every product runs on the tensor cores (wgmma, bf16 in,
//     f32 accumulation) instead of f32 FMAs paced by shared-memory loads:
//     C B^T (C and B K-major from shared memory; exact, both are bf16
//     inputs); C state^T (the state's bf16 copy the K-major B operand);
//     (C B^T o L) xdt with dt folded into the register fragment: column s
//     of the C B^T accumulator is scaled by L[l, s] dt[s] in registers
//     and fed as the A operand, x's tile unchanged as the MN-major B
//     operand (flash's P.V pattern); the state update (x o w)^T B, w[s] =
//     dt[s] exp(cs[Q-1] - cs[s]), its A fragments read from x's tile by
//     ldmatrix.trans and scaled in registers, B's tile the MN-major B
//     operand.  Each of the three f32 operands (P, the state, x o w) is
//     split into bf16 hi + lo, two products instead of one: rounded to
//     one bf16 (2^-9), y missed the reference's 5e-2 + 5e-2 |y| on the
//     card (|y| reaches ~300 at chunk 128, and its terms more, so a
//     term's rounding is not small beside the tolerance where y is); with
//     hi + lo (~2^-17) y's own rounding to bf16 sets the error
//     (chip_smoke.py prints each check's share of its tolerance).
//     Warpgroup 0's rows see only the first 64 keys (the tiles above the
//     diagonal are never multiplied); L is built only where s <= l (above
//     the diagonal cs[l] - cs[s] is positive and exp would overflow).  The
//     state stays in registers in f32 as wgmma accumulators, scaled by
//     exp(cs[Q-1]) in place before the update accumulates onto it; at
//     P <= 64 and N > 64 each warpgroup holds one 64-column half, else
//     warpgroup g < P/64 its 64 rows.
//  2. Resident blocks.  Registers, not shared memory, set the occupancy:
//     the products' accumulators and fragments need up to 255 registers a
//     thread, and ptxas caps a block of more than 8 warps at 168 (with
//     setmaxnreg or without), where this kernel spilled and serialized
//     its wgmmas.  So a block is the two warpgroups alone (256 threads,
//     no producer warp), one block an SM (213 KB of shared memory at
//     mamba2's shape): 192 blocks at mamba2's B=4 shape run in two waves,
//     each SM's tensor cores shared by its two warpgroups.
//  3. Overlap.  A 2-stage ring of the chunks' x (Q x P), B and C (Q x N)
//     tiles (TMA, one mbarrier a stage; one stage at P = N = 128, where
//     two would not fit): thread 0 asks for chunk c + 2 as soon as chunk
//     c's readers are past, so each load has a chunk's time to land.  One
//     warp loads the next chunk's dt as a chunk starts and writes its
//     scalars (dt, cs log2(e), exp(cs), w; the cumulative sum a warp scan
//     in f64) at the chunk's end, beside the tiles.  y is staged in shared
//     memory and written by TMA stores, so no thread holds a global
//     address.  Two block barriers a chunk remain: the stage and the
//     state's copies are free, and the new copies are written.
//  4. C B^T is still recomputed by every head, one of the block's five
//     products (C B^T, C state^T hi and lo, P x hi and lo) besides the
//     update.
// Tiles are 128-byte-swizzled boxes 64 columns wide, rows = the chunk;
// TMA's zero fill pads P and N to 64 or 128, and the block zeroes its
// shared memory once, so rows past a chunk of under 128 steps (and under
// wgmma's M = 64) read as zeros; rows l >= Q and keys s >= Q are masked,
// and y's stores cover the valid rows only.  Inputs are read through
// their strides (TMA needs a 16-byte-aligned base and byte strides that
// are multiples of 16; the wrapper sends any other layout to the float32
// route).  A wait on an mbarrier that never completes traps after ~2^35
// cycles instead of hanging the card.
//
// Everything else (float32 inputs, whose 1e-4 tolerance bf16 operands
// cannot promise at chunk 128, and layouts TMA cannot read): ssd_f32_kernel,
// the first port's SIMT kernel.  One block of 256 threads owns one (b, h)
// and loops over the chunks itself, the state in shared memory.  Per
// chunk it stages xdt (Q x P), B (Q x N) and the cumulative sums in shared
// memory as f32, then builds y in stripes of R = 32 rows (the stripe's C
// rows, its (C B^T o L) rows over the keys below its last row, then y's
// rows), and updates the state after the last stripe.  Every product is
// a 4 x 2 register tile per thread, its multiply-adds spelled __fmaf_rn
// since the library builds with --fmad=false.  The chunk, P and N are
// run-time values up to 128.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

// ------------------------------------------------------------ float32 route

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TR = 4;                // rows of a thread's tile (per warp)
constexpr int TC = 2;                // column groups of 32 (across lanes)
constexpr int R = WARPS * TR;        // rows of a stripe of y
constexpr int MAXDIM = 128;          // Q, P and N

struct Args {
  const void *x, *dt, *A, *B, *C;
  void* y;
  float* state;
  int S, H, P, N, Q;
  long long xb, xs, xh, db, ds, dh, as, bb, bs, cb, cs;
  int x_bf16, dt_bf16, a_bf16, bc_bf16;
};

__device__ __forceinline__ float ld(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(THREADS) ssd_f32_kernel(Args a) {
  extern __shared__ float smem[];
  const int Q = a.Q, P = a.P, N = a.N;
  const int LD = N | 1;              // odd pitch: conflict-free column reads
  float* sX = smem;                  // Q x P    x * dt
  float* sB = sX + Q * P;            // Q x LD   B
  float* sS = sB + Q * LD;           // P x LD   the running state
  float* sC = sS + P * LD;           // R x N    C rows of a stripe
  float* sG = sC + R * N;            // R x Q    (C B^T o L) rows of a stripe
  float* sCs = sG + R * Q;           // Q        cumsum(dt * A)
  float* sE = sCs + Q;               // Q        exp(cs)
  float* sD = sE + Q;                // Q        dt, then exp(cs[Q-1] - cs)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const float A = ld(a.A, h * a.as, a.a_bf16);
  const long long xbase = b * a.xb + h * a.xh, dbase = b * a.db + h * a.dh;
  const long long bbase = b * a.bb, cbase = b * a.cb;

  for (int e = tid; e < P * N; e += THREADS) sS[(e / N) * LD + e % N] = 0.f;

  for (int t0 = 0; t0 < a.S; t0 += Q) {
    __syncthreads();                 // the last chunk's readers are done
    for (int s = tid; s < Q; s += THREADS) {
      const float dtv = ld(a.dt, dbase + (t0 + s) * a.ds, a.dt_bf16);
      sD[s] = dtv;
      sCs[s] = dtv * A;
    }
    __syncthreads();
    if (warp == 0) {                 // inclusive cumsum of dt * A
      const int k = (Q + 31) / 32, i0 = lane * k;
      double run = 0.0, part[MAXDIM / 32];
#pragma unroll
      for (int j = 0; j < MAXDIM / 32; ++j) {
        if (j < k && i0 + j < Q) run += (double)sCs[i0 + j];
        part[j] = run;
      }
      double tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += v;
      }
      const double before = tot - run;
#pragma unroll
      for (int j = 0; j < MAXDIM / 32; ++j)
        if (j < k && i0 + j < Q) sCs[i0 + j] = (float)(before + part[j]);
    }
    for (int e = tid; e < Q * P; e += THREADS) {
      const int s = e / P, p = e - s * P;
      sX[e] = ld(a.x, xbase + (t0 + s) * a.xs + p, a.x_bf16) * sD[s];
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int s = e / N, n = e - s * N;
      sB[s * LD + n] = ld(a.B, bbase + (t0 + s) * a.bs + n, a.bc_bf16);
    }
    __syncthreads();
    for (int s = tid; s < Q; s += THREADS) {
      sE[s] = expf(sCs[s]);
      sD[s] = expf(sCs[Q - 1] - sCs[s]);
    }
    __syncthreads();

    // ---- y, in stripes of R rows
    for (int l0 = 0; l0 < Q; l0 += R) {
      const int rows = min(R, Q - l0), s_end = l0 + rows;
      for (int e = tid; e < R * N; e += THREADS) {
        const int i = e / N, n = e - i * N;
        sC[e] = i < rows
                    ? ld(a.C, cbase + (t0 + l0 + i) * a.cs + n, a.bc_bf16)
                    : 0.f;
      }
      __syncthreads();
      // (C B^T o L) for the stripe's rows, keys s < s_end only
      for (int s0 = 0; s0 < s_end; s0 += 32 * TC) {
        int sj[TC];
#pragma unroll
        for (int j = 0; j < TC; ++j) sj[j] = min(s0 + lane + 32 * j, Q - 1);
        float g[TR][TC] = {};
        for (int n = 0; n < N; ++n) {
          float cv[TR], bv[TC];
#pragma unroll
          for (int r = 0; r < TR; ++r) cv[r] = sC[(warp * TR + r) * N + n];
#pragma unroll
          for (int j = 0; j < TC; ++j) bv[j] = sB[sj[j] * LD + n];
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int j = 0; j < TC; ++j)
              g[r][j] = __fmaf_rn(cv[r], bv[j], g[r][j]);
        }
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const int i = warp * TR + r, l = l0 + i;
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const int s = s0 + lane + 32 * j;
            if (s < Q)
              sG[i * Q + s] = (i < rows && s <= l)
                                  ? g[r][j] * expf(sCs[l] - sCs[s])
                                  : 0.f;
          }
        }
      }
      __syncthreads();
      // y rows = (C B^T o L) xdt + exp(cs) o (C state^T)
      for (int p0 = 0; p0 < P; p0 += 32 * TC) {
        int pj[TC];
#pragma unroll
        for (int j = 0; j < TC; ++j) pj[j] = min(p0 + lane + 32 * j, P - 1);
        float acc[TR][TC] = {}, cst[TR][TC] = {};
        for (int s = 0; s < s_end; ++s) {
          float gv[TR], xv[TC];
#pragma unroll
          for (int r = 0; r < TR; ++r) gv[r] = sG[(warp * TR + r) * Q + s];
#pragma unroll
          for (int j = 0; j < TC; ++j) xv[j] = sX[s * P + pj[j]];
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int j = 0; j < TC; ++j)
              acc[r][j] = __fmaf_rn(gv[r], xv[j], acc[r][j]);
        }
        for (int n = 0; n < N; ++n) {
          float cv[TR], sv[TC];
#pragma unroll
          for (int r = 0; r < TR; ++r) cv[r] = sC[(warp * TR + r) * N + n];
#pragma unroll
          for (int j = 0; j < TC; ++j) sv[j] = sS[pj[j] * LD + n];
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int j = 0; j < TC; ++j)
              cst[r][j] = __fmaf_rn(cv[r], sv[j], cst[r][j]);
        }
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const int i = warp * TR + r;
          if (i >= rows) continue;
          const int t = t0 + l0 + i;
          const float e = sE[l0 + i];
          const long long yrow = (((long long)b * a.S + t) * a.H + h) * P;
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const int p = p0 + lane + 32 * j;
            if (p >= P) continue;
            const float v = __fmaf_rn(e, cst[r][j], acc[r][j]);
            if (a.x_bf16)
              static_cast<__nv_bfloat16*>(a.y)[yrow + p] =
                  __float2bfloat16_rn(v);
            else
              static_cast<float*>(a.y)[yrow + p] = v;
          }
        }
      }
      __syncthreads();               // sC, sG and sS readers are done
    }

    // ---- state' = state * exp(cs[Q-1]) + sum_s decay_s xdt_s^T B_s
    const float ecl = sE[Q - 1];
    for (int p0 = 0; p0 < P; p0 += R) {
      for (int n0 = 0; n0 < N; n0 += 32 * TC) {
        int pr[TR], nj[TC];
#pragma unroll
        for (int r = 0; r < TR; ++r) pr[r] = min(p0 + warp * TR + r, P - 1);
#pragma unroll
        for (int j = 0; j < TC; ++j) nj[j] = min(n0 + lane + 32 * j, N - 1);
        float u[TR][TC] = {};
        for (int s = 0; s < Q; ++s) {
          const float d = sD[s];
          float xv[TR], bv[TC];
#pragma unroll
          for (int r = 0; r < TR; ++r) xv[r] = sX[s * P + pr[r]];
#pragma unroll
          for (int j = 0; j < TC; ++j) bv[j] = sB[s * LD + nj[j]] * d;
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int j = 0; j < TC; ++j)
              u[r][j] = __fmaf_rn(xv[r], bv[j], u[r][j]);
        }
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const int p = p0 + warp * TR + r;
          if (p >= P) continue;
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const int n = n0 + lane + 32 * j;
            if (n < N) sS[p * LD + n] = __fmaf_rn(sS[p * LD + n], ecl, u[r][j]);
          }
        }
      }
    }
  }
  __syncthreads();
  float* out = a.state + ((long long)b * a.H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) out[e] = sS[(e / N) * LD + e % N];
}


// --------------------------------------------------------------- bf16 route
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int QP = 128;              // rows of every tile (chunk <= 128)
constexpr uint32_t BLK = QP * 128;   // one 64-column block of a tile

template <int PP, int NP>
struct SsdCfg {
  static constexpr int PT = PP / 64, NT = NP / 64;
  static constexpr int STAGES = PP + NP > 192 ? 1 : 2;
  static constexpr int THREADS = 256;            // two warpgroups
  // who holds the state (f32, as wgmma accumulators): at P <= 64 and
  // N > 64 each warpgroup one 64-column half; else warpgroup g < PT its
  // 64 rows p, all columns.  NW is an owner's width.
  static constexpr bool SPLIT_N = PT == 1 && NT == 2;
  static constexpr int OWNERS = PT == 2 || SPLIT_N ? 2 : 1;
  static constexpr int NW = SPLIT_N ? 64 : NP;
  // the warp that writes each chunk's scalars: one of the warpgroup with
  // the lighter share (warpgroup 0, whose rows see one key half, unless
  // it alone holds the state)
  static constexpr int SCAL_WARP = OWNERS == 2 ? 0 : 4;
  static constexpr uint32_t X_BYTES = PT * BLK, BC_BYTES = NT * BLK;
  static constexpr uint32_t STAGE = X_BYTES + 2 * BC_BYTES;   // x, B, C
  static constexpr uint32_t ST_BYTES = PP * NP * 2;     // one bf16 copy
  static constexpr uint32_t OFF_ST = STAGES * STAGE;    // hi, then lo
  // y's rows of each warpgroup, staged for the TMA store: PT column
  // blocks of 64 rows x 128 bytes a warpgroup
  static constexpr uint32_t Y_BYTES = PT * 64 * 128;
  static constexpr uint32_t OFF_Y = OFF_ST + 2 * ST_BYTES;
  static constexpr uint32_t OFF_SCAL = OFF_Y + 2 * Y_BYTES;
  // two buffers (this chunk's, the next one's): dt, cs * log2(e),
  // exp(cs), w; QP floats each
  static constexpr uint32_t SCAL = 4 * QP * 4;
  static constexpr uint32_t OFF_BAR = OFF_SCAL + 2 * SCAL;
  static constexpr uint32_t SMEM = OFF_BAR + 8 * STAGES + 1024;
};

struct WArgs {
  const void *dt, *A;
  __nv_bfloat16* y;
  float* state;
  int S, H, P, N, Q;
  long long db, ds, dh, as;
  int dt_bf16, a_bf16;
};

// One TMA box of the 4-D map from shared memory at `src`; one bulk
// group per call.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until every bulk store of this thread has read its shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// 2^x (MUFU.EX2; relative error ~2^-22).
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// (v0, v1) rounded to a bf16 pair, v0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float v0, float v1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(v1), "f"(v0));
  return r;
}

// (v0, v1) as a bf16 pair hi and the pair of what it leaves, lo:
// hi + lo holds v to ~2^-17 of it (one bf16 alone: 2^-9).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  lo = pack_bf16(v0 - __uint_as_float(hi << 16),
                 v1 - __uint_as_float(hi & 0xffff0000u));
}

// Shared memory at a 32-bit shared address.
__device__ __forceinline__ void sts(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" :: "r"(addr), "r"(v) : "memory");
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

// G = C B^T for the 64 rows of C at sCw and the 64 keys of B at sBk,
// over kn k-steps of the state dim (started, not waited for).
__device__ __forceinline__ void start_g(float (&g)[32], uint32_t sCw,
                                        uint32_t sBk, int kn) {
  for (int t = 0; t < kn; ++t) {
    const uint32_t off = (t / 4) * BLK + (t % 4) * 32;
    wgmma_ss_n64(g, smem_desc(sCw + off, 16, 1024),
                 smem_desc(sBk + off, 16, 1024), t);
  }
}

// P = G o L o dt over a half's keys, masked to s <= l < Q, split into
// bf16 hi and lo pairs: pair i/2 of the G fragment is register i/2 % 4
// of k-step i/8's A fragment of P.x.  This thread's keys are s = 64 kh +
// 8j + cq and s + 1; their dt and cs log2(e) are loaded four j at a time.
__device__ __forceinline__ void build_p(uint32_t (&ph)[16],
                                        uint32_t (&pl)[16],
                                        const float (&g)[32], uint32_t sc,
                                        int kh, int l0, float c0, float c1,
                                        int cq, int Q) {
#pragma unroll
  for (int j0 = 0; j0 < 8; j0 += 4) {
    float2 dt[4], cs[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t s4 = 4 * (64 * kh + 8 * (j0 + j) + cq);
      dt[j] = lds2(sc + s4);
      cs[j] = lds2(sc + 4 * QP + s4);
    }
#pragma unroll
    for (int i = 4 * j0; i < 4 * j0 + 16; i += 2) {
      const bool lo = i % 4 < 2;
      const int l = lo ? l0 : l0 + 8;
      const float cl = lo ? c0 : c1;
      const int s = 64 * kh + 8 * (i / 4) + cq;
      const float2 d = dt[i / 4 - j0], e = cs[i / 4 - j0];
      const float p0 = s <= l && l < Q ? g[i] * ex2(cl - e.x) * d.x : 0.f;
      const float p1 =
          s + 1 <= l && l < Q ? g[i + 1] * ex2(cl - e.y) * d.y : 0.f;
      split2(p0, p1, ph[i / 2], pl[i / 2]);
    }
  }
}

// y += P x over a half's keys (kt k-steps of 16), P in registers.
__device__ __forceinline__ void start_px(float (&yacc)[32],
                                         const uint32_t (&ph)[16],
                                         const uint32_t (&pl)[16],
                                         uint32_t sXk, int kt) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= kt) break;
    const uint32_t ah[4] = {ph[4 * t], ph[4 * t + 1], ph[4 * t + 2],
                            ph[4 * t + 3]};
    const uint32_t al[4] = {pl[4 * t], pl[4 * t + 1], pl[4 * t + 2],
                            pl[4 * t + 3]};
    const uint64_t db = smem_desc(sXk + t * 16 * 128, BLK, 1024);
    wgmma_rs_n64(yacc, ah, db);
    wgmma_rs_n64(yacc, al, db);
  }
}

// 64 columns p0 .. p0 + 63 of y for the 64 rows of warpgroup `wg` (rows
// 64 wg .. 64 wg + 63 of the chunk): y = exp(cs) o (C state^T) with the
// state's bf16 hi and lo copies (their rows p0 .., column blocks CB
// bytes apart), then, for each 64-key half at or below the diagonal (one
// for warpgroup 0, two for warpgroup 1), G = C B^T, P = G o L o dt split
// into bf16 hi and lo register fragments, y += P x (x's column block at
// sXp).  The products are started so that each wait covers two: C state^T
// with the first G, the first P x with the second G.  Stored (TMA) to y's
// rows < Q from the staging tile at sY.  This thread holds rows l0 and
// l0 + 8 of every accumulator, at columns 8j + cq and 8j + cq + 1.
__device__ __forceinline__ void ssd_rows(uint32_t sXp, uint32_t sB,
                                         uint32_t sC, uint32_t sStH,
                                         uint32_t sStL, uint32_t CB,
                                         uint32_t sc, uint32_t sY,
                                         const CUtensorMap* ty, int wg,
                                         int l0, int cq, int Q, int kn,
                                         int p0, int h, int t0, int b) {
  const uint32_t sCw = sC + wg * 64 * 128;
  const bool second = wg == 1 && Q > 64;   // a second key half
  float yacc[32], g[32];
  wgmma_fence();
  for (int t = 0; t < kn; ++t) {
    const uint64_t da =
        smem_desc(sCw + (t / 4) * BLK + (t % 4) * 32, 16, 1024);
    const uint32_t ob = (t / 4) * CB + (t % 4) * 32;
    wgmma_ss_n64(yacc, da, smem_desc(sStH + ob, 16, 1024), t);
    wgmma_ss_n64(yacc, da, smem_desc(sStL + ob, 16, 1024), 1);
  }
  start_g(g, sCw, sB, kn);
  wgmma_commit();
  const float e0 = lds(sc + 4 * (2 * QP + l0));
  const float e1 = lds(sc + 4 * (2 * QP + l0 + 8));
  wgmma_wait_all();
  reg_fence(yacc);
#pragma unroll
  for (int i = 0; i < 32; ++i) yacc[i] *= i % 4 < 2 ? e0 : e1;
  reg_fence(g);

  const float c0 = lds(sc + 4 * (QP + l0)), c1 = lds(sc + 4 * (QP + l0 + 8));
  uint32_t ph[16], pl[16];
  build_p(ph, pl, g, sc, 0, l0, c0, c1, cq, Q);
  wgmma_fence();
  start_px(yacc, ph, pl, sXp, (min(64, Q) + 15) / 16);
  if (second) start_g(g, sCw, sB + 64 * 128, kn);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(yacc);
  if (second) {
    reg_fence(g);
    build_p(ph, pl, g, sc, 1, l0, c0, c1, cq, Q);
    wgmma_fence();
    start_px(yacc, ph, pl, sXp + 64 * 128, (Q - 64 + 15) / 16);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(yacc);
  }

  // y's rows into this warpgroup's staging tile (128-byte swizzled), and
  // one thread stores the valid rows with TMA
  const int r = l0 - 64 * wg;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t at = sY + ((j ^ (r % 8)) * 16) + 2 * cq;
    sts(at + r * 128, pack_bf16(yacc[4 * j], yacc[4 * j + 1]));
    sts(at + (r + 8) * 128, pack_bf16(yacc[4 * j + 2], yacc[4 * j + 3]));
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
  if (r == 0 && cq == 0)                 // the warpgroup's first thread
    tma_store(ty, sY, p0, h, t0 + 64 * wg, b);
}

// One warpgroup's share of the state (64 rows p, NP columns n from the
// B tile's column block at sB: an m64nNP accumulator) += (x o w)^T B
// over the chunk's steps.  The A fragments of
// (x o w)^T come from x's column block at sXp by ldmatrix.trans (lane
// 8m + r: step 16t + r + 8(m/2), the 16-byte piece of p 16wq + 8(m%2) ..
// + 7, found through the 128-byte swizzle), are scaled by w in f32 and
// split into bf16 hi and lo; B's tile is the MN-major B operand.
template <int NP>
__device__ __forceinline__ void ssd_update(float (&st)[NP / 2], uint32_t sXp,
                                           uint32_t sB, uint32_t w, int wq,
                                           int lane, int kq) {
  // k-steps a batch: all 8 at once, or, for a 128-column state (64
  // accumulator registers), 4, so that the fragments of one batch (8
  // registers a k-step) fit beside it
  constexpr int KB = NP == 128 ? 4 : 8;
  const int m = lane / 8, r = lane % 8, cq = 2 * (lane % 4);
  const int j = 2 * wq + m % 2;
#pragma unroll
  for (int t0 = 0; t0 < 8; t0 += KB) {
    if (t0 >= kq) break;
    uint32_t hi[KB][4], lo[KB][4];
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t0 + t >= kq) break;
      // s = 16(t0 + t) + r + 8(m/2), so s % 8 == r
      ldsm_x4_trans(hi[t], sXp + (16 * (t0 + t) + r + 8 * (m / 2)) * 128 +
                               ((j ^ r) * 16));
    }
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t0 + t >= kq) break;
      const float2 w0 = lds2(w + 4 * (16 * (t0 + t) + cq));
      const float2 w1 = lds2(w + 4 * (16 * (t0 + t) + cq + 8));
#pragma unroll
      for (int q = 0; q < 4; ++q) {     // bf16 to f32 is a shift
        const float2 wv = q < 2 ? w0 : w1;
        const uint32_t x = hi[t][q];
        split2(__uint_as_float(x << 16) * wv.x,
               __uint_as_float(x & 0xffff0000u) * wv.y, hi[t][q], lo[t][q]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (t0 + t >= kq) break;
      const uint64_t db = smem_desc(sB + (t0 + t) * 16 * 128, BLK, 1024);
      wgmma_rs<NP>(st, hi[t], db);
      wgmma_rs<NP>(st, lo[t], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(st);
  }
}

// dt of steps 4 lane .. 4 lane + 3 of the chunk at t0 (0 past Q).
__device__ __forceinline__ void load_dt(float (&dtv)[4], const WArgs& a,
                                        long long dbase, int t0, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = 4 * lane + j;
    dtv[j] = s < a.Q ? ld(a.dt, dbase + (t0 + s) * a.ds, a.dt_bf16) : 0.f;
  }
}

// One warp writes a chunk's scalars from its dt (lane j: steps 4j ..
// 4j+3): dt; the cumulative sum of dt * A, taken in f64 and rounded once
// to f32, in log2 units; exp(cs); w = dt exp(cs[Q-1] - cs).  0 past Q.
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
    sts(sc + 4 * s, __float_as_uint(dtv[j]));
    sts(sc + 4 * (QP + s), __float_as_uint(in ? cs * LOG2E : 0.f));
    sts(sc + 4 * (2 * QP + s), __float_as_uint(in ? expf(cs) : 0.f));
    sts(sc + 4 * (3 * QP + s),
        __float_as_uint(in ? dtv[j] * expf(cl - cs) : 0.f));
  }
}

// Chunk c's x, B and C tiles into stage c % STAGES, completing on its
// mbarrier; one thread asks for them.
template <class C>
__device__ __forceinline__ void load_chunk(int c, uint32_t base,
                                           const CUtensorMap* tx,
                                           const CUtensorMap* tb,
                                           const CUtensorMap* tc, int Q,
                                           int h, int b) {
  const uint32_t full = base + C::OFF_BAR + 8 * (c % C::STAGES);
  const uint32_t sX = base + (c % C::STAGES) * C::STAGE;
  const uint32_t sB = sX + C::X_BYTES, sC = sB + C::BC_BYTES;
  mbar_expect_tx(full, (C::PT + 2 * C::NT) * Q * 128);
  for (int k = 0; k < C::PT; ++k)
    tma_load(sX + k * BLK, tx, full, 64 * k, h, c * Q, b);
  for (int k = 0; k < C::NT; ++k) {
    tma_load(sB + k * BLK, tb, full, 64 * k, 0, c * Q, b);
    tma_load(sC + k * BLK, tc, full, 64 * k, 0, c * Q, b);
  }
}

// The chunks of one (b, h), in order, for one warpgroup: y's rows 64 wg
// .. 64 wg + 63 of each chunk and, where OWN, its share of the state
// (rows 64 pi .. 64 pi + 63, columns n0 .. n0 + NW - 1, an m64nNW
// accumulator in f32 registers).  Each role has its own loop, so the
// state's registers are live only in the owners'.  Both loops pass the
// same two block barriers a chunk.
template <class C, int PP, int NP, bool OWN>
__device__ __forceinline__ void ssd_chunks(
    const WArgs& a, uint32_t base, const CUtensorMap* tx,
    const CUtensorMap* tb, const CUtensorMap* tc, const CUtensorMap* ty,
    int wg, int wq, int lane, int warp, float Ah, long long dbase,
    float (&dtv)[4]) {
  constexpr int NW = C::NW;
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int Q = a.Q, nc = a.S / Q;
  // this thread's rows of a 64-row accumulator are r0 and r0 + 8, its
  // columns 8j + cq, + 1
  const int r0 = 16 * wq + lane / 4, cq = 2 * (lane % 4);
  const int kn = (a.N + 15) / 16;      // k-steps over the state dim
  const int kq = (Q + 15) / 16;        // k-steps over the chunk's steps
  const int pi = C::PT == 2 ? wg : 0, n0 = C::SPLIT_N ? 64 * wg : 0;
  float st[OWN ? NW / 2 : 1];
#pragma unroll
  for (int i = 0; i < (OWN ? NW / 2 : 1); ++i) st[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    // an opaque copy of the base, so that addresses are recomputed each
    // chunk instead of hoisted out of the loop and kept in registers the
    // products need: hoisted, they made the kernel markedly slower
    uint32_t bs = base;
    asm volatile("" : "+r"(bs));
    const int stage = c % C::STAGES;
    if (warp == C::SCAL_WARP && c + 1 < nc)
      load_dt(dtv, a, dbase, (c + 1) * Q, lane);
    mbar_wait(bs + C::OFF_BAR + 8 * stage, (c / C::STAGES) & 1);
    __syncwarp();                      // wgmma wants the warp converged
    const uint32_t sX = bs + stage * C::STAGE;
    const uint32_t sB = sX + C::X_BYTES, sC = sB + C::BC_BYTES;
    const uint32_t sst = bs + C::OFF_ST;
    const uint32_t sc = bs + C::OFF_SCAL + (c % 2) * C::SCAL;

    // y in passes of 64 columns, so that its accumulator stays at 32
    // registers a thread
    if (64 * wg < Q)
#pragma unroll 1
      for (int k = 0; k < C::PT; ++k)
        ssd_rows(
            sX + k * BLK, sB, sC, sst + k * 64 * 128,
            sst + C::ST_BYTES + k * 64 * 128, PP * 128, sc,
            bs + C::OFF_Y + (wg * C::PT + k) * 64 * 128, ty, wg,
            64 * wg + r0, cq, Q, kn, 64 * k, h, c * Q, b);

    // state = state * exp(cs[Q-1]) + (x o w)^T B
    if constexpr (OWN) {
      const float ecl = lds(sc + 4 * (2 * QP + Q - 1));
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) st[i] *= ecl;
      ssd_update<NW>(st, sX + pi * BLK, sB + (n0 / 64) * BLK,
                     sc + 4 * 3 * QP, wq, lane, kq);
    }
    if (warp == C::SCAL_WARP && c + 1 < nc)
      chunk_scalars(bs + C::OFF_SCAL + ((c + 1) % 2) * C::SCAL, dtv, Ah, Q,
                    lane);

    // y's staging tile is free again once its store has read it
    if (64 * wg < Q && wq == 0 && lane == 0) tma_store_wait_read();
    // every reader of this stage and of the state's copies is past: the
    // stage takes chunk c + STAGES, the copies the new state (bf16 hi and
    // lo, the next chunk's operands)
    __syncthreads();
    if (tid == 0 && c + C::STAGES < nc)
      load_chunk<C>(c + C::STAGES, bs, tx, tb, tc, Q, h, b);
    if constexpr (OWN) {
      const int p = 64 * pi + r0;
#pragma unroll
      for (int i = 0; i < NW / 2; i += 2) {
        const int pp = p + (i % 4 < 2 ? 0 : 8);
        const int piece = (i / 4) % 8, cb = (n0 + 8 * (i / 4)) / 64;
        const uint32_t off = cb * PP * 128 + pp * 128 +
                             ((piece ^ (pp % 8)) * 16) + 2 * cq;
        uint32_t hi, lo;
        split2(st[i], st[i + 1], hi, lo);
        sts(sst + off, hi);
        sts(sst + C::ST_BYTES + off, lo);
      }
    }
    fence_proxy_async();
    __syncthreads();
  }

  if (wq == 0 && lane == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  if constexpr (OWN) {
    float* out = a.state + ((long long)b * a.H + h) * a.P * a.N;
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      const int p = 64 * pi + r0 + (i % 4 < 2 ? 0 : 8);
      const int n = n0 + 8 * (i / 4) + cq + i % 2;
      if (p < a.P && n < a.N) out[(long long)p * a.N + n] = st[i];
    }
  }
}

// Shared memory, from a 1024-byte-aligned base: STAGES x {x tile (PT
// column blocks of QP rows x 128 bytes), B tile, C tile}, the state's
// bf16 hi and lo copies (each NT column blocks of PP rows x 128 bytes:
// the K-major B operand of C state^T), two buffers of scalars, the
// mbarriers.  Every tile is 128-byte swizzled (TMA's layout, and the one
// this kernel writes).
template <int PP, int NP>
__global__ void __launch_bounds__(SsdCfg<PP, NP>::THREADS, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc,
                 const __grid_constant__ CUtensorMap ty0,
                 const __grid_constant__ CUtensorMap ty1, const WArgs a) {
  using C = SsdCfg<PP, NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // the warp index broadcast from lane 0, so the compiler knows it (and
  // every branch on it) is warp-uniform: wgmma in a path it thinks
  // divergent is serialized
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(FULL, tid / 32, 0);
  const int h = blockIdx.x, b = blockIdx.y;
  const int Q = a.Q, nc = a.S / Q;
  const float Ah = ld(a.A, h * a.as, a.a_bf16);
  const long long dbase = b * a.db + h * a.dh;

  // zeros: tile rows past the chunk and the first chunk's state
  for (uint32_t o = 16 * tid; o < C::OFF_BAR; o += 16 * C::THREADS)
    *reinterpret_cast<uint4*>(smem_raw + (base - raw) + o) =
        make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s)
      mbar_init(base + C::OFF_BAR + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < C::STAGES && c < nc; ++c)
      load_chunk<C>(c, base, &tx, &tb, &tc, Q, h, b);
  // one warp writes each chunk's scalars, loading the next chunk's dt as
  // the chunk starts, so the loads' latency hides behind the products
  float dtv[4];
  if (warp == C::SCAL_WARP) {
    load_dt(dtv, a, dbase, 0, lane);
    chunk_scalars(base + C::OFF_SCAL, dtv, Ah, Q, lane);
  }
  __syncthreads();

  const int wg = warp / 4, wq = warp % 4;
  // y's map for each warpgroup: boxes of its valid rows (min(64, Q) and
  // Q - 64)
  const CUtensorMap* ty = wg == 0 ? &ty0 : &ty1;
  if (wg < C::OWNERS)
    ssd_chunks<C, PP, NP, true>(a, base, &tx, &tb, &tc, ty, wg, wq, lane,
                                warp, Ah, dbase, dtv);
  else
    ssd_chunks<C, PP, NP, false>(a, base, &tx, &tb, &tc, ty, wg, wq, lane,
                                 warp, Ah, dbase, dtv);
}

template <int PP, int NP>
cudaError_t launch_wgmma(const void* x, const void* B, const void* Cm,
                         const WArgs& a, int Bb, Strides xs, Strides bs,
                         Strides cs, cudaStream_t stream) {
  using C = SsdCfg<PP, NP>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  // x as (P, H, S, B); B and C as (N, 1, S, B); boxes of 64 columns x
  // one chunk
  // y (contiguous) as (P, H, S, B), boxes of one warpgroup's valid rows
  CUtensorMap tx, tb, tc, ty0, ty1;
  const long long hp = (long long)a.H * a.P;
  const Strides ys{a.S * hp, hp, a.P};
  if (!encode(fn, &tx, x, Bb, a.S, a.H, a.P, xs, a.Q) ||
      !encode(fn, &tb, B, Bb, a.S, 1, a.N, bs, a.Q) ||
      !encode(fn, &tc, Cm, Bb, a.S, 1, a.N, cs, a.Q) ||
      !encode(fn, &ty0, a.y, Bb, a.S, a.H, a.P, ys, a.Q < 64 ? a.Q : 64) ||
      !encode(fn, &ty1, a.y, Bb, a.S, a.H, a.P, ys, a.Q > 64 ? a.Q - 64 : 1))
    return cudaErrorInvalidValue;
  auto kernel = ssd_wgmma_kernel<PP, NP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.H, Bb), C::THREADS, C::SMEM, stream>>>(tx, tb, tc, ty0,
                                                          ty1, a);
  return cudaGetLastError();
}

bool tma_ok(const void* p, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0;
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16 (x and y; dt; A; B and C).  Strides are
// in elements; the last axis of x, B and C is contiguous, y and the state
// are contiguous.  chunk divides S; chunk, P and N are at most 128.
// route: 0 = ssd_f32_kernel (any dtypes and strides), 1 = ssd_wgmma_kernel
// (x, B and C bfloat16, 16-byte-aligned bases, strides that are multiples
// of 8 elements; anything else is refused, never sent to route 0).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, int Bb, int S, int H, int P, int N,
    int chunk, long long xsb, long long xss, long long xsh, long long dsb,
    long long dss, long long dsh, long long as, long long bsb,
    long long bss, long long csb, long long css, int x_dtype, int dt_dtype,
    int a_dtype, int bc_dtype, int route, void* stream) {
  if (Bb <= 0 || Bb > 65535 || S <= 0 || H <= 0 || P <= 0 || P > MAXDIM ||
      N <= 0 || N > MAXDIM || chunk <= 0 || chunk > MAXDIM || S % chunk ||
      (x_dtype | dt_dtype | a_dtype | bc_dtype) & ~1 || (route & ~1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    if (!x_dtype || !bc_dtype || P % 8 || !tma_ok(x, xsb, xss, xsh) ||
        !tma_ok(B, bsb, bss, bss) || !tma_ok(C, csb, css, css))
      return (int)cudaErrorInvalidValue;
    const WArgs w{dt, A, static_cast<__nv_bfloat16*>(y),
                  static_cast<float*>(state), S, H, P, N, chunk, dsb, dss,
                  dsh, as, dt_dtype, a_dtype};
    const Strides xs{xsb, xss, xsh}, bs{bsb, bss, bss}, cs{csb, css, css};
    cudaError_t err;
    if (P <= 64 && N <= 64)
      err = launch_wgmma<64, 64>(x, B, C, w, Bb, xs, bs, cs, st);
    else if (P <= 64)
      err = launch_wgmma<64, 128>(x, B, C, w, Bb, xs, bs, cs, st);
    else if (N <= 64)
      err = launch_wgmma<128, 64>(x, B, C, w, Bb, xs, bs, cs, st);
    else
      err = launch_wgmma<128, 128>(x, B, C, w, Bb, xs, bs, cs, st);
    return (int)err;
  }
  const int LD = N | 1;
  const size_t smem = sizeof(float) *
                      ((size_t)chunk * P + (size_t)chunk * LD + (size_t)P * LD +
                       (size_t)R * N + (size_t)R * chunk + 3 * (size_t)chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args args{x,   dt,  A,   B,   C,   y,   static_cast<float*>(state),
                  S,   H,   P,   N,   chunk, xsb, xss, xsh, dsb, dss, dsh,
                  as,  bsb, bss, csb, css, x_dtype, dt_dtype, a_dtype,
                  bc_dtype};
  ssd_f32_kernel<<<dim3(H, Bb), THREADS, smem, st>>>(args);
  return (int)cudaGetLastError();
}
