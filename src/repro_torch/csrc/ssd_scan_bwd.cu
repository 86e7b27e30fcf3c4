// Mamba2 SSD chunked scan, backward: the vjp of the forward (ssd_scan.cu)
// at (dy, dstate), giving dx, ddt, dA, dB and dC.
//
// Replaces: src/repro/kernels/ssd_scan/ops.py:28, _bwd -- the reference's
// custom VJP of its ssd op, a jax.vjp through the plain chunked scan
// ssd_chunked (src/repro/models/mamba2.py:107), computed by XLA: no Pallas
// kernel.  Per chunk of Q steps, for each (b, h), with xdt = x dt,
// cs = cumsum(dt A) (f64, rounded once to f32, as the forward takes it),
// L[l, s] = exp(cs[l] - cs[s]) for s <= l (else 0), G = C B^T (the heads
// share B and C), S0 the state entering the chunk, decay[s] = exp(cs[Q-1]
// - cs[s]) and dS the cotangent of the state leaving it:
//   d xdt[s] = sum_l (G o L)[l, s] dy[l] + decay[s] dS B[s]
//   dG       = L o (dy xdt^T)                 (per head; dL o L = dG o G)
//   dC[l]   += sum_s dG[l, s] B[s] + exp(cs[l]) dy[l] S0      (over heads)
//   dB[s]   += sum_l dG[l, s] C[l] + decay[s] xdt[s] dS       (over heads)
//   dS_prev  = exp(cs[Q-1]) dS + sum_l exp(cs[l]) dy[l]^T C[l]
//   dcs[t]   = sum_s (dG o G)[t, s] + exp(cs[t]) dy[t].(S0 C[t])
//            - sum_l (dG o G)[l, t] - decay[t] xdt[t].(dS B[t])
//            + [t = Q-1] <dS, S1>
// where S1 = exp(cs[Q-1]) S0 + sum_s decay[s] xdt[s]^T B[s] is the state
// leaving the chunk (d S1 / d cs[Q-1] = S1: every term of it carries
// exp(cs[Q-1])); then da = the reverse cumulative sum of dcs (f64,
// rounded once), dx = d xdt dt, ddt = sum_p d xdt x + da A (in bf16 each
// term rounded before the sum, as the reference adds its two paths) and
// dA[h] = sum_{b,s} da dt.  (Folding the dcs terms into sum_n dC[t, n]
// C[t, n] - sum_n dB[t, n] B[t, n] would save the G products of the row
// pass, but sums over n of terms much larger than G's entries lost a
// factor ~sqrt(N) in dA's accuracy against a float64 yardstick: the terms
// are kept apart.)
//
// What bounds it on the H100: at mamba2-780m's training shape (B=8,
// S=1024, H=48, P=64, N=128, chunk 128; x, B, C and dy bf16, dt f32) the
// function moves 175 MB (x, dy, dx 50.3 MB each, dstate 12.6 MB; 52 us at
// 3.35 TB/s) and does about 52 GFLOP (per (b, chunk, head) the two
// triangle products of width P and two of width N, and five P x N x Q
// products: the states' replay, dy S0, B dS^T, xdt dS and the cotangent's
// update; G once per (b, chunk)): 52 us on the bf16 tensor cores, 0.78 ms
// on the f32 CUDA cores.
//
// Two routes, chosen by kernels/ssd_scan/ops.py bwd_route; neither falls
// back to the other, and each takes every sum in a fixed order (no
// atomics: two calls agree bit for bit).
//
// bfloat16 x, B, C and dy that TMA can read, P a multiple of 8: the
// wgmma route, five kernels in ssd_scan_bwd_wgmma.cu (one entry point,
// ssd_bwd_wgmma_launch).  What its design does about the limits of the
// float32 route below (its figures: PERF.md):
//  1. Arithmetic.  Every product runs on the tensor cores (wgmma, f32
//     accumulators).  x, B, C and dy enter exactly; the f32 operands are
//     split into bf16 parts as in the forward: three (hi + mid + lo, the
//     f32 value exactly) where the product feeds dx, ddt or dcs (the
//     states' updates, the states and cotangents in the chunk passes,
//     G o L), two where it feeds only dB or dC (exp(cs) dy and decay dt x
//     against the states, the sums of dG).  Two parts everywhere missed
//     dA's tolerance on the card: dcs's reverse cumulative sum and dA's
//     sum carry an error at a chunk's last step (<dS, S1>, to_state) over
//     the chunk's sum of dt.  dt is folded into dG after x dy^T, so x
//     stays an exact operand.
//  2. Scratch.  The heads are summed inside the accumulators: dC's and
//     dB's state terms are products whose K runs over (h, p), and dG is
//     summed over a group of heads in registers before its products
//     with B and C, once per (b, chunk, group).  The states and their
//     cotangents cross kernels as bf16 images (three parts each, in the
//     tiles' swizzled layout, moved by bulk copies): ~322 MB of scratch a
//     call at the shape above (the states' and cotangents' images 151 MB
//     each, the groups' dG sums, dB and dC partials and dcs's rows ~20
//     MB) against this route's ~620 MB (per-head dB and dC partials 402
//     MB among them).
//  3. Redundant work.  G = C B^T once per (b, chunk, head group), kept in
//     registers over the group's heads; B and C tiles loaded once per
//     block; x, dy and the images by TMA or bulk copies in a ring of
//     stages, one per head.
// The kernels, in order: ssd_bwd_wgmma_state_kernel<true> (a block per
// (b, h): the cotangent's reverse walk from dstate, each chunk's dS image)
// and <false> (the states' replay, each chunk's entering state's image
// and <dS, S1>), ssd_bwd_wgmma_chunk_kernel (a block per (b, chunk, head
// group): dx, dcs's G terms and to_state, the group's sum of dG),
// ssd_bwd_wgmma_dbdc_kernel (a block per (b, chunk, dB or dC, head
// group): the state terms over the heads, the G terms, and for dC's
// blocks each head's dcs, da, ddt and share of dA) and
// ssd_bwd_wgmma_reduce_kernel (dB and dC over the head groups, dA over
// (b, chunk)).  What still bounds it is latency: each warpgroup walks a
// serial chain of products and waits per head or chunk (PERF.md).
//
// Everything else (float32 inputs, and layouts TMA cannot read): this
// file's six SIMT kernels, the first design, below.  Every product is f32
// on the CUDA cores, paced by shared-memory loads (5.37 TFLOP/s at the
// shape above), and per-head dB and dC partials and the states go
// through ~620 MB of float32 scratch.
//
// Design: six kernels on one stream from one entry point, each sum in a
// fixed order and no atomics, so two calls on the same inputs agree bit for
// bit.  Every product is f32 on the CUDA cores (__fmaf_rn: the library
// builds with --fmad=false); tiles are R = 32 rows, a thread 4 rows of a
// warp's and one or four columns 32 apart, as in the forward's f32 route.
//  1. ssd_bwd_scan_kernel<false>, a block per (b, h), walks the chunks in
//     order (the forward's recurrence, without y): writes cs for every
//     step and the state entering each chunk, and the final one, (B, H,
//     nc + 1, P, N) f32 scratch.  The forward's TPU kernel kept the state
//     in VMEM across its sequential grid; here the sequential walk is a
//     loop in the block and the states go to device memory, because the
//     chunks' gradients below run in parallel.
//  2. ssd_bwd_scan_kernel<true>, a block per (b, h), walks them in reverse
//     from dstate: writes dS for every chunk, (B, H, nc, P, N), and
//     <dS, S1> for the dcs term at Q-1.
//  3. ssd_bwd_rows_kernel, a block per (b, h, chunk, stripe of 32 rows l):
//     over the key stripes s <= l, the block of G and of dy xdt^T, then
//     dG B; then dy S0.  Writes this head's dC rows (f32 partials) and the
//     row terms of dcs.
//  4. ssd_bwd_cols_kernel, a block per (b, h, chunk, stripe of 32 keys s):
//     over the row stripes l >= s, the same blocks transposed, then
//     (G o L)^T dy and dG^T C; then dS's two terms.  Writes dx, this
//     head's dB rows (f32 partials), sum_p d xdt x and the column terms of
//     dcs.
//  5. ssd_bwd_dt_kernel, a block per (b, h, chunk): dcs, its reverse
//     cumulative sum, ddt, and the chunk's share of dA.
//  6. ssd_bwd_reduce_kernel: dB and dC summed over the heads in order,
//     dA over (b, chunk) in order.
// Inputs are read through their strides (the last axis of x, B, C and dy
// contiguous); the outputs are contiguous.  P, N and the chunk are
// run-time values up to 128.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TR = 4;                // rows of a thread's tile (per warp)
constexpr int R = WARPS * TR;        // rows (or keys) of a stripe
constexpr int LDG = R + 1;           // pitch of a stripe's R x R block
constexpr int MAXDIM = 128;          // Q, P and N
constexpr int MAXJ = MAXDIM / 32;    // a thread's columns, 32 apart
constexpr unsigned FULL = 0xffffffffu;

struct BArgs {
  const void *x, *dt, *A, *B, *C, *dy;
  const float* dstate;
  void *dx, *ddt, *dA, *dB, *dC;
  // scratch: states (B, H, nc + 1, P, N); dstates (B, H, nc, P, N); rows
  // (4, B, H, S): cs, the row and column terms of dcs, sum_p d xdt x;
  // chunks (2, B, H, nc): <dS, S1>, the chunk's share of dA; dBp and dCp
  // (B, H, S, N): each head's dB and dC
  float *states, *dstates, *rows, *chunks, *dBp, *dCp;
  int Bb, S, H, P, N, Q, nc;
  long long xb, xs, xh, db, ds, dh, as, bb, bs, cb, cs, yb, ys, yh;
  int x_bf16, dt_bf16, a_bf16, bc_bf16, dy_bf16;
};

__device__ __forceinline__ float ld(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, long long i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// row k of the (4, B, H, S) scratch for (b, h), at step 0
__device__ __forceinline__ float* row_of(const BArgs& a, int k, int b, int h) {
  return a.rows + ((static_cast<long long>(k) * a.Bb + b) * a.H + h) * a.S;
}

// entry k of the (2, B, H, nc) scratch for (b, h, c)
__device__ __forceinline__ long long chunk_at(const BArgs& a, int k, int b,
                                              int h, int c) {
  return ((static_cast<long long>(k) * a.Bb + b) * a.H + h) * a.nc + c;
}

// warp 0: inclusive cumulative sum of sCs[0 .. Q) in f64, rounded once to
// f32 (the forward's own scan, so both take the same cs)
__device__ void warp_cumsum(float* sCs, int Q, int lane) {
  const int k = (Q + 31) / 32, i0 = lane * k;
  double run = 0.0, part[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    if (j < k && i0 + j < Q) run += (double)sCs[i0 + j];
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
  for (int j = 0; j < MAXJ; ++j)
    if (j < k && i0 + j < Q) sCs[i0 + j] = (float)(before + part[j]);
}

// 1 and 2: the state's recurrence in order (REV false) or its cotangent's
// in reverse (REV true), a block per (b, h):
//   S = exp(cs[Q-1]) S + U^T V,
// U = x dt decay and V = B going forward, U = dy exp(cs) and V = C going
// back; each chunk stores S before its update.
template <bool REV>
__global__ void __launch_bounds__(THREADS) ssd_bwd_scan_kernel(BArgs a) {
  extern __shared__ float smem[];
  const int Q = a.Q, P = a.P, N = a.N, nc = a.nc;
  const int PN = P * N;
  float* sS = smem;                  // P x N    the state or its cotangent
  float* sU = sS + PN;               // Q x P    U
  float* sV = sU + Q * P;            // Q x N    V
  float* sCs = sV + Q * N;           // Q        cumsum(dt A)
  float* sW = sCs + Q;               // Q        U's row weights
  float* sRed = sW + Q;              // WARPS    a block sum's partials

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const float A = ld(a.A, h * a.as, a.a_bf16);
  float* cs_row = row_of(a, 0, b, h);

  for (int e = tid; e < PN; e += THREADS)
    sS[e] = REV ? a.dstate[bh * PN + e] : 0.f;

  for (int k = 0; k < nc; ++k) {
    const int c = REV ? nc - 1 - k : k;
    const long long t0 = static_cast<long long>(c) * Q;
    __syncthreads();                 // the last chunk's readers are done
    if (!REV) {
      for (int s = tid; s < Q; s += THREADS) {
        const float d = ld(a.dt, b * a.db + (t0 + s) * a.ds + h * a.dh,
                           a.dt_bf16);
        sW[s] = d;
        sCs[s] = d * A;
      }
      __syncthreads();
      if (warp == 0) warp_cumsum(sCs, Q, lane);
      __syncthreads();
      for (int s = tid; s < Q; s += THREADS) {
        cs_row[t0 + s] = sCs[s];
        sW[s] = sW[s] * expf(sCs[Q - 1] - sCs[s]);
      }
    } else {
      for (int s = tid; s < Q; s += THREADS) {
        const float v = cs_row[t0 + s];
        sCs[s] = v;
        sW[s] = expf(v);
      }
    }
    float* out = REV ? a.dstates + (bh * nc + c) * PN
                     : a.states + (bh * (nc + 1) + c) * PN;
    for (int e = tid; e < PN; e += THREADS) out[e] = sS[e];
    if (REV) {                       // <dS, S1>, S1 the state leaving c
      const float* s1 = a.states + (bh * (nc + 1) + c + 1) * PN;
      float v = 0.f;
      for (int e = tid; e < PN; e += THREADS) v = __fmaf_rn(sS[e], s1[e], v);
      v = warp_sum(v);
      if (lane == 0) sRed[warp] = v;
      __syncthreads();
      if (tid == 0) {
        float t = 0.f;
        for (int w = 0; w < WARPS; ++w) t += sRed[w];
        a.chunks[chunk_at(a, 0, b, h, c)] = t;
      }
    }
    __syncthreads();                 // sW written; S stored before it moves
    for (int e = tid; e < Q * P; e += THREADS) {
      const int s = e / P, p = e - s * P;
      const long long t = t0 + s;
      sU[e] = (REV ? ld(a.dy, b * a.yb + t * a.ys + h * a.yh + p, a.dy_bf16)
                   : ld(a.x, b * a.xb + t * a.xs + h * a.xh + p, a.x_bf16)) *
              sW[s];
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int s = e / N, n = e - s * N;
      const long long t = t0 + s;
      sV[e] = REV ? ld(a.C, b * a.cb + t * a.cs + n, a.bc_bf16)
                  : ld(a.B, b * a.bb + t * a.bs + n, a.bc_bf16);
    }
    __syncthreads();
    const float e_last = expf(sCs[Q - 1]);
    for (int p0 = 0; p0 < P; p0 += R) {
      for (int n0 = 0; n0 < N; n0 += 64) {
        int pr[TR], nj[2];
#pragma unroll
        for (int r = 0; r < TR; ++r) pr[r] = min(p0 + warp * TR + r, P - 1);
#pragma unroll
        for (int j = 0; j < 2; ++j) nj[j] = min(n0 + lane + 32 * j, N - 1);
        float u[TR][2] = {};
        for (int s = 0; s < Q; ++s) {
          float uv[TR], vv[2];
#pragma unroll
          for (int r = 0; r < TR; ++r) uv[r] = sU[s * P + pr[r]];
#pragma unroll
          for (int j = 0; j < 2; ++j) vv[j] = sV[s * N + nj[j]];
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              u[r][j] = __fmaf_rn(uv[r], vv[j], u[r][j]);
        }
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const int p = p0 + warp * TR + r;
          if (p >= P) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = n0 + lane + 32 * j;
            if (n < N) sS[p * N + n] = __fmaf_rn(sS[p * N + n], e_last, u[r][j]);
          }
        }
      }
    }
  }
  if (!REV) {                        // the final state, S1 of the last chunk
    __syncthreads();
    float* out = a.states + (bh * (nc + 1) + nc) * PN;
    for (int e = tid; e < PN; e += THREADS) out[e] = sS[e];
  }
}

// 3: a block per (b, h, chunk, stripe of R rows l): dC's rows and dcs's
// row terms
__global__ void __launch_bounds__(THREADS) ssd_bwd_rows_kernel(BArgs a) {
  extern __shared__ float smem[];
  const int Q = a.Q, P = a.P, N = a.N;
  const int LDN = N | 1, LDP = P | 1;  // odd pitches: conflict-free columns
  const int ns = (Q + R - 1) / R;
  const int c = blockIdx.x / ns, l0 = (blockIdx.x - c * ns) * R;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(R, Q - l0);
  const long long t0 = static_cast<long long>(c) * Q;
  float* sC = smem;                  // R x N    C rows of the stripe
  float* sY = sC + R * N;            // R x P    dy rows of the stripe
  float* sB = sY + R * P;            // R x LDN  B rows of a key stripe
  float* sX = sB + R * LDN;          // R x LDP  x dt rows of a key stripe
  float* sG = sX + R * LDP;          // R x LDG  dG of the block
  float* sCs = sG + R * LDG;         // Q        cumsum(dt A)
  float* sDt = sCs + Q;              // Q        dt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const float* cs_row = row_of(a, 0, b, h) + t0;
  for (int s = tid; s < Q; s += THREADS) {
    sCs[s] = cs_row[s];
    sDt[s] = ld(a.dt, b * a.db + (t0 + s) * a.ds + h * a.dh, a.dt_bf16);
  }
  for (int e = tid; e < R * N; e += THREADS) {
    const int i = e / N, n = e - i * N;
    sC[e] = i < rows ? ld(a.C, b * a.cb + (t0 + l0 + i) * a.cs + n, a.bc_bf16)
                     : 0.f;
  }
  for (int e = tid; e < R * P; e += THREADS) {
    const int i = e / P, p = e - i * P;
    sY[e] = i < rows ? ld(a.dy, b * a.yb + (t0 + l0 + i) * a.ys + h * a.yh + p,
                          a.dy_bf16)
                     : 0.f;
  }
  const int NJ = (N + 31) / 32;
  int nj[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) nj[j] = min(lane + 32 * j, N - 1);
  float acc[TR][MAXJ] = {}, dll[TR] = {};
  const int s_end = l0 + rows;
  for (int s0 = 0; s0 < s_end; s0 += R) {
    const int keys = min(R, s_end - s0);
    __syncthreads();                 // the last key stripe's readers are done
    for (int e = tid; e < R * N; e += THREADS) {
      const int j = e / N, n = e - j * N;
      sB[j * LDN + n] =
          j < keys ? ld(a.B, b * a.bb + (t0 + s0 + j) * a.bs + n, a.bc_bf16)
                   : 0.f;
    }
    for (int e = tid; e < R * P; e += THREADS) {
      const int j = e / P, p = e - j * P;
      sX[j * LDP + p] =
          j < keys ? ld(a.x, b * a.xb + (t0 + s0 + j) * a.xs + h * a.xh + p,
                        a.x_bf16) * sDt[s0 + j]
                   : 0.f;
    }
    __syncthreads();
    // the block: row i = warp * TR + r, key j = lane
    float g[TR] = {}, m[TR] = {};
    for (int n = 0; n < N; ++n) {
      const float bv = sB[lane * LDN + n];
#pragma unroll
      for (int r = 0; r < TR; ++r)
        g[r] = __fmaf_rn(sC[(warp * TR + r) * N + n], bv, g[r]);
    }
    for (int p = 0; p < P; ++p) {
      const float xv = sX[lane * LDP + p];
#pragma unroll
      for (int r = 0; r < TR; ++r)
        m[r] = __fmaf_rn(sY[(warp * TR + r) * P + p], xv, m[r]);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int i = warp * TR + r, l = l0 + i, s = s0 + lane;
      float dg = 0.f;
      if (i < rows && lane < keys && s <= l) {
        dg = m[r] * expf(sCs[l] - sCs[s]);
        dll[r] = __fmaf_rn(dg, g[r], dll[r]);
      }
      sG[i * LDG + lane] = dg;
    }
    __syncthreads();
    // dC's rows += dG B over the stripe's keys
    for (int j = 0; j < keys; ++j) {
      float gv[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) gv[r] = sG[(warp * TR + r) * LDG + j];
#pragma unroll
      for (int q = 0; q < MAXJ; ++q) {
        if (q >= NJ) break;
        const float bv = sB[j * LDN + nj[q]];
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[r][q] = __fmaf_rn(gv[r], bv, acc[r][q]);
      }
    }
  }
  // the entering state's term: dy S0, S0 read from the states' scratch
  const float* S0 = a.states + (bh * (a.nc + 1) + c) * (P * N);
  float stv[TR][MAXJ] = {};
  for (int p = 0; p < P; ++p) {
    float yv[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) yv[r] = sY[(warp * TR + r) * P + p];
#pragma unroll
    for (int q = 0; q < MAXJ; ++q) {
      if (q >= NJ) break;
      const float sv = S0[p * N + nj[q]];
#pragma unroll
      for (int r = 0; r < TR; ++r) stv[r][q] = __fmaf_rn(yv[r], sv, stv[r][q]);
    }
  }
  float* dcs_row = row_of(a, 1, b, h) + t0;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int i = warp * TR + r;
    const bool valid = i < rows;
    const float e = valid ? expf(sCs[l0 + i]) : 0.f;
    float srow = 0.f;
#pragma unroll
    for (int q = 0; q < MAXJ; ++q) {
      const int n = lane + 32 * q;
      if (q < NJ && n < N) {
        if (valid)
          a.dCp[(bh * a.S + t0 + l0 + i) * N + n] =
              __fmaf_rn(e, stv[r][q], acc[r][q]);
        srow = __fmaf_rn(stv[r][q], sC[i * N + n], srow);
      }
    }
    const float d = warp_sum(dll[r]);
    srow = warp_sum(srow);
    if (lane == 0 && valid) dcs_row[l0 + i] = d + e * srow;
  }
}

// 4: a block per (b, h, chunk, stripe of R keys s): dx, dB's rows, sum_p
// d xdt x and dcs's column terms
__global__ void __launch_bounds__(THREADS) ssd_bwd_cols_kernel(BArgs a) {
  extern __shared__ float smem[];
  const int Q = a.Q, P = a.P, N = a.N;
  const int LDN = N | 1, LDP = P | 1;
  const int ns = (Q + R - 1) / R;
  const int c = blockIdx.x / ns, s0 = (blockIdx.x - c * ns) * R;
  const int h = blockIdx.y, b = blockIdx.z;
  const int keys = min(R, Q - s0);
  const long long t0 = static_cast<long long>(c) * Q;
  const int tiles = R * LDN + R * LDP + 2 * R * LDG;
  float* sB = smem;                  // R x N    B rows of the key stripe
  float* sX = sB + R * N;            // R x P    x dt rows of the key stripe
  float* sC = sX + R * P;            // R x LDN  C rows of a row stripe
  float* sY = sC + R * LDN;          // R x LDP  dy rows of a row stripe
  float* sG = sY + R * LDP;          // R x LDG  dG^T of the block (key, row)
  float* sL = sG + R * LDG;          // R x LDG  (G o L)^T of the block
  float* sD = sC;                    // P x LDN  dS, after the row stripes
  float* sCs = sC + max(tiles, P * LDN);   // Q  cumsum(dt A)
  float* sDt = sCs + Q;              // Q        dt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const float* cs_row = row_of(a, 0, b, h) + t0;
  for (int s = tid; s < Q; s += THREADS) {
    sCs[s] = cs_row[s];
    sDt[s] = ld(a.dt, b * a.db + (t0 + s) * a.ds + h * a.dh, a.dt_bf16);
  }
  __syncthreads();                   // sDt is read below
  for (int e = tid; e < R * N; e += THREADS) {
    const int j = e / N, n = e - j * N;
    sB[e] = j < keys ? ld(a.B, b * a.bb + (t0 + s0 + j) * a.bs + n, a.bc_bf16)
                     : 0.f;
  }
  for (int e = tid; e < R * P; e += THREADS) {
    const int j = e / P, p = e - j * P;
    sX[e] = j < keys ? ld(a.x, b * a.xb + (t0 + s0 + j) * a.xs + h * a.xh + p,
                          a.x_bf16) * sDt[s0 + j]
                     : 0.f;
  }
  const int NJ = (N + 31) / 32, PJ = (P + 31) / 32;
  int nj[MAXJ], pj[MAXJ];
#pragma unroll
  for (int q = 0; q < MAXJ; ++q) {
    nj[q] = min(lane + 32 * q, N - 1);
    pj[q] = min(lane + 32 * q, P - 1);
  }
  float dxa[TR][MAXJ] = {}, dba[TR][MAXJ] = {}, dll[TR] = {};
  for (int l0 = s0; l0 < Q; l0 += R) {
    const int rows = min(R, Q - l0);
    __syncthreads();                 // the last row stripe's readers are done
    for (int e = tid; e < R * N; e += THREADS) {
      const int i = e / N, n = e - i * N;
      sC[i * LDN + n] =
          i < rows ? ld(a.C, b * a.cb + (t0 + l0 + i) * a.cs + n, a.bc_bf16)
                   : 0.f;
    }
    for (int e = tid; e < R * P; e += THREADS) {
      const int i = e / P, p = e - i * P;
      sY[i * LDP + p] =
          i < rows ? ld(a.dy, b * a.yb + (t0 + l0 + i) * a.ys + h * a.yh + p,
                        a.dy_bf16)
                   : 0.f;
    }
    __syncthreads();
    // the block: key j = warp * TR + r, row i = lane
    float g[TR] = {}, m[TR] = {};
    for (int n = 0; n < N; ++n) {
      const float cv = sC[lane * LDN + n];
#pragma unroll
      for (int r = 0; r < TR; ++r)
        g[r] = __fmaf_rn(sB[(warp * TR + r) * N + n], cv, g[r]);
    }
    for (int p = 0; p < P; ++p) {
      const float yv = sY[lane * LDP + p];
#pragma unroll
      for (int r = 0; r < TR; ++r)
        m[r] = __fmaf_rn(sX[(warp * TR + r) * P + p], yv, m[r]);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int j = warp * TR + r, s = s0 + j, l = l0 + lane;
      float dg = 0.f, gl = 0.f;
      if (j < keys && lane < rows && l >= s) {
        const float L = expf(sCs[l] - sCs[s]);
        dg = m[r] * L;
        gl = g[r] * L;
        dll[r] = __fmaf_rn(dg, g[r], dll[r]);
      }
      sG[j * LDG + lane] = dg;
      sL[j * LDG + lane] = gl;
    }
    __syncthreads();
    // d xdt += (G o L)^T dy and dB += dG^T C over the stripe's rows
    for (int i = 0; i < rows; ++i) {
      float gv[TR], lv[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        gv[r] = sG[(warp * TR + r) * LDG + i];
        lv[r] = sL[(warp * TR + r) * LDG + i];
      }
#pragma unroll
      for (int q = 0; q < MAXJ; ++q) {
        if (q >= PJ) break;
        const float yv = sY[i * LDP + pj[q]];
#pragma unroll
        for (int r = 0; r < TR; ++r) dxa[r][q] = __fmaf_rn(lv[r], yv, dxa[r][q]);
      }
#pragma unroll
      for (int q = 0; q < MAXJ; ++q) {
        if (q >= NJ) break;
        const float cv = sC[i * LDN + nj[q]];
#pragma unroll
        for (int r = 0; r < TR; ++r) dba[r][q] = __fmaf_rn(gv[r], cv, dba[r][q]);
      }
    }
  }
  __syncthreads();                   // the row tiles are free: dS takes them
  const float* dS = a.dstates + (bh * a.nc + c) * (P * N);
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    sD[p * LDN + n] = dS[e];
  }
  __syncthreads();
  // the leaving state's terms: B dS^T (columns p) and xdt dS (columns n)
  float sx[TR][MAXJ] = {}, sb[TR][MAXJ] = {};
  for (int n = 0; n < N; ++n) {
    float bv[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) bv[r] = sB[(warp * TR + r) * N + n];
#pragma unroll
    for (int q = 0; q < MAXJ; ++q) {
      if (q >= PJ) break;
      const float dv = sD[pj[q] * LDN + n];
#pragma unroll
      for (int r = 0; r < TR; ++r) sx[r][q] = __fmaf_rn(bv[r], dv, sx[r][q]);
    }
  }
  for (int p = 0; p < P; ++p) {
    float xv[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) xv[r] = sX[(warp * TR + r) * P + p];
#pragma unroll
    for (int q = 0; q < MAXJ; ++q) {
      if (q >= NJ) break;
      const float dv = sD[p * LDN + nj[q]];
#pragma unroll
      for (int r = 0; r < TR; ++r) sb[r][q] = __fmaf_rn(xv[r], dv, sb[r][q]);
    }
  }
  float* dcs_col = row_of(a, 2, b, h) + t0;
  float* ddt_x = row_of(a, 3, b, h) + t0;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int j = warp * TR + r, s = s0 + j;
    const bool valid = j < keys;
    const long long t = t0 + s;
    const float decay = valid ? expf(sCs[Q - 1] - sCs[s]) : 0.f;
    const float dtv = valid ? sDt[s] : 0.f;
    float xsum = 0.f, bsum = 0.f;
#pragma unroll
    for (int q = 0; q < MAXJ; ++q) {
      const int p = lane + 32 * q;
      if (q < PJ && p < P && valid) {
        const float v = __fmaf_rn(decay, sx[r][q], dxa[r][q]);   // d xdt
        st(a.dx, ((b * static_cast<long long>(a.S) + t) * a.H + h) * P + p,
           v * dtv, a.x_bf16);
        xsum = __fmaf_rn(v, ld(a.x, b * a.xb + t * a.xs + h * a.xh + p,
                               a.x_bf16), xsum);
      }
    }
#pragma unroll
    for (int q = 0; q < MAXJ; ++q) {
      const int n = lane + 32 * q;
      if (q < NJ && n < N && valid) {
        a.dBp[(bh * a.S + t) * N + n] = __fmaf_rn(decay, sb[r][q], dba[r][q]);
        bsum = __fmaf_rn(sb[r][q], sB[j * N + n], bsum);
      }
    }
    const float d = warp_sum(dll[r]);
    xsum = warp_sum(xsum);
    bsum = warp_sum(bsum);
    if (lane == 0 && valid) {
      dcs_col[s] = d + decay * bsum;
      ddt_x[s] = xsum;
    }
  }
}

// 5: a block per (b, h, chunk), a thread a step: dcs, da (its reverse
// cumulative sum, f64 rounded once), ddt and the chunk's share of dA
__global__ void __launch_bounds__(MAXDIM) ssd_bwd_dt_kernel(BArgs a) {
  __shared__ float sD[MAXDIM];
  __shared__ float sDa[MAXDIM];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, Q = a.Q;
  const long long t0 = static_cast<long long>(c) * Q;
  if (t < Q) sD[t] = row_of(a, 1, b, h)[t0 + t] - row_of(a, 2, b, h)[t0 + t];
  __syncthreads();
  if (t == 0) {
    sD[Q - 1] += a.chunks[chunk_at(a, 0, b, h, c)];
    double run = 0.0;
    for (int s = Q - 1; s >= 0; --s) {
      run += (double)sD[s];
      sDa[s] = (float)run;
    }
  }
  __syncthreads();
  if (t < Q) {
    const long long tt = t0 + t;
    const float dtv = ld(a.dt, b * a.db + tt * a.ds + h * a.dh, a.dt_bf16);
    const float A = ld(a.A, h * a.as, a.a_bf16);
    // dt enters twice (x dt and dt A): in bf16 each path's cotangent is
    // rounded before the two are added, as the reference's vjp adds them
    const float px = row_of(a, 3, b, h)[tt], pa = sDa[t] * A;
    st(a.ddt, (b * static_cast<long long>(a.S) + tt) * a.H + h,
       a.dt_bf16 ? bf16r(px) + bf16r(pa) : px + pa, a.dt_bf16);
    sD[t] = sDa[t] * dtv;
  }
  __syncthreads();
  if (t == 0) {
    double acc = 0.0;
    for (int s = 0; s < Q; ++s) acc += (double)sD[s];
    a.chunks[chunk_at(a, 1, b, h, c)] = (float)acc;
  }
}

// 6: dB and dC summed over the heads (h in order), dA over (b, chunk)
__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce_kernel(BArgs a) {
  const long long SN = static_cast<long long>(a.S) * a.N;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i < a.Bb * SN) {
    const long long b = i / SN, r = i - b * SN;
    const float* pb = a.dBp + b * a.H * SN + r;
    const float* pc = a.dCp + b * a.H * SN + r;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < a.H; ++h) {
      sb += pb[h * SN];
      sc += pc[h * SN];
    }
    st(a.dB, i, sb, a.bc_bf16);
    st(a.dC, i, sc, a.bc_bf16);
  }
  if (i < a.H) {
    double acc = 0.0;
    for (int b = 0; b < a.Bb; ++b)
      for (int c = 0; c < a.nc; ++c)
        acc += (double)a.chunks[chunk_at(a, 1, b, static_cast<int>(i), c)];
    st(a.dA, i, (float)acc, a.a_bf16);
  }
}

template <class K>
cudaError_t smem_limit(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// bytes of dynamic shared memory of the scan (0), rows (1) and columns (2)
// kernels: at most 197,664 (P = N = chunk = 128), 71,040 and 99,840
size_t smem_bytes(int P, int N, int chunk, int which) {
  const int LDN = N | 1, LDP = P | 1;
  const int tiles = R * LDN + R * LDP + 2 * R * LDG;
  const int floats[3] = {
      P * N + chunk * P + chunk * N + 2 * chunk + WARPS,
      R * N + R * P + R * LDN + R * LDP + R * LDG + 2 * chunk,
      R * N + R * P + (tiles > P * LDN ? tiles : P * LDN) + 2 * chunk};
  return sizeof(float) * static_cast<size_t>(floats[which]);
}

}  // namespace

extern "C" int ssd_bwd_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, const void* dstate, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* states, void* dstates, void* rows,
    void* chunks, void* dBp, void* dCp, int Bb, int S, int H, int P, int N,
    int chunk, long long xsb, long long xss, long long xsh, long long dsb,
    long long dss, long long dsh, long long as, long long bsb, long long bss,
    long long csb, long long css, long long ysb, long long yss,
    long long ysh, int x_dtype, int dt_dtype, int a_dtype, int bc_dtype,
    int dy_dtype, void* stream) {
  if (Bb <= 0 || Bb > 65535 || S <= 0 || H <= 0 || H > 65535 || P <= 0 ||
      P > MAXDIM || N <= 0 || N > MAXDIM || chunk <= 0 || chunk > MAXDIM ||
      S % chunk || (x_dtype | dt_dtype | a_dtype | bc_dtype | dy_dtype) & ~1)
    return (int)cudaErrorInvalidValue;
  const int nc = S / chunk, ns = (chunk + R - 1) / R;
  const BArgs args{x, dt, A, B, C, dy, static_cast<const float*>(dstate),
                   dx, ddt, dA, dB, dC,
                   static_cast<float*>(states), static_cast<float*>(dstates),
                   static_cast<float*>(rows), static_cast<float*>(chunks),
                   static_cast<float*>(dBp), static_cast<float*>(dCp),
                   Bb, S, H, P, N, chunk, nc,
                   xsb, xss, xsh, dsb, dss, dsh, as, bsb, bss, csb, css,
                   ysb, yss, ysh,
                   x_dtype, dt_dtype, a_dtype, bc_dtype, dy_dtype};
  cudaStream_t strm = (cudaStream_t)stream;
  const size_t scan = smem_bytes(P, N, chunk, 0);
  const size_t rows_b = smem_bytes(P, N, chunk, 1);
  const size_t cols_b = smem_bytes(P, N, chunk, 2);
  cudaError_t err;
  if ((err = smem_limit(ssd_bwd_scan_kernel<false>, scan)) != cudaSuccess ||
      (err = smem_limit(ssd_bwd_scan_kernel<true>, scan)) != cudaSuccess ||
      (err = smem_limit(ssd_bwd_rows_kernel, rows_b)) != cudaSuccess ||
      (err = smem_limit(ssd_bwd_cols_kernel, cols_b)) != cudaSuccess)
    return (int)err;
  ssd_bwd_scan_kernel<false><<<dim3(H, Bb), THREADS, scan, strm>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_scan_kernel<true><<<dim3(H, Bb), THREADS, scan, strm>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_rows_kernel<<<dim3(nc * ns, H, Bb), THREADS, rows_b, strm>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_cols_kernel<<<dim3(nc * ns, H, Bb), THREADS, cols_b, strm>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dt_kernel<<<dim3(nc, H, Bb), MAXDIM, 0, strm>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long total = static_cast<long long>(Bb) * S * N;
  const long long work = total > H ? total : H;
  ssd_bwd_reduce_kernel<<<(unsigned)((work + THREADS - 1) / THREADS),
                          THREADS, 0, strm>>>(args);
  return (int)cudaGetLastError();
}
