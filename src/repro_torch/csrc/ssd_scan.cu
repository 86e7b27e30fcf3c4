// Mamba2 SSD chunked scan (arXiv:2405.21060 §6), forward.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, ssd_fwd / _ssd_kernel --
// the Pallas kernel whose grid (batch, head, chunk) walks the chunks of a
// sequence in order and carries the (P, N) f32 state in VMEM scratch from
// one chunk to the next.  Per chunk of Q steps, with xdt = x * dt,
// cs = cumsum(dt * A), L[l, s] = exp(cs[l] - cs[s]) for s <= l (else 0):
//   y      = (C B^T o L) xdt + exp(cs) o (C state^T)
//   state' = state * exp(cs[Q-1]) + (xdt o exp(cs[Q-1] - cs))^T B
// and the final state is written once, after the last chunk.  x, dt, B and
// C are float32 or bfloat16, A float32 or bfloat16 (each read as f32);
// y takes x's type, the state is f32.
//
// Design.  One block of 256 threads owns one (b, h) and loops over the
// chunks itself, in order, as the TPU's sequential chunk axis does; the
// state stays in shared memory for the whole sequence.  Per chunk the
// block stages xdt (Q x P), B (Q x N) and the cumulative sums in shared
// memory as f32, then builds y in stripes of R = 32 rows:
// the stripe's C rows, its (C B^T o L) rows -- only over the keys s below
// the stripe's last row, and exp(seg) only where s <= l, since above the
// diagonal seg is positive and exp would overflow -- and then y's rows.
// The stripes keep shared memory within a block's 227 KB at Q = P = N =
// 128 (231,936 bytes; f32 tiles of B, C, L, state and xdt at full size
// would take 320 KB).  The state update follows the last stripe.  Every
// product is a 4 x 2 register tile per thread (rows per warp, columns
// across the lanes: one operand a broadcast, the other conflict-free
// thanks to an odd row pitch), its multiply-adds spelled __fmaf_rn since
// the library builds with --fmad=false.  The cumulative sums (one warp's
// scan) are taken in f64 and rounded once to f32, as the plain version
// takes them: in f32 their rounding would depend on the order of the scan,
// and at chunk 128, where they reach about -100, it moves y by ~4e-4.
// Inputs are read through their strides, so no transposed copy is made;
// the chunk, P and N are run-time values up to 128.
//
// What bounds it on the H100: at mamba2-780m's prefill (B=4, S=1024, H=48,
// P=64, N=128, chunk 128, x/B/C bf16, dt f32) the function reads and writes
// 59.5 MB (17.8 us at 3.35 TB/s) and does about 8.1 GFLOP over the lower
// triangles (8.2 us on the tensor cores), so bytes bound it.  This kernel is the simple, correct
// first version: f32 on the CUDA cores, one block per (b, h) (192 blocks of
// 166 KB of shared memory at that shape, one per SM), no overlap of loads
// with compute, and C B^T recomputed by every head; it cannot come near
// that bound.  Sharing C B^T over heads, wgmma on bf16 tiles and a
// chunk-parallel two-pass scan are the next steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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

__global__ void __launch_bounds__(THREADS) ssd_fwd_kernel(Args a) {
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

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16 (x and y; dt; A; B and C).  Strides are
// in elements; the last axis of x, B and C is contiguous, y and the state
// are contiguous.  chunk divides S; chunk, P and N are at most 128.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, int Bb, int S, int H, int P, int N,
    int chunk, long long xsb, long long xss, long long xsh, long long dsb,
    long long dss, long long dsh, long long as, long long bsb,
    long long bss, long long csb, long long css, int x_dtype, int dt_dtype,
    int a_dtype, int bc_dtype, void* stream) {
  if (Bb <= 0 || Bb > 65535 || S <= 0 || H <= 0 || P <= 0 || P > MAXDIM ||
      N <= 0 || N > MAXDIM || chunk <= 0 || chunk > MAXDIM || S % chunk ||
      (x_dtype | dt_dtype | a_dtype | bc_dtype) & ~1)
    return (int)cudaErrorInvalidValue;
  const int LD = N | 1;
  const size_t smem = sizeof(float) *
                      ((size_t)chunk * P + (size_t)chunk * LD + (size_t)P * LD +
                       (size_t)R * N + (size_t)R * chunk + 3 * (size_t)chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args args{x,   dt,  A,   B,   C,   y,   static_cast<float*>(state),
                  S,   H,   P,   N,   chunk, xsb, xss, xsh, dsb, dss, dsh,
                  as,  bsb, bss, csb, css, x_dtype, dt_dtype, a_dtype,
                  bc_dtype};
  ssd_fwd_kernel<<<dim3(H, Bb), THREADS, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
