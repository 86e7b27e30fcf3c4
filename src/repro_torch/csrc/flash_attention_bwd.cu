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
// products too; these kernels keep all of them in f32.
//
// Three kernels, launched in this order on one stream:
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
// A first, simple design: f32 on the CUDA cores (SIMT), with every tile
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
// cores' 989 TFLOP/s, against 0.038 ms for its 126 MB at 3.35 TB/s:
// operations bound it.  This SIMT version runs on the CUDA cores (67
// TFLOP/s f32 at best), and its inner products are bounded by its
// shared-memory reads, so it stays well above that bound; wgmma tiles fed
// by TMA would be its redesign.
//
// The library is built with --fmad=false: every multiply-add that should
// fuse is spelled __fmaf_rn.  Parity with the plain version is held by
// tolerance, not bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

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

__device__ __forceinline__ bool live(int qpos, int kpos, int S, int causal,
                                     int window) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos) &&
         (!window || kpos > qpos - window);
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
                  window, (float)(1.0 / sqrt((double)Dh))};
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
                  window, (float)(1.0 / sqrt((double)Dh))};
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
