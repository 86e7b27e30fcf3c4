// FlashAttention-2 forward: softmax attention with an online softmax,
// causal and sliding-window masks, and GQA.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention_fwd
// / _fa_kernel -- the Pallas kernel whose grid (batch, q head, q block,
// k block) carries (acc, m, l) in VMEM scratch across the sequential k
// axis, skips k blocks outside the causal/window band with pl.when, and
// maps q head h to kv head h / (H / KV).
//
// It computes what _fa_kernel computes: q, k and v upcast to f32; logits
// q.k^T * 1/sqrt(Dh), set to the finite NEG_INF = -0.7 * FLT_MAX where
// masked (causal kpos <= qpos, window kpos > qpos - window); m, l and acc
// in f32, corr = exp(m_prev - m_new); out = acc / max(l, 1e-37), cast to
// q's type.  The finite NEG_INF matters: a row whose keys in a visited tile
// are all masked gets m = NEG_INF and p = exp(0) = 1, and the next live
// tile wipes that out through corr = exp(NEG_INF - m) = 0; with -inf that
// step would be NaN.  Every row has at least its diagonal key.
//
// Design.  One block of 128 threads owns one (b, h, q tile of BQ rows); the
// k loop runs inside the block, over the k tiles of BK keys that hold a
// key inside the causal/window band of the q tile (the pl.when skip), in
// ascending order.  Q, K and V tiles are staged in shared memory as f32,
// read through the strides of the (B,S,H,Dh) layout (no transposed copy);
// rows past S and columns past Dh are zero, and keys past S are masked, so
// the ragged last tile of any S needs no padding.  Thread (ty, tx) of the
// 8 x 16 grid owns q rows ty + 8r: their scores at keys tx + 16c, their m
// and l, and their output columns tx + 16c; the 16 threads of a row are
// one half-warp, so the row max and sum are shuffles.  Blocks of the last
// q tiles, which visit the most k tiles under the causal mask, start first.
// Head dims up to 64, 128 and 256 (any multiple of 8) take three instances
// with (BQ, BK) = (64, 64), (64, 32), (32, 32), so shared memory stays at
// 65-113 KB and acc at <= 64 registers a thread.
//
// What bounds it on the H100: at granite-3-2b's prefill (B=4, S=1024,
// H=32, KV=8, Dh=64, bf16, causal) the function reads and writes 42 MB
// (12.5 us at 3.35 TB/s) and does 2*B*H*S^2*Dh = 17.2 GFLOP (17.4 us at the
// tensor cores' 989 TFLOP/s bf16 rate), so operations bound it.  This
// kernel is the simple, correct first version: f32 arithmetic on the CUDA
// cores (67 TFLOP/s peak, and about one shared-memory load per three
// multiply-adds), so it cannot come near that bound; wgmma on bf16 tiles
// fed by TMA is the next step.  The library is built with --fmad=false (for the
// bit parity of qn_event and amva); the two dot products here spell their
// multiply-adds as __fmaf_rn, which that flag leaves alone.  Attention
// parity with the plain version is held by tolerance, not bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cmath>

namespace {

constexpr float FA_NEG_INF = (float)(-0.7 * (double)FLT_MAX);
constexpr int TX = 16;               // threads along keys / head dim
constexpr int TY = 8;                // threads along q rows
constexpr int THREADS = TX * TY;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {                     // element strides of (B, S, heads)
  long long b, s, h;
};

template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int S, int group,
              int Dh, Strides qs, Strides ks, Strides vs, Strides os,
              int causal, int window, float scale) {
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
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < BQ * DMAX; e += THREADS) {
    const int i = e / DMAX, d = e % DMAX;
    float x = 0.f;
    if (q0 + i < S && d < Dh) x = to_f32(qb[(q0 + i) * qs.s + d]);
    sQ[i * LDQ + d] = x;
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
      float kx = 0.f, vx = 0.f;
      if (k0 + j < S && d < Dh) {
        kx = to_f32(kb[(k0 + j) * ks.s + d]);
        vx = to_f32(vb[(k0 + j) * vs.s + d]);
      }
      sK[j * LDQ + d] = kx;
      sV[j * DMAX + d] = vx;
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

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int qpos = q0 + ty + r * TY;
    if (qpos >= S) continue;
    const float den = fmaxf(l[r], 1e-37f);
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int d = tx + c * TX;
      if (d < Dh) store_as(&ob[qpos * os.s + d], acc[r][c] / den);
    }
  }
}

template <typename T, int DMAX, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int group, int Dh, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * (DMAX + 1) +
                                       (size_t)BK * (DMAX + 1) +
                                       (size_t)BK * DMAX +
                                       (size_t)BQ * (BK + 1));
  auto kernel = fa_fwd_kernel<T, DMAX, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, group, Dh, qs, ks, vs,
      os, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, int group, int Dh, Strides qs,
                     Strides ks, Strides vs, Strides os, int causal,
                     int window, float scale, cudaStream_t st) {
  if (Dh <= 64)
    return launch<T, 64, 64, 64>(q, k, v, o, B, S, H, group, Dh, qs, ks, vs,
                                 os, causal, window, scale, st);
  if (Dh <= 128)
    return launch<T, 128, 64, 32>(q, k, v, o, B, S, H, group, Dh, qs, ks, vs,
                                  os, causal, window, scale, st);
  return launch<T, 256, 32, 32>(q, k, v, o, B, S, H, group, Dh, qs, ks, vs,
                                os, causal, window, scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  Strides are in
// elements; the head dim must be contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
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
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0
          ? dispatch<float>(q, k, v, o, B, S, H, H / KV, Dh, qs, ks, vs, os,
                            causal, window, scale, st)
          : dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, H / KV, Dh, qs, ks,
                                    vs, os, causal, window, scale, st);
  return (int)err;
}
