// The C entry points of the flash backward's parts kernels
// (flash_attention_bwd_parts.cuh: what they compute and their design) and
// their bfloat16 instances; flash_attention_bwd_parts_f32.cu compiles the
// float32 ones, in parallel.
#include "flash_attention_bwd_parts.cuh"

namespace {

// bfloat16 (dtype 1) at Dh in (128, 256] or float32 (dtype 0) at Dh <= 128
bool bad_parts(int B, int S, int H, int KV, int Dh, int window, int dtype) {
  return B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || Dh <= 0 ||
         Dh % 8 || B > 65535 || H > 65535 || window < 0 ||
         !(dtype == 1 ? Dh > 128 && Dh <= 256 : dtype == 0 && Dh <= 128);
}

using fa_bwd_parts::Str;

Args parts_args(const void* qp, const void* kp, const void* vp,
                const void* dop, const void* rows, int B, int S, int H,
                int KV, int Dh, Str qps, Str kps, Str vps, Str dops,
                int causal, int window) {
  Args a{};
  a.qp = qp, a.kp = kp, a.vp = vp, a.dop = dop;
  a.rows = static_cast<const float*>(rows);
  a.B = B, a.S = S, a.H = H, a.KV = KV, a.Dh = Dh;
  a.qps = qps, a.kps = kps, a.vps = vps, a.dops = dops;
  a.causal = causal, a.window = window;
  return a;
}

}  // namespace

// rows (B, H, S_pad, 2) f32 contiguous, S_pad = S rounded up to 64: each q
// row's (lse * log2(e), delta = rowsum(dout * o)), zeros past S; for
// float32 (dtype 0) also the bf16 parts of q, dout (B, S, H, 3 DP) and k,
// v (B, S, KV, 3 DP), contiguous, DP = Dh rounded up to 64 (hi, mid and
// lo in columns [0, DP), [DP, 2 DP), [2 DP, 3 DP), zeros past Dh); for
// bfloat16 (dtype 1) the
// parts' pointers are unused.  Strides in elements, (b, s, head) of q, k,
// v, o and dout.  Anything off the parts route returns
// cudaErrorInvalidValue without a launch.
extern "C" int fa_bwd_prep_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* rows, void* qp, void* kp,
    void* vp, void* dop, int B, int S, int H, int KV, int Dh, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, long long dsb,
    long long dss, long long dsh, int dtype, void* stream) {
  if (bad_parts(B, S, H, KV, Dh, 0, dtype)) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh}, dos{dsb, dss, dsh};
  const int S_pad = rows_pad(S), DP = (Dh + 63) / 64 * 64;
  const long long warps = (long long)B * H * S_pad +
                          (dtype == 0 ? (long long)B * S * KV : 0);
  const unsigned blocks = (unsigned)((warps + 7) / 8);
  cudaStream_t st = (cudaStream_t)stream;
  auto bf = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
  const float* ls = static_cast<const float*>(lse);
  float* rw = static_cast<float*>(rows);
  if (dtype == 0)
    fa_bwd_prep_kernel<float, 3><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), ls, rw, bf(qp), bf(kp), bf(vp),
        bf(dop), B, S, S_pad, H, KV, Dh, DP, qs, ks, vs, os, dos);
  else
    fa_bwd_prep_kernel<__nv_bfloat16, 1><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), ls, rw, nullptr, nullptr,
        nullptr, nullptr, B, S, S_pad, H, KV, Dh, DP, qs, ks, vs, os, dos);
  return (int)cudaGetLastError();
}

// dq (B,S,H,Dh) in the inputs' type from the operands (the parts for
// float32, q, k, v and dout for bfloat16: 16-byte-aligned bases and
// strides that are multiples of 8, TMA) and the rows buffer of
// fa_bwd_prep_launch.  Strides in elements, (b, s, head) of the operands
// qp, kp, vp, dop and of dq.
extern "C" int fa_bwd_dq_parts_launch(
    const void* qp, const void* kp, const void* vp, const void* dop,
    const void* rows, void* dq, int B, int S, int H, int KV, int Dh,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh,
    long long dqsb, long long dqss, long long dqsh, int causal, int window,
    int dtype, void* stream) {
  if (bad_parts(B, S, H, KV, Dh, window, dtype))
    return (int)cudaErrorInvalidValue;
  Args a = parts_args(qp, kp, vp, dop, rows, B, S, H, KV, Dh,
                      Str{qsb, qss, qsh}, Str{ksb, kss, ksh},
                      Str{vsb, vss, vsh}, Str{dsb, dss, dsh}, causal,
                      window);
  a.dq = dq;
  a.dqs = Str{dqsb, dqss, dqsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)fa_bwd_parts::dq_f32(a, st);
  return (int)(Dh <= 192 ? launch_dq_parts<192, 2, 2, 1>(a, st)
                         : launch_dq_parts<256, 1, 2, 1>(a, st));
}

// dk, dv (B,S,KV,Dh) in the inputs' type from the operands and the rows
// buffer, as fa_bwd_dq_parts_launch; strides of the operands, then of dk
// and dv.
extern "C" int fa_bwd_dkdv_parts_launch(
    const void* qp, const void* kp, const void* vp, const void* dop,
    const void* rows, void* dk, void* dv, int B, int S, int H, int KV,
    int Dh, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh,
    long long dksb, long long dkss, long long dksh, long long dvsb,
    long long dvss, long long dvsh, int causal, int window, int dtype,
    void* stream) {
  if (bad_parts(B, S, H, KV, Dh, window, dtype))
    return (int)cudaErrorInvalidValue;
  Args a = parts_args(qp, kp, vp, dop, rows, B, S, H, KV, Dh,
                      Str{qsb, qss, qsh}, Str{ksb, kss, ksh},
                      Str{vsb, vss, vsh}, Str{dsb, dss, dsh}, causal,
                      window);
  a.dk = dk;
  a.dv = dv;
  a.dks = Str{dksb, dkss, dksh};
  a.dvs = Str{dvsb, dvss, dvsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)fa_bwd_parts::dkdv_f32(a, st);
  return (int)(Dh <= 192 ? launch_dkdv_parts<192, 3, 1>(a, st)
                         : launch_dkdv_parts<256, 2, 1>(a, st));
}
