// Mamba2 SSD chunked scan, backward, bfloat16 route: the C entry point
// (P <= 64 instances here, the rest in ssd_scan_bwd_wgmma_p128.cu).  The
// kernels are in ssd_scan_bwd_wgmma.cuh; what the route computes, what
// bounds it and its design are in the header note of ssd_scan_bwd.cu.
#include "ssd_scan_bwd_wgmma.cuh"

// The bf16 route of the SSD backward: x, B, C and dy bfloat16 with
// 16-byte-aligned bases and strides that are multiples of 8 elements, P a
// multiple of 8 (anything else is refused, never sent to the SIMT route).
// dt and A float32 or bfloat16 (dtypes 0 / 1); dstate (B, H, P, N) f32
// contiguous; dx, ddt, dB, dC contiguous in the inputs' dtypes.  Scratch:
// s_img and ds_img (B, H, nc) images of IMG bytes each (ops.image_bytes);
// dgsum (B, nc, G2, 128, 128) f32; rows (2, B, H, S) f32; chunks (2, B, H,
// nc) f32; dbc (2, B, G3, S, N) f32.  G2 and G3 (head groups of the chunk
// and dbdc passes) in [1, H], every group holding a head.  Five kernels on
// one stream.
extern "C" int ssd_bwd_wgmma_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, const void* dstate, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* s_img, void* ds_img, void* dgsum,
    void* rows, void* chunks, void* dbc, int Bb, int S, int H, int P, int N,
    int chunk, int G2, int G3, long long xsb, long long xss, long long xsh,
    long long dsb, long long dss, long long dsh, long long as,
    long long bsb, long long bss, long long csb, long long css,
    long long ysb, long long yss, long long ysh, int dt_dtype, int a_dtype,
    void* stream) {
  if (Bb <= 0 || Bb > 65535 || S <= 0 || H <= 0 || H > 65535 || P <= 0 ||
      P > 128 || P % 8 || N <= 0 || N > 128 || chunk <= 0 || chunk > QP ||
      S % chunk || (dt_dtype | a_dtype) & ~1 || G2 < 1 || G2 > H ||
      G3 < 1 || G3 > H || 2 * G3 > 65535 || G2 > 65535 ||
      (G2 - 1) * ((H + G2 - 1) / G2) >= H ||
      (G3 - 1) * ((H + G3 - 1) / G3) >= H || !tma_ok(x, xsb, xss, xsh) ||
      !tma_ok(dy, ysb, yss, ysh) || !tma_ok(B, bsb, bss, bss) ||
      !tma_ok(C, csb, css, css))
    return (int)cudaErrorInvalidValue;
  const ssd_bwd_wgmma::Launch L{
      x, dt, A, B, C, dy, static_cast<const float*>(dstate),
      dx, ddt, dA, dB, dC,
      static_cast<uint8_t*>(s_img), static_cast<uint8_t*>(ds_img),
      static_cast<float*>(dgsum), static_cast<float*>(rows),
      static_cast<float*>(chunks), static_cast<float*>(dbc),
      Bb, S, H, P, N, chunk, G2, G3,
      xsb, xss, xsh, bsb, bss, csb, css, ysb, yss, ysh,
      dsb, dss, dsh, as, dt_dtype, a_dtype};
  cudaStream_t st = (cudaStream_t)stream;
  if (P > 64) return (int)ssd_bwd_wgmma::launch_p128(L, st);
  return (int)(N <= 64 ? launch_route<64, 64>(L, st)
                       : launch_route<64, 128>(L, st));
}
