// Mamba2 SSD chunked scan, backward, bfloat16 route: the instances past
// P = 64 (PP = 128), compiled apart from ssd_scan_bwd_wgmma.cu so that the
// two halves build in parallel.
#include "ssd_scan_bwd_wgmma.cuh"

cudaError_t ssd_bwd_wgmma::launch_p128(const Launch& L,
                                       cudaStream_t stream) {
  return L.N <= 64 ? launch_route<128, 64>(L, stream)
                   : launch_route<128, 128>(L, stream);
}
