// The float32 instances of the flash backward's parts kernels
// (flash_attention_bwd_parts.cuh), compiled beside
// flash_attention_bwd_parts.cu in parallel: three bf16 parts an operand,
// DP = Dh rounded up to 64, at most 128.
#include "flash_attention_bwd_parts.cuh"

namespace fa_bwd_parts {

cudaError_t dq_f32(const Args& a, cudaStream_t st) {
  return a.Dh <= 64 ? launch_dq_parts<64, 2, 2, 3>(a, st)
                    : launch_dq_parts<128, 1, 1, 3>(a, st);
}

cudaError_t dkdv_f32(const Args& a, cudaStream_t st) {
  return a.Dh <= 64 ? launch_dkdv_parts<64, 3, 3>(a, st)
                    : launch_dkdv_parts<128, 1, 3>(a, st);
}

}  // namespace fa_bwd_parts
