// An empty kernel: the card's launch floor, the least time a launch of any
// kernel of the port takes on the stream.  No path launches it;
// chip_smoke.py and benchmarks/torch_streams_amva_ab.py time it queued back
// to back beside the draw-table and AMVA kernels, whose own work is near
// that floor.
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

// One launch of the empty kernel (one warp) on `stream`.
extern "C" int launch_floor_launch(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
