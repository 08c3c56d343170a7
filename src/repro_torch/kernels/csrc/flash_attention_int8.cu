// The int8 K/V instantiations of the tensor-core flash-attention body
// (flash_tc.cuh, kQ8 = true): dense and paged, every head dim and key-split
// count of the bf16 body.  A translation unit of its own so that nvcc builds
// them beside flash_attention.cu's bf16 ones, not after them.
#include "flash_tc.cuh"

namespace repro_torch {
namespace tc {

cudaError_t launch_int8(const TcParams& tp, int ks, dim3 grid, cudaStream_t stream) {
  if (tp.a.bt != nullptr) return launch<true, true>(tp, ks, grid, stream);
  return launch<false, true>(tp, ks, grid, stream);
}

}  // namespace tc
}  // namespace repro_torch
