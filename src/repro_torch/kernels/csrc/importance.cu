// Eq. 1 importance score, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/importance.py, importance_kernel -- at each
// skip stage of an ES-dLLM decode iteration, every active row is scored
//   I = alpha * c + (1 - alpha) * ||Hn - Ho||_1 / (sqrt(d) * ||Ho||_2 + eps)
// and the top-k rows go on to the deeper layers.
//
// What bounds it on this card: it reads two [rows, d] hidden planes once and
// writes one float per row -- a bandwidth-bound reduction, and at the main
// path's size (B * K rows of d = 4096) a launch-latency-bound one.  The
// design reads Hn and Ho exactly once, as the TPU kernel's single VMEM pass
// does: one warp per (b, k) row walks d with lane-contiguous (coalesced)
// loads, keeps sum|Hn - Ho| and sum Ho^2 in f32 registers, reduces both
// with warp shuffles and blends in the confidence.  Nothing but the score
// reaches device memory.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    importance_kernel(const T* hn, const T* ho, const float* conf, float* out, int rows, int d,
                      float alpha, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = hn + (long long)row * d;
  const T* o = ho + (long long)row * d;
  float l1 = 0.f, sq = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float x = to_f32(a[i]), y = to_f32(o[i]);
    l1 += fabsf(x - y);
    sq = fmaf(y, y, sq);
  }
  l1 = warp_sum(l1);
  sq = warp_sum(sq);
  if (lane == 0) {
    const float var = l1 / (sqrtf(static_cast<float>(d)) * sqrtf(sq) + eps);
    out[row] = alpha * conf[row] + (1.f - alpha) * var;
  }
}

}  // namespace
}  // namespace repro_torch

// h_new, h_old: [rows, d] contiguous of dtype; conf, out: [rows] f32.
// Returns a cudaError_t code (0 = launched), or -1 for arguments the kernel
// does not take.
extern "C" int repro_importance(int dtype, const void* h_new, const void* h_old,
                                const void* conf, void* out, int rows, int d, float alpha,
                                float eps, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || d <= 0) return -1;
  const dim3 grid((rows + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(conf);
  float* o = static_cast<float*>(out);
  if (dtype == kF32) {
    importance_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(h_new),
                                                   static_cast<const float*>(h_old), c, o,
                                                   rows, d, alpha, eps);
  } else if (dtype == kBF16) {
    importance_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(h_new), static_cast<const __nv_bfloat16*>(h_old), c,
        o, rows, d, alpha, eps);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
