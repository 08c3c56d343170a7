// Eq. 1 importance and the adaptive cache's variation score, written by
// hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/importance.py, importance_kernel -- at each
// skip stage of an ES-dLLM decode iteration, every active row is scored
//   I = alpha * c + (1 - alpha) * ||Hn - Ho||_1 / (sqrt(d) * ||Ho||_2 + eps)
// and the top-k rows go on to the deeper layers -- and variation_kernel, the
// partial prompt refresh's priority over the whole sequence
//   V = alpha * c + (1 - alpha) * (1 - dot / (sqrt(||Hn||^2 * ||Ho||^2) + eps))
// (exactly this form: a clamp of each norm, as cosine_similarity does, would
// change the score; a zero cached row scores alpha * c + (1 - alpha)).
//
// What bounds it on this card: it reads two [rows, d] hidden planes once and
// writes one float per row -- a bandwidth-bound reduction.  At the skip
// stages (B * K rows of d = 4096) it is bound by launch latency; the
// variation score reads the full sequence ([B, T, d] f32, some tens of MB at
// serving sizes), where device memory bounds it.  The design reads Hn and Ho
// exactly once, as the TPU kernel's single VMEM pass does: one warp per row
// walks d with lane-contiguous (coalesced) loads, keeps its two or three
// running sums in f32 registers, reduces them with warp shuffles and blends
// in the confidence.  Nothing but the score reaches device memory.  One
// kernel serves both scores; a template flag picks the formula.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;

template <typename T, bool kVariation>
__global__ void __launch_bounds__(kWarps * 32)
    score_kernel(const T* hn, const T* ho, const float* conf, float* out, int rows, int d,
                 float alpha, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = hn + (long long)row * d;
  const T* o = ho + (long long)row * d;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;  // importance: l1, |Ho|^2; variation: dot, |Hn|^2, |Ho|^2
  for (int i = lane; i < d; i += 32) {
    const float x = to_f32(a[i]), y = to_f32(o[i]);
    if constexpr (kVariation) {
      s0 = fmaf(x, y, s0);
      s1 = fmaf(x, x, s1);
      s2 = fmaf(y, y, s2);
    } else {
      s0 += fabsf(x - y);
      s1 = fmaf(y, y, s1);
    }
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  if constexpr (kVariation) s2 = warp_sum(s2);
  if (lane == 0) {
    float var;
    if constexpr (kVariation) {
      var = 1.f - s0 / (sqrtf(s1 * s2) + eps);
    } else {
      var = s0 / (sqrtf(static_cast<float>(d)) * sqrtf(s1) + eps);
    }
    out[row] = alpha * conf[row] + (1.f - alpha) * var;
  }
}

template <typename T>
void launch(bool variation, const void* h_new, const void* h_old, const float* conf,
            float* out, int rows, int d, float alpha, float eps, cudaStream_t s) {
  const dim3 grid((rows + kWarps - 1) / kWarps), block(kWarps * 32);
  const T* a = static_cast<const T*>(h_new);
  const T* o = static_cast<const T*>(h_old);
  if (variation) {
    score_kernel<T, true><<<grid, block, 0, s>>>(a, o, conf, out, rows, d, alpha, eps);
  } else {
    score_kernel<T, false><<<grid, block, 0, s>>>(a, o, conf, out, rows, d, alpha, eps);
  }
}

}  // namespace
}  // namespace repro_torch

// h_new, h_old: [rows, d] contiguous of dtype; conf, out: [rows] f32.
// variation: 0 = Eq. 1 importance, 1 = the variation score.
// Returns a cudaError_t code (0 = launched), or -1 for arguments the kernel
// does not take.
extern "C" int repro_importance(int dtype, int variation, const void* h_new, const void* h_old,
                                const void* conf, void* out, int rows, int d, float alpha,
                                float eps, void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || d <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(conf);
  float* o = static_cast<float*>(out);
  if (dtype == kF32) {
    launch<float>(variation != 0, h_new, h_old, c, o, rows, d, alpha, eps, s);
  } else if (dtype == kBF16) {
    launch<__nv_bfloat16>(variation != 0, h_new, h_old, c, o, rows, d, alpha, eps, s);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
