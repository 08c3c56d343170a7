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
// writes one float per row, so device memory bounds it.  At the skip stages
// the planes are 1-4 MB (B * K rows of d up to 4096, f32), which 3.35 TB/s
// moves in about a microsecond: there a call costs its launch plus the
// device-memory latencies it waits for one after the other, and the design
// keeps that chain to one or two latencies with every byte in flight:
//
//   * a block of `group` threads scores one row (group and loads a thread
//     come from the caller, kernels/importance.py::plan): each thread issues
//     all of its 16-byte loads of Hn (kLoads of them, as inline asm the
//     compiler keeps in place), then those of Ho, before it does any
//     arithmetic.  At d 4096 f32 256 threads with 4 loads a plane hold the
//     whole 32 KB row pair in flight; a row longer than group * kLoads
//     vectors takes more trips, the next trip's Hn loads issued before this
//     trip's sums.
//   * the skip stage's row gathers happen in the loads (idx != null): row k
//     of batch entry b reads Ho and conf at idx[b, k] of the entry's S
//     cached rows.  idx is read before Hn, so the Hn loads overlap its
//     latency and only Ho waits for it; nothing is gathered into a copy.  An
//     index outside [0, S) reads nothing of Ho or conf: the row scores NaN.
//   * the two or three running sums stay in f32 registers, reduce across a
//     warp by shuffles and across the block's warps through shared memory;
//     one thread blends in the confidence and writes the score.
//   * any d: when every row of both planes starts on a 16-byte boundary
//     (16-byte bases, d * elem a multiple of 16) the loads are vectors only
//     (kAligned); otherwise a row whose Hn and Ho share their offset within
//     16 bytes takes scalar elements up to the boundary, vectors, then a
//     scalar tail, and a row whose offsets differ goes element by element.
//
// One kernel serves both scores; a template flag picks the formula.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxThreads = 256;

struct ScoreArgs {
  const void* hn;     // [rows, d]
  const void* ho;     // [rows, d], or [B, S, d] with idx
  const float* conf;  // [rows], or [B, S] with idx
  const int* idx;     // [B, K] rows of Ho and conf, or null
  float* out;         // [rows]
  int d, K, S;
  float alpha, eps;
};

// 16 bytes from device memory through the read-only path, issued where it
// stands: volatile asm is not moved below the instructions that follow it.
// Each byte is read once, so nothing is kept in L1, and the L2 fetches the
// 256 bytes around it, which neighbouring threads read (on the H100 the
// variation score ran 0.0139 -> 0.0121 ms with these hints, PERF.md).
__device__ __forceinline__ uint4 load16(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

__device__ __forceinline__ int load_idx(const int* p) {
  int r;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(r) : "l"(p));
  return r;
}

__device__ __forceinline__ float load_f32(const float* p) {
  float r;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(r) : "l"(p));
  return r;
}

// importance: s0 = |Hn - Ho|_1, s1 = |Ho|^2; variation: s0 = dot, s1 = |Hn|^2,
// s2 = |Ho|^2
template <bool kVar>
__device__ __forceinline__ void add(float x, float y, float (&s)[3]) {
  if constexpr (kVar) {
    s[0] = fmaf(x, y, s[0]);
    s[1] = fmaf(x, x, s[1]);
    s[2] = fmaf(y, y, s[2]);
  } else {
    s[0] += fabsf(x - y);
    s[1] = fmaf(y, y, s[1]);
  }
}

// the elements of one 16-byte vector of each plane (zeros add nothing)
template <typename T, bool kVar>
__device__ __forceinline__ void add16(const uint4& a, const uint4& o, float (&s)[3]) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w}, ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    if constexpr (std::is_same_v<T, float>) {
      add<kVar>(__uint_as_float(av[w]), __uint_as_float(ov[w]), s);
    } else {   // two bf16, the first in the low half: exact as f32 by a shift
      add<kVar>(__uint_as_float(av[w] << 16), __uint_as_float(ov[w] << 16), s);
      add<kVar>(__uint_as_float(av[w] & 0xffff0000u), __uint_as_float(ov[w] & 0xffff0000u), s);
    }
  }
}

// vectors v0 + u * group (u < kLoads) of a row, zeros past nvec
template <int kLoads>
__device__ __forceinline__ void load_trip(uint4 (&r)[kLoads], const uint4* p, int v0, int nvec,
                                          int group) {
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int v = v0 + u * group;
    r[u] = v < nvec ? load16(p + v) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// One block of `group` threads per row; thread t takes the vectors
// t + (trip * kLoads + u) * group of its row and, off the vector path, the
// scalar elements t + j * group of the head and the tail.
template <typename T, bool kVar, int kLoads, bool kAligned>
__global__ void __launch_bounds__(kMaxThreads) score_kernel(const ScoreArgs a) {
  constexpr int kW = 16 / sizeof(T);   // elements of a vector
  __shared__ float part[kMaxThreads / 32][3];
  const int row = blockIdx.x, t = threadIdx.x, group = blockDim.x;
  const int d = a.d;
  const T* h = static_cast<const T*>(a.hn) + (long long)row * d;
  int i = row;
  if (a.idx != nullptr) i = load_idx(a.idx + row);     // first: Ho waits for it
  int head = 0, nvec = d / kW;
  uint4 x[kLoads], y[kLoads];
  if constexpr (kAligned) {   // the first trip's Hn loads need neither idx nor Ho
    load_trip<kLoads>(x, reinterpret_cast<const uint4*>(h), t, nvec, group);
  }
  // the cached row; out of range, the row reads Hn in its place and scores NaN
  const bool in_range = a.idx == nullptr || (i >= 0 && i < a.S);
  const long long src = a.idx == nullptr ? row : (long long)(row / a.K) * a.S + i;
  const T* o = in_range ? static_cast<const T*>(a.ho) + src * d : h;
  float c = 0.f;
  if (in_range && t == 0) c = load_f32(a.conf + src);
  float s[3] = {0.f, 0.f, 0.f};
  if constexpr (!kAligned) {
    const unsigned mh = reinterpret_cast<uintptr_t>(h) % 16;
    const unsigned mo = reinterpret_cast<uintptr_t>(o) % 16;
    head = mh == mo ? min(d, (int)((16 - mh) % 16 / sizeof(T))) : d;
    nvec = (d - head) / kW;
    for (int e = t; e < head; e += group) add<kVar>(to_f32(h[e]), to_f32(o[e]), s);
    for (int e = head + nvec * kW + t; e < d; e += group) {
      add<kVar>(to_f32(h[e]), to_f32(o[e]), s);
    }
    load_trip<kLoads>(x, reinterpret_cast<const uint4*>(h + head), t, nvec, group);
  }
  const uint4* hv = reinterpret_cast<const uint4*>(h + head);
  const uint4* ov = reinterpret_cast<const uint4*>(o + head);
  for (int v0 = t;;) {
    load_trip<kLoads>(y, ov, v0, nvec, group);
#pragma unroll
    for (int u = 0; u < kLoads; ++u) add16<T, kVar>(x[u], y[u], s);
    v0 += group * kLoads;
    if (v0 >= nvec) break;
    load_trip<kLoads>(x, hv, v0, nvec, group);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < (kVar ? 3 : 2); ++j) {
    s[j] = warp_sum(s[j]);
    if (lane == 0) part[warp][j] = s[j];
  }
  __syncthreads();
  if (t != 0) return;
  float r[3] = {0.f, 0.f, 0.f};
  for (int w = 0; w < group / 32; ++w) {
#pragma unroll
    for (int j = 0; j < (kVar ? 3 : 2); ++j) r[j] += part[w][j];
  }
  float var;
  if constexpr (kVar) {
    var = 1.f - r[0] / (sqrtf(r[1] * r[2]) + a.eps);
  } else {
    var = r[0] / (sqrtf(static_cast<float>(d)) * sqrtf(r[1]) + a.eps);
  }
  a.out[row] = in_range ? a.alpha * c + (1.f - a.alpha) * var : __int_as_float(0x7fc00000);
}

using Kernel = void (*)(ScoreArgs);

template <typename T, bool kVar, bool kAligned>
Kernel pick(int loads) {
  switch (loads) {
    case 1: return score_kernel<T, kVar, 1, kAligned>;
    case 2: return score_kernel<T, kVar, 2, kAligned>;
    case 4: return score_kernel<T, kVar, 4, kAligned>;
    default: return nullptr;
  }
}

template <typename T>
Kernel pick(bool variation, bool aligned, int loads) {
  if (variation) return aligned ? pick<T, true, true>(loads) : pick<T, true, false>(loads);
  return aligned ? pick<T, false, true>(loads) : pick<T, false, false>(loads);
}

}  // namespace
}  // namespace repro_torch

// h_new: [rows, d] contiguous of dtype; out: [rows] f32.  Without idx, h_old
// is [rows, d] and conf [rows] f32; with idx ([rows / K, K] int32), h_old is
// [rows / K, S, d] and conf [rows / K, S], read at idx.  variation: 0 = Eq. 1
// importance, 1 = the variation score.  A block of group threads (32, 64, 128
// or 256) scores each row, each thread keeping loads (1, 2 or 4) 16-byte
// loads of each plane in flight.  Returns a cudaError_t code (0 = launched),
// or -1 for arguments the kernel does not take.
extern "C" int repro_importance(int dtype, int variation, const void* h_new, const void* h_old,
                                const void* conf, const void* idx, void* out, int rows, int d,
                                int K, int S, float alpha, float eps, int group, int loads,
                                void* stream) {
  using namespace repro_torch;
  if (rows <= 0 || d <= 0) return -1;   // rows: the grid, at most INT32_MAX blocks
  if (group != 32 && group != 64 && group != 128 && group != 256) return -1;
  if (idx != nullptr && (K <= 0 || S <= 0 || rows % K != 0)) return -1;
  const int elem = dtype == kF32 ? 4 : 2;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(h_new) | reinterpret_cast<uintptr_t>(h_old);
  const bool aligned = bases % 16 == 0 && ((long long)d * elem) % 16 == 0;
  Kernel k = nullptr;
  if (dtype == kF32) {
    k = pick<float>(variation != 0, aligned, loads);
  } else if (dtype == kBF16) {
    k = pick<__nv_bfloat16>(variation != 0, aligned, loads);
  }
  if (k == nullptr) return -1;
  const ScoreArgs a{h_new, h_old, static_cast<const float*>(conf), static_cast<const int*>(idx),
                    static_cast<float*>(out), d, K, S, alpha, eps};
  k<<<rows, group, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
