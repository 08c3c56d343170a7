// The Mamba-2 SSD chunk step, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_chunk_kernel.  For every
// (batch row b, head h, chunk c) of Q positions, with cs the inclusive
// cumsum of dt * A (A = -exp(a_log[h])) within the chunk:
//   y_intra[i] = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//   contrib    = sum_i exp(cs_Q - cs_i) dt_i B_i (x) x_i      ([N, P])
//   decay      = exp(cs_Q),   cs
// Head h reads the B/C group h / (H / G).  The O(chunks) recurrence across
// chunks and the inter-chunk output stay in PyTorch (ops.ssd), as the TPU
// kernel leaves them to XLA.
//
// What bounds it on this card: three small dense products per block, in
// f32 (x * dt is f32 by definition, and so are the decay-weighted scores),
// about 1.9 MFLOP per block at Q 64, N 128, P 64, against 40-80 KB of
// inputs and 32 KB of f32 contrib out: f32 operations at 67 TFLOP/s bound
// it, not the bytes.  This first design is simple and right: one block of
// 256 threads per (b, h, c) stages x * dt, B and C once in shared memory as
// f32 (rows of B, C and the score tile padded by one float, so the strided
// reads below hit distinct banks), one thread scans dt * A (Q <= 64
// dependent adds), and each product is register-tiled on the CUDA cores:
// a thread keeps a 4x4 (scores), 2x8 (y) or 4x8 (contrib) tile of sums and
// reads each shared operand once per step of the reduction, broadcast to
// the threads that share it.  The score tile's exp is formed only where
// i >= j and the rest is stored as 0: the masked exp can be inf (the
// reference forms it and selects it away).  Making it fast (bf16 tensor
// cores through wgmma, TMA staging, skipping the masked half) is later work.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;   // the most dynamic shared memory a block can have
// register tiles: threads (rows x cols) x sums per thread (rows x cols)
constexpr int kSI = 4, kSJ = 4;    // scores: 16 x 16 threads, 4 x 4 sums, rows i + 16a
constexpr int kYI = 2, kYP = 8;    // y:      32 x 8 threads,  2 x 8 sums, rows i + 32a
constexpr int kCN = 4, kCP = 8;    // contrib: 32 x 8 threads, 4 x 8 sums, rows n + 32a

__host__ __device__ inline long long smem_floats(int q, int n, int p) {
  return (long long)q * p + 2LL * q * (n + 1) + (long long)q * (q + 1) + 3LL * q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a_log, const T* __restrict__ bm,
                     const T* __restrict__ cm, long long bc_stride, T* __restrict__ y,
                     float* __restrict__ contrib, float* __restrict__ decay,
                     float* __restrict__ cs_out, int L, int H, int P, int G, int N, int Q) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int g = h / (H / G);
  const int np = N + 1, sq = Q + 1;
  float* xdt = smem;             // [Q][P]    x * dt
  float* bs = xdt + Q * P;       // [Q][N+1]  B of the head's group
  float* csm = bs + Q * np;      // [Q][N+1]  C
  float* sc = csm + Q * np;      // [Q][Q+1]  masked, decayed scores
  float* cs = sc + Q * sq;       // [Q]       inclusive cumsum of dt * A
  float* dts = cs + Q;           // [Q]       dt
  float* w = dts + Q;            // [Q]       exp(cs_Q - cs_i)
  const int tid = threadIdx.x;
  const long long l0 = (long long)b * L + (long long)c * Q;   // the chunk's first row of [B * L]

  for (int q = tid; q < Q; q += kThreads) dts[q] = dt[(l0 + q) * H + h];
  __syncthreads();
  if (tid == 0) {
    const float a = -expf(a_log[h]);
    float run = 0.f;
    for (int q = 0; q < Q; ++q) {
      run += dts[q] * a;
      cs[q] = run;
    }
  }
  for (int e = tid; e < Q * P; e += kThreads) {
    const int q = e / P, p = e - q * P;
    xdt[e] = to_f32(x[((l0 + q) * H + h) * P + p]) * dts[q];
  }
  for (int e = tid; e < Q * N; e += kThreads) {
    const int q = e / N, n = e - q * N;
    const long long off = (l0 + q) * bc_stride + (long long)g * N + n;
    bs[q * np + n] = to_f32(bm[off]);
    csm[q * np + n] = to_f32(cm[off]);
  }
  __syncthreads();

  const float cs_last = cs[Q - 1];
  for (int q = tid; q < Q; q += kThreads) {
    w[q] = expf(cs_last - cs[q]);
    cs_out[(l0 + q) * H + h] = cs[q];
  }
  if (tid == 0) decay[((long long)b * nc + c) * H + h] = expf(cs_last);

  // scores[i][j] = (C_i . B_j) exp(cs_i - cs_j) for i >= j, else 0
  for (int i0 = 0; i0 < Q; i0 += 16 * kSI) {
    for (int j0 = 0; j0 < Q; j0 += 16 * kSJ) {
      const int ib = i0 + tid / 16, jb = j0 + tid % 16;
      float acc[kSI][kSJ] = {};
      for (int n = 0; n < N; ++n) {
        float cv[kSI], bv[kSJ];
#pragma unroll
        for (int a = 0; a < kSI; ++a) cv[a] = ib + 16 * a < Q ? csm[(ib + 16 * a) * np + n] : 0.f;
#pragma unroll
        for (int k = 0; k < kSJ; ++k) bv[k] = jb + 16 * k < Q ? bs[(jb + 16 * k) * np + n] : 0.f;
#pragma unroll
        for (int a = 0; a < kSI; ++a)
#pragma unroll
          for (int k = 0; k < kSJ; ++k) acc[a][k] = fmaf(cv[a], bv[k], acc[a][k]);
      }
#pragma unroll
      for (int a = 0; a < kSI; ++a) {
        const int i = ib + 16 * a;
#pragma unroll
        for (int k = 0; k < kSJ; ++k) {
          const int j = jb + 16 * k;
          if (i < Q && j < Q) sc[i * sq + j] = i >= j ? acc[a][k] * expf(cs[i] - cs[j]) : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // y_intra = scores @ (x * dt); the j > i scores are 0, so each thread
  // stops at its last row's diagonal
  for (int i0 = 0; i0 < Q; i0 += 32 * kYI) {
    for (int p0 = 0; p0 < P; p0 += 8 * kYP) {
      const int ib = i0 + tid / 8, pb = p0 + tid % 8;
      const int jmax = min(Q - 1, ib + 32 * (kYI - 1));
      float acc[kYI][kYP] = {};
      for (int j = 0; j <= jmax; ++j) {
        float sv[kYI], xv[kYP];
#pragma unroll
        for (int a = 0; a < kYI; ++a) sv[a] = ib + 32 * a < Q ? sc[(ib + 32 * a) * sq + j] : 0.f;
#pragma unroll
        for (int k = 0; k < kYP; ++k) xv[k] = pb + 8 * k < P ? xdt[j * P + pb + 8 * k] : 0.f;
#pragma unroll
        for (int a = 0; a < kYI; ++a)
#pragma unroll
          for (int k = 0; k < kYP; ++k) acc[a][k] = fmaf(sv[a], xv[k], acc[a][k]);
      }
#pragma unroll
      for (int a = 0; a < kYI; ++a) {
        const int i = ib + 32 * a;
#pragma unroll
        for (int k = 0; k < kYP; ++k) {
          const int p = pb + 8 * k;
          if (i < Q && p < P) y[((l0 + i) * H + h) * P + p] = from_f32<T>(acc[a][k]);
        }
      }
    }
  }

  // contrib = (B * w)^T @ (x * dt)
  float* out = contrib + (((long long)b * nc + c) * H + h) * (long long)N * P;
  for (int n0 = 0; n0 < N; n0 += 32 * kCN) {
    for (int p0 = 0; p0 < P; p0 += 8 * kCP) {
      const int nb = n0 + tid / 8, pb = p0 + tid % 8;
      float acc[kCN][kCP] = {};
      for (int q = 0; q < Q; ++q) {
        const float wq = w[q];
        float bv[kCN], xv[kCP];
#pragma unroll
        for (int a = 0; a < kCN; ++a) bv[a] = nb + 32 * a < N ? bs[q * np + nb + 32 * a] * wq : 0.f;
#pragma unroll
        for (int k = 0; k < kCP; ++k) xv[k] = pb + 8 * k < P ? xdt[q * P + pb + 8 * k] : 0.f;
#pragma unroll
        for (int a = 0; a < kCN; ++a)
#pragma unroll
          for (int k = 0; k < kCP; ++k) acc[a][k] = fmaf(bv[a], xv[k], acc[a][k]);
      }
#pragma unroll
      for (int a = 0; a < kCN; ++a) {
        const int n = nb + 32 * a;
#pragma unroll
        for (int k = 0; k < kCP; ++k) {
          const int p = pb + 8 * k;
          if (n < N && p < P) out[(long long)n * P + p] = acc[a][k];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a_log, const void* bm, const void* cm,
           long long bc_stride, void* y, float* contrib, float* decay, float* cs, int B, int L,
           int H, int P, int G, int N, int Q, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(Q, N, P);
  auto* kernel = ssd_chunk_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(L / Q, H, B);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(x), dt, a_log,
                                      static_cast<const T*>(bm), static_cast<const T*>(cm),
                                      bc_stride, static_cast<T*>(y), contrib, decay, cs, L, H,
                                      P, G, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// x, y: [B, L, H, P] contiguous of dtype; dt, cs: [B, L, H] f32; a_log: [H]
// f32; bm, cm: [B, L, G, N] of dtype with the last two dims contiguous and
// bc_stride elements between positions (a batch row spans L * bc_stride);
// contrib: [B, L / Q, H, N, P] f32; decay: [B, L / Q, H] f32.
// Returns a cudaError_t code (0 = launched), or -1 for arguments the kernel
// does not take.
extern "C" int repro_ssd_chunk(int dtype, const void* x, const void* dt, const void* a_log,
                               const void* bm, const void* cm, long long bc_stride, void* y,
                               void* contrib, void* decay, void* cs, int B, int L, int H,
                               int P, int G, int N, int Q, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || Q <= 0) return -1;
  if (L % Q != 0 || H % G != 0 || bc_stride < (long long)G * N || H > 65535 || B > 65535)
    return -1;
  if (sizeof(float) * smem_floats(Q, N, P) > (size_t)kMaxSmem) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  float* ct = static_cast<float*>(contrib);
  float* dc = static_cast<float*>(decay);
  float* c = static_cast<float*>(cs);
  if (dtype == kF32) {
    return launch<float>(x, d, al, bm, cm, bc_stride, y, ct, dc, c, B, L, H, P, G, N, Q, s);
  }
  if (dtype == kBF16) {
    return launch<__nv_bfloat16>(x, d, al, bm, cm, bc_stride, y, ct, dc, c, B, L, H, P, G, N,
                                 Q, s);
  }
  return -1;
}
