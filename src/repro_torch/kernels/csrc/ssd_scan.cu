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
// Two bodies compute the same function; the wrapper picks one from the
// arguments alone (kernels/ssd_scan.py, plan()):
//
// * ssd_tc_kernel, the tensor-core body: bf16 x, B and C, Q 16, 32, 48 or
//   64, N and P multiples of 16, rows on 16-byte boundaries -- every
//   full-width path (mamba2-370m: Q 32 decode blocks, Q 64 prefill chunks,
//   N 128, P 64, one B/C group for 32 heads).  What bounds it: latency.
//   A call moves a few MB (most of it the f32 contrib, 32 KB a head and
//   chunk) and does a few MFLOP a block, but at decode the grid is one
//   block a (batch row, head): each block's chain -- load, scan, products,
//   stores -- is the time.  The first body's limits were its own: f32 FMAs
//   on the CUDA cores with two shared loads each, 64-row tiles that at Q 32
//   multiplied zeros, the masked half computed and dropped, C B^T
//   recomputed for every head of a group, one thread's serial cumsum, and
//   scalar staging and stores.  The design:
//   - one block per (chunk, batch row, tile of HB heads of one B/C group),
//     of 8 warps in two roles that run side by side: 4 contrib warps and 4
//     y warps (C B^T, then y).  On the H100 this timed faster at the decode
//     shape than 4 warps doing both in turn: once its data is in, a block's
//     time is the longer chain, not the sum (PERF.md);
//   - B and the HB heads' x rows arrive as 16-byte cp.async copies (group
//     0, all threads), C after them (group 1, the y warps, which wait for it
//     at their own named barrier), into bf16 rows padded by 16 bytes so that
//     ldmatrix is free of bank conflicts; no division per element; each
//     head's dt is loaded before the bulk copies are queued;
//   - C B^T once per block on mma.sync m16n8k16 (bf16 in, f32 accumulate:
//     the products of bf16 values are exact, as the reference's f32 dot),
//     only the 16 x 16 tiles on or below the diagonal, kept in registers by
//     the y warp that owns the row slab (at Q 32 and 16, 2 or 4 warps share
//     a slab and split its columns of y) and reused by all HB heads;
//   - the cumsum of dt * A per head is a warp-shuffle inclusive scan (two
//     passes and a carry at Q 64); exp(cs_i - cs_j) is formed only where
//     i >= j (the masked exp can be inf);
//   - y_intra = (C B^T * exp(cs_i - cs_j) * dt_j) @ x: the decayed,
//     dt-weighted scores are the A operand, formed straight from the C B^T
//     accumulators; x is the B operand, exact; tiles above the diagonal are
//     skipped.  Rounding the scores to bf16 once missed the bf16 tolerance
//     (1e-2) at mamba2-370m's full width in a plain mirror of these
//     roundings (ref.ssd_chunks_tc, tests/test_torch_ssd_plan.py), so they
//     are split like contrib's operand below: y's products are a few of
//     the block's, doubling them costs little;
//   - contrib = B^T @ (x * exp(cs_Q - cs_q) dt_q): B^T (exact bf16) by
//     transposing ldmatrix, the f32 right operand split into a bf16 high
//     part and a bf16 remainder, two products accumulated in f32 (about
//     2^-16 relative, inside the f32 tolerance of 1e-4); each contrib warp
//     owns 16 columns of P and a share of N, and a lane pair trades halves
//     with one shuffle each way so every lane stores 16 contiguous bytes;
//   - no atomics: every run gives the same bits, whatever HB.
//
// * ssd_chunk_kernel, the CUDA-core body: f32 (the CPU parity's type) and
//   every shape the tensor-core body does not take.  One block of 256
//   threads per (b, h, c) stages x * dt, B and C once in shared memory as
//   f32 (rows of B, C and the score tile padded by one float, so the
//   strided reads below hit distinct banks), one thread scans dt * A (Q <= 64
//   dependent adds), and each product is register-tiled on the CUDA cores:
//   a thread keeps a 4x4 (scores), 2x8 (y) or 4x8 (contrib) tile of sums and
//   reads each shared operand once per step of the reduction, broadcast to
//   the threads that share it.  The score tile's exp is formed only where
//   i >= j and the rest is stored as 0: the masked exp can be inf (the
//   reference forms it and selects it away).  About 1.9 MFLOP of f32 per
//   block at Q 64, N 128, P 64: issuing those instructions bounds it.
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

// ---------------------------------------------------------------------------
// The tensor-core body (bf16)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRoleWarps = 4;                  // warps of each role
constexpr int kRoleThreads = kRoleWarps * 32;
constexpr int kThreads = 2 * kRoleThreads;     // contrib warps, then y warps
constexpr int kPad = 8;            // bf16 of padding per shared row: 16 bytes

struct Args {
  const bf16* x;         // [B, L, H, P]
  const float* dt;       // [B, L, H]
  const float* a_log;    // [H]
  const bf16* bm;        // [B, L, G, N], bc_stride elements between positions
  const bf16* cm;
  long long bc_stride;
  bf16* y;               // [B, L, H, P]
  float* contrib;        // [B, nC, H, N, P]
  float* decay;          // [B, nC, H]
  float* cs;             // [B, L, H]
  int L, H, P, G, N, HB;
};

// Shared memory: cs, dt and exp(cs_Q - cs_q) dt_q of the HB heads (f32),
// then B and C [Q][N + 8] and the heads' x [HB][Q][P + 8] (bf16).
__host__ __device__ inline long long smem_bytes(int q, int n, int p, int hb) {
  return 12LL * hb * q + 2LL * (2LL * q * (n + kPad) + (long long)hb * q * (p + kPad));
}

// e / d as a multiply-high, exact for e * d < 2^32 (here e < 2^16, 2 <= d < 2^16)
struct FastDiv {
  unsigned m;
  __device__ __forceinline__ explicit FastDiv(int d) : m(0xffffffffu / d + 1u) {}
  __device__ __forceinline__ int div(int e) const { return __umulhi(static_cast<unsigned>(e), m); }
};

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// (v0, v1) as a bf16 pair plus the bf16 pair of what it missed: the two
// hold v to about 2^-16 relative
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 r = unpack_bf16(hi);
  lo = pack_bf16(v0 - r.x, v1 - r.y);
}

template <int QT>
__global__ void __launch_bounds__(kThreads) ssd_tc_kernel(Args a) {
  constexpr int Q = 16 * QT;
  constexpr int kSplit = kRoleWarps / QT;        // y warps sharing a row slab
  constexpr int kPasses = (Q + 31) / 32;         // scan passes of 32 positions
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HB = a.HB, N = a.N, P = a.P, H = a.H;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int h0 = blockIdx.x * HB;
  const int g = h0 / (H / a.G);
  const int np = N + kPad, pp = P + kPad;
  float* cs_s = reinterpret_cast<float*>(smem_raw);   // [HB][Q] inclusive cumsum of dt * A
  float* dt_s = cs_s + HB * Q;                         // [HB][Q] dt
  float* w_s = dt_s + HB * Q;                          // [HB][Q] exp(cs_Q - cs_q) dt_q
  bf16* b_s = reinterpret_cast<bf16*>(w_s + HB * Q);   // [Q][N + 8]
  bf16* c_s = b_s + Q * np;                            // [Q][N + 8]
  bf16* x_s = c_s + Q * np;                            // [HB][Q][P + 8]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;             // mma fragment row and column pair
  const bool y_role = warp >= kRoleWarps;
  const int role_warp = warp - (y_role ? kRoleWarps : 0);
  const long long l0 = (long long)b * a.L + (long long)c * Q;   // the chunk's first row
  // a lane's ldmatrix row of B: rows j of C B^T's right operand, and (the
  // same addresses, transposed) B^T as contrib's left operand
  const uint32_t b_lane = smem_u32(b_s + ((lane & 7) + ((lane >> 4) << 3)) * np +
                                   (((lane >> 3) & 1) << 3));
  // a lane's ldmatrix row of a 16 x 16 tile of x (transposed: the B operand)
  const int x_lane_off = (lane & 15) * pp + ((lane >> 4) << 3);

  // warp hh < HB scans head h0 + hh: its dt and a_log are loaded before the
  // bulk copies are queued, so they do not wait behind them
  const bool scans = warp < HB;
  float dts[kPasses], a_log_h = 0.f;
  if (scans) {
    a_log_h = a.a_log[h0 + warp];
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int q = u * 32 + lane;
      dts[u] = q < Q ? a.dt[(l0 + q) * H + h0 + warp] : 0.f;   // 0 past Q: adds nothing
    }
  }

  // B and the heads' x rows (group 0, all threads: both roles read them),
  // then C (group 1, the y warps alone), 16 bytes a copy
  {
    const int cpr = N >> 3;
    const FastDiv by_row(cpr);
    const long long bc0 = l0 * a.bc_stride + (long long)g * N;
    for (int e = tid; e < Q * cpr; e += kThreads) {
      const int q = by_row.div(e), k = (e - q * cpr) << 3;
      cp_async16(smem_u32(b_s + q * np + k), a.bm + bc0 + q * a.bc_stride + k, true);
    }
    const int cph = P >> 3, cpx = HB * cph;      // per head, per position
    const FastDiv by_pos(cpx), by_head(cph);
    const bf16* xg = a.x + (l0 * H + h0) * P;    // position q's HB heads are contiguous
    for (int e = tid; e < Q * cpx; e += kThreads) {
      const int q = by_pos.div(e), r = e - q * cpx;
      const int hh = by_head.div(r), k = (r - hh * cph) << 3;
      cp_async16(smem_u32(x_s + (hh * Q + q) * pp + k), xg + (long long)q * H * P + r * 8,
                 true);
    }
    cp_async_commit();
    if (y_role) {
      for (int e = tid - kRoleThreads; e < Q * cpr; e += kRoleThreads) {
        const int q = by_row.div(e), k = (e - q * cpr) << 3;
        cp_async16(smem_u32(c_s + q * np + k), a.cm + bc0 + q * a.bc_stride + k, true);
      }
      cp_async_commit();
    }
  }

  // the inclusive scan of dt * A, 32 positions a pass and a carry
  if (scans) {
    const int h = h0 + warp;
    const float A = -expf(a_log_h);
    float run[kPasses];
    float carry = 0.f;
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      float v = dts[u] * A;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(kFullMask, v, o);
        if (lane >= o) v += n;
      }
      run[u] = v + carry;
      carry = __shfl_sync(kFullMask, run[u], 31);
    }
    const float last = carry;                          // cs_{Q-1}
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int q = u * 32 + lane;
      if (q < Q) {
        cs_s[warp * Q + q] = run[u];
        dt_s[warp * Q + q] = dts[u];
        w_s[warp * Q + q] = expf(last - run[u]) * dts[u];
        a.cs[(l0 + q) * H + h] = run[u];
      }
    }
    if (lane == 0) a.decay[((long long)b * nc + c) * H + h] = expf(last);
  }
  if (y_role)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  __syncthreads();                               // B, x and the scans are in

  if (!y_role) {
    // contrib = B^T @ (x * w), w_q = exp(cs_Q - cs_q) dt_q.  A work item is
    // (head, 16 columns of P, a share of the N rows): each 16-column block's
    // N rows are split among up to kRoleWarps / ncb warps.
    const int ncb = P >> 4;
    const int n_parts = ncb < kRoleWarps ? kRoleWarps / ncb : 1, per_head = ncb * n_parts;
    const bool odd = lane & 1;
    for (int item = role_warp; item < HB * per_head; item += kRoleWarps) {
      const int hh = item / per_head, rest = item - hh * per_head;
      const int cb = rest / n_parts, n_part = rest - cb * n_parts;
      const float* wh = w_s + hh * Q;
      const uint32_t x_tile = smem_u32(x_s + hh * Q * pp + x_lane_off + cb * 16);
      uint32_t xh_[QT][4], xl_[QT][4];           // B fragments: x * w, high part and rest
#pragma unroll
      for (int kt = 0; kt < QT; ++kt) {
        uint32_t r[4];
        ldsm_x4_trans(x_tile + kt * 16 * pp * 2, r[0], r[1], r[2], r[3]);
        const int q = kt * 16 + 2 * tq;
        const float w0 = wh[q], w1 = wh[q + 1], w8 = wh[q + 8], w9 = wh[q + 9];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f = unpack_bf16(r[u]);
          split_pair(f.x * (u & 1 ? w8 : w0), f.y * (u & 1 ? w9 : w1), xh_[kt][u],
                     xl_[kt][u]);
        }
      }
      float* col = a.contrib + (((long long)b * nc + c) * H + h0 + hh) * (long long)N * P +
                   cb * 16 + 4 * (tq >> 1);
#pragma unroll 4
      for (int mt = n_part; mt < (N >> 4); mt += n_parts) {
        float acc[2][4] = {};
#pragma unroll
        for (int kt = 0; kt < QT; ++kt) {
          uint32_t af[4];                          // B^T rows 16 mt, columns 16 kt
          ldsm_x4_trans(b_lane + (kt * 16 * np + mt * 16) * 2, af[0], af[1], af[2], af[3]);
          mma_bf16(acc[0], af, xl_[kt][0], xl_[kt][1]);
          mma_bf16(acc[1], af, xl_[kt][2], xl_[kt][3]);
          mma_bf16(acc[0], af, xh_[kt][0], xh_[kt][1]);
          mma_bf16(acc[1], af, xh_[kt][2], xh_[kt][3]);
        }
        // a lane pair holds rows n and n + 8 of 4 columns each: the even lane
        // takes row n, the odd lane row n + 8, so each stores 16 bytes
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float s0 = odd ? acc[nt][0] : acc[nt][2];
          const float s1 = odd ? acc[nt][1] : acc[nt][3];
          const float r0 = __shfl_xor_sync(kFullMask, s0, 1);
          const float r1 = __shfl_xor_sync(kFullMask, s1, 1);
          const float4 v = odd ? make_float4(r0, r1, acc[nt][2], acc[nt][3])
                               : make_float4(acc[nt][0], acc[nt][1], r0, r1);
          const int n = mt * 16 + gq + (odd ? 8 : 0);
          *reinterpret_cast<float4*>(col + (long long)n * P + nt * 8) = v;
        }
      }
    }
    return;
  }

  // the y warps: C arrives, then C B^T for the warp's row slab it (tiles
  // jt <= it only, kept in registers and used by every head), then y
  cp_async_wait<0>();
  asm volatile("bar.sync 1, %0;\n" ::"n"(kRoleThreads) : "memory");
  const int it = role_warp % QT, part = role_warp / QT;
  if (part >= kSplit) return;                    // at Q 48 one y warp has no slab
  float sc[QT][2][4] = {};
  {
    const uint32_t a_row = smem_u32(c_s + (it * 16 + (lane & 15)) * np + ((lane >> 4) << 3));
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t af[4];
      ldsm_x4(a_row + k0 * 2, af[0], af[1], af[2], af[3]);
#pragma unroll
      for (int jt = 0; jt < QT; ++jt) {
        if (jt <= it) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(b_lane + (jt * 16 * np + k0) * 2, b0, b1, b2, b3);
          mma_bf16(sc[jt][0], af, b0, b1);
          mma_bf16(sc[jt][1], af, b2, b3);
        }
      }
    }
  }

  // y_intra = (C B^T * exp(cs_i - cs_j) * dt_j) @ x, per head
  const int ncb = P >> 4;
  const int i0 = it * 16 + gq;
  for (int hh = 0; hh < HB; ++hh) {
    const int h = h0 + hh;
    const float* csh = cs_s + hh * Q;
    const float* dth = dt_s + hh * Q;
    const uint32_t x_tile = smem_u32(x_s + hh * Q * pp + x_lane_off);
    // A operand: the decayed, dt-weighted scores, 0 above the diagonal, as a
    // bf16 high part and remainder
    const float ci0 = csh[i0], ci1 = csh[i0 + 8];
    uint32_t ph[QT][4], pl[QT][4];
#pragma unroll
    for (int jt = 0; jt < QT; ++jt) {
      if (jt <= it) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = jt * 16 + nt * 8 + 2 * tq;
          const float cj0 = csh[j], cj1 = csh[j + 1], d0 = dth[j], d1 = dth[j + 1];
          const float* s = sc[jt][nt];
          split_pair(i0 >= j ? s[0] * __expf(ci0 - cj0) * d0 : 0.f,
                     i0 >= j + 1 ? s[1] * __expf(ci0 - cj1) * d1 : 0.f, ph[jt][2 * nt],
                     pl[jt][2 * nt]);
          split_pair(i0 + 8 >= j ? s[2] * __expf(ci1 - cj0) * d0 : 0.f,
                     i0 + 8 >= j + 1 ? s[3] * __expf(ci1 - cj1) * d1 : 0.f,
                     ph[jt][2 * nt + 1], pl[jt][2 * nt + 1]);
        }
      }
    }
    bf16* yrow = a.y + ((l0 + i0) * H + h) * P + 2 * tq;
    for (int cb = part; cb < ncb; cb += kSplit) {
      float acc[2][4] = {};
#pragma unroll
      for (int jt = 0; jt < QT; ++jt) {
        if (jt <= it) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(x_tile + (jt * 16 * pp + cb * 16) * 2, b0, b1, b2, b3);
          mma_bf16(acc[0], pl[jt], b0, b1);
          mma_bf16(acc[1], pl[jt], b2, b3);
          mma_bf16(acc[0], ph[jt], b0, b1);
          mma_bf16(acc[1], ph[jt], b2, b3);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        bf16* dst = yrow + cb * 16 + nt * 8;
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<uint32_t*>(dst + 8LL * H * P) = pack_bf16(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

template <int QT>
int launch(const Args& a, int B, int nc, cudaStream_t s) {
  auto kernel = ssd_tc_kernel<QT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.H / a.HB, nc, B);
  kernel<<<grid, kThreads, smem_bytes(16 * QT, a.N, a.P, a.HB), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

// The tensor-core body: x, B and C bf16 with the layouts above, Q 16, 32, 48
// or 64, N and P multiples of 16, x, B and C on 16-byte boundaries and
// bc_stride a multiple of 8; HB heads of one B/C group a block.  Returns a
// cudaError_t code (0 = launched), or -1 for arguments the body does not take.
extern "C" int repro_ssd_chunk_tc(const void* x, const void* dt, const void* a_log,
                                  const void* bm, const void* cm, long long bc_stride,
                                  void* y, void* contrib, void* decay, void* cs, int B, int L,
                                  int H, int P, int G, int N, int Q, int HB, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || HB <= 0) return -1;
  // a warp scans each head of a block: HB <= 8
  if (Q % 16 != 0 || Q > 64 || L % Q != 0 || N % 16 != 0 || P % 16 != 0 || H % G != 0 ||
      (H / G) % HB != 0 || HB > tc::kThreads / 32 || bc_stride % 8 != 0 ||
      bc_stride < (long long)G * N || L / Q > 65535 || B > 65535)
    return -1;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
       reinterpret_cast<uintptr_t>(cm)) % 16 != 0)
    return -1;
  if (tc::smem_bytes(Q, N, P, HB) > kMaxSmem) return -1;
  tc::Args a{static_cast<const tc::bf16*>(x), static_cast<const float*>(dt),
             static_cast<const float*>(a_log), static_cast<const tc::bf16*>(bm),
             static_cast<const tc::bf16*>(cm), bc_stride, static_cast<tc::bf16*>(y),
             static_cast<float*>(contrib), static_cast<float*>(decay), static_cast<float*>(cs),
             L, H, P, G, N, HB};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Q) {
    case 16: return tc::launch<1>(a, B, L / Q, s);
    case 32: return tc::launch<2>(a, B, L / Q, s);
    case 48: return tc::launch<3>(a, B, L / Q, s);
    default: return tc::launch<4>(a, B, L / Q, s);
  }
}
