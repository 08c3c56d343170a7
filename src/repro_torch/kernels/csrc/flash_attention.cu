// Flash attention with position masks, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:146 flash_attention_kernel
// (body _flash_kernel) -- the TPU kernel every layer of every ES-dLLM
// iteration calls: the active query rows (the block, or its top-k subset
// after a skip stage, or the whole sequence on a prompt refresh) attend the
// whole KV cache -- and :208 paged_flash_attention_kernel, the same body over
// a shared page pool read through a per-slot block table (the serving path).
//
// Two bodies compute the same function; the wrapper picks one from the
// arguments alone (kernels/flash_attention.py, plan()):
//
// * flash_tc_kernel, the tensor-core body: bf16, head_dim a multiple of 16
//   up to 128, or 256 (Gemma-3), every q/k/v stride and base a multiple of
//   16 bytes -- every full-width path.  What bounds it: bytes, then latency.  At the paths'
//   shapes (Lq 8-192 rows of a few heads against Lkv ~200, head_dim 128) a
//   call reads a few MB of K/V and does at most a few GFLOP, under 300 flops
//   per byte; the old body's limits were its own: each (q-head, 8 rows)
//   block re-read its KV head (up to 24x at prefill, 7x more under Dream's
//   GQA), scalar f32 FMAs with two shared loads each, one tile in flight,
//   and grids of 64 blocks on 132 SMs.  The design:
//   - one block per (batch, KV head, up to 64 packed rows, KV split); the
//     rows pack (query head of the GQA group, query row), so a K/V tile is
//     read once per KV head and row tile, whatever the group size;
//   - with few rows (MHA decode, Lq 8-32), KS = 2 or 4 warps share each
//     16-row slab, each scoring 64 / KS keys of every tile with its own
//     softmax state, merged through shared memory at the end: every warp
//     works and the grid grows to about half a wave;
//   - K/V tiles of 64 rows stay bf16 in shared memory, rows padded by 16
//     bytes so that ldmatrix is free of bank conflicts; they arrive as
//     16-byte cp.async.cg copies in a 3-stage ring (one __syncthreads a
//     stage); rows past the split, and rows of unmapped pages, are
//     zero-filled by the src-size-0 form of cp.async;
//   - mma.sync m16n8k16 (bf16 in, f32 accumulate): each warp holds its 16
//     rows of Q as A fragments for the whole walk, K and V fragments come by
//     ldmatrix (V transposed) two steps ahead of their mma, S = Q K^T lands
//     in registers, the mask is evaluated per element from q_pos and the
//     tile's kv_pos (staged in shared memory once; with no mask option it is
//     per key), the online softmax runs in the exp2 domain with quad
//     shuffles, and P goes to bf16 in registers as the A operand of P V;
//   - every division (packed row -> head and row, KV row -> page) is done
//     once per row, or is a shift for power-of-two pages: with one or two
//     warps per scheduler, instruction latency, not the tensor cores, bounds
//     a tile;
//   - split-KV on long caches: the host splits the KV rows so the grid
//     reaches half a wave, into splits of at least 8 tiles; each split
//     writes its unnormalised f32 O and its rows' (m, l) to a workspace, and
//     the last block of a (batch, KV head, row tile) to finish --
//     __threadfence, then atomicAdd on a persistent counter, which it resets
//     to 0 -- merges them by log-sum-exp and writes the output.  One launch
//     per call, no memset, no combine kernel.  The merge costs one block
//     more than walking a short split, hence the minimum.
//   Paged mode stages the split's block-table entries in shared memory once
//   (not per row) and skips tiles whose pages are all unmapped.
//   At head_dim 256 the O accumulator takes 128 registers a thread, so Q
//   stays in shared memory and each k-step loads its fragment; the ring has
//   2 stages and a block takes an SM (flash_tc.cuh, Layout::kQRes).
//
// * flash_attention_kernel, the CUDA-core body: f32 (the CPU
//   parity's type: TF32 tensor cores would miss its 1e-4), head_dim not a
//   multiple of 16 or past 128 but 256, strides that are not 16-byte
//   multiples; head_dim up to 256.  One block per (batch, q-head, 8 query
//   rows) stages the query tile and 32-row K/V tiles in shared memory as
//   f32 (rows padded by four words so the float4 reads of lane j on row j
//   are conflict-free; at head_dim 256 74,752 bytes of dynamic shared
//   memory, past the 48 KB of static arrays) and carries the online-softmax
//   state in registers.
//   Lane j scores KV row j against the warp's two rows; each lane
//   accumulates head_dim/32 output columns, in runs of 4 that lie 128
//   columns apart.  K/V move as 16-byte chunks held in registers a tile
//   ahead when the rows allow (rows of at most 512 bytes), else element by
//   element.  Paged mode looks the block table up per row; a tile with no
//   mapped page is skipped.
//
// int8 K/V (the int8 KV cache): both bodies take int8 codes with f32
// per-(token, head) scales, dense and paged, with every option and split.
// The TPU kernels do not (the reference dequantizes int8 only on its XLA
// path, src/repro/kernels/ops.py:104, :328); this is the port's own body of
// the same function, so a quantized cache is never widened in device
// memory.  The tensor-core body (flash_tc.cuh, kQ8; its instantiations in
// flash_attention_int8.cu) moves int8 tiles with the same 16-byte cp.async
// ring -- half the bytes of bf16 -- and the scales with 4-byte copies,
// widens each landed tile into one bf16 stage with integer operations
// (codes are exact in bf16) and runs the mma on codes, applying k_scale to
// score column j in f32 after Q K^T and v_scale to column j of P before P V.  The CUDA-core body
// dequantizes on load as code * scale in f32, the reference's exact math.
//
// Left for later: wgmma with TMA and a producer warp for long prefills
// (wgmma's 64-row tile does not fit Lq 8-32 per head, and these shapes are
// bound by bytes); skipping key tiles that lie wholly in future blocks of
// every row of a block-causal tile (they are walked and masked).
// Both modes take every mask option: block-causal serving and offline runs
// pass bc_start/bc_block, the sliding window reaches the kernel as kv_pos
// = -1 past the horizon and, paged, as a read table whose pages past it are
// unmapped, so whole KV splits may hold no mapped page and merge with
// weight 0.
//
// Both bodies: any strides with a contiguous last dimension are taken, so
// the cache's [B, S, Hkv, D] layout is read without a transpose copy; the
// ragged query and KV edges are masked here, so the caller pads nothing.
// Paged mode (bt != null): K/V are a pool [P, ps, Hkv, D] read in place; KV
// row r of batch b is pool row bt[b, r / ps] * ps + r % ps; a row of an
// unmapped page (bt < 0) is masked as kv_pos = -1.
//
// Mask (exactly _flash_kernel's): kv_pos < 0 is masked; causal keeps
// kv_pos <= q_pos; window > 0 keeps |q_pos - kv_pos| <= window, plus
// kv_pos < anchor when anchor > 0; bc_block > 0 is block-causal (positions
// below bc_start are block -1).  A query row with nothing valid writes 0.
#include <stdint.h>

#include <algorithm>

#include "flash_tc.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 2;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per thread block
constexpr int kBlockKV = 32;                    // KV rows per tile: one per lane
constexpr int kThreads = kWarps * 32;

// Pool row of KV row r (paged) or r itself (dense); -1 for an unmapped page.
template <bool kPaged>
__device__ __forceinline__ long long kv_row(const Params& p, const int* bt_b, int r) {
  if constexpr (kPaged) {
    const int page = bt_b[r / p.ps];
    return page < 0 ? -1 : (long long)page * p.ps + r % p.ps;
  } else {
    return r;
  }
}

// First tile start >= kv0 that holds a mapped row (every tile in dense
// mode); Lkv when none is left.  The same for every thread of a block.
template <bool kPaged>
__device__ __forceinline__ int next_tile(const Params& p, const int* bt_b, int kv0) {
  if constexpr (kPaged) {
    for (; kv0 < p.Lkv; kv0 += kBlockKV) {
      const int last = min(kv0 + kBlockKV, p.Lkv) - 1;
      for (int pg = kv0 / p.ps; pg <= last / p.ps; ++pg)
        if (bt_b[pg] >= 0) return kv0;
    }
  }
  return kv0;
}

__device__ __forceinline__ bool allowed(int qp, int kp, const Params& p) {
  bool ok = kp >= 0;
  if (p.causal) ok = ok && (kp <= qp);
  if (p.window > 0) {
    bool win = abs(qp - kp) <= p.window;
    if (p.anchor > 0) win = win || (kp < p.anchor);
    ok = ok && win;
  }
  if (p.bc_block > 0) {
    const int qb = qp >= p.bc_start ? (qp - p.bc_start) / p.bc_block : -1;
    const int kb = kp >= p.bc_start ? (kp - p.bc_start) / p.bc_block : -1;
    ok = ok && (kb <= qb);
  }
  return ok;
}

// A K/V tile as 16-byte chunks in registers, between their load from device
// memory and their store to shared memory: the next tile's loads are in
// flight while this tile's math runs.
template <typename T, int KD>
struct TileRegs {
  static constexpr int kVec = 16 / sizeof(T);                      // elements per chunk
  static constexpr int kPerRow = KD / kVec;
  static constexpr int kChunks = kBlockKV * KD / kVec / kThreads;  // per thread
  uint4 k[kChunks], v[kChunks];

  template <bool kPaged>
  __device__ __forceinline__ void load(const T* kg, const T* vg, const Params& p,
                                       const int* bt_b, int kv0, int tid) {
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int c = tid + u * kThreads, kr = kv0 + c / kPerRow, d = (c % kPerRow) * kVec;
      const long long row = kr < p.Lkv ? kv_row<kPaged>(p, bt_b, kr) : -1;
      if (row >= 0) {
        k[u] = *reinterpret_cast<const uint4*>(kg + row * p.sk.l + d);
        v[u] = *reinterpret_cast<const uint4*>(vg + row * p.sv.l + d);
      } else {
        k[u] = v[u] = make_uint4(0u, 0u, 0u, 0u);   // zero bits: 0.0 in f32 and bf16
      }
    }
  }

  __device__ __forceinline__ static void put(float* dst, const uint4& raw) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
      *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, e.x, e.y);
    }
  }

  __device__ __forceinline__ void store(float (*k_s)[KD + 4], float (*v_s)[KD + 4],
                                        int tid) const {
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int c = tid + u * kThreads, j = c / kPerRow, d = (c % kPerRow) * kVec;
      put(&k_s[j][d], k[u]);
      put(&v_s[j][d], v[u]);
    }
  }
};

// KD: head_dim rounded up to 32, 64, 128 or 256 (tiles are zero-padded to it).
// kVec: head_dim == KD, rows of at most 512 bytes, and every K/V row starts
// 16-byte aligned, so K/V move as 16-byte chunks, prefetched a tile ahead;
// else element by element.
// kPaged: K/V rows come from a page pool through the block table p.bt.
// KT: the K/V element, T or int8_t (codes, dequantized on load as code *
// scale in f32; element by element).
// The shared tiles, in floats: the query tile, then the K and V tiles.
// Static up to KD 128 (37,888 bytes); dynamic past the 48 KB of static
// shared memory (74,752 bytes at KD 256).
template <int KD>
struct CcTiles {
  static constexpr int kBytes = (kBlockQ * KD + 2 * kBlockKV * (KD + 4)) * 4;
  static constexpr bool kDynamic = kBytes > 48 * 1024;
};

template <typename T, typename KT, int KD, bool kVec, bool kPaged>
__global__ void __launch_bounds__(kThreads, KD > 128 ? 2 : 4) flash_attention_kernel(Params p) {
  constexpr bool kQ8 = sizeof(KT) == 1;
  static_assert(!(kQ8 && kVec), "int8 K/V load element by element");
  constexpr int kDPL = KD / 32;                      // output columns per lane
  constexpr int kStride = KD + 4;                    // K/V row pitch in floats
  // a float4 read of row `lane` covers banks 4*lane..4*lane+3 (mod 32): the
  // 8 lanes of each quarter-warp hit distinct banks, so no conflicts
  // (three static arrays, not one carved up: the carved one cost the f32
  // KD-128 body 20 more bytes of spills)
  float(*q_s)[KD];
  float(*k_s)[kStride];
  float(*v_s)[kStride];
  if constexpr (CcTiles<KD>::kDynamic) {
    extern __shared__ __align__(16) float cc_smem[];
    q_s = reinterpret_cast<float(*)[KD]>(cc_smem);
    k_s = reinterpret_cast<float(*)[kStride]>(cc_smem + kBlockQ * KD);
    v_s = k_s + kBlockKV;
  } else {
    __shared__ __align__(16) float q_arr[kBlockQ][KD];
    __shared__ __align__(16) float k_arr[kBlockKV][kStride];
    __shared__ __align__(16) float v_arr[kBlockKV][kStride];
    q_s = q_arr;
    k_s = k_arr;
    v_s = v_arr;
  }
  __shared__ int kvpos_s[kBlockKV];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int kvh = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = p.D;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const long long kb = kPaged ? 0 : b * p.sk.b, vb = kPaged ? 0 : b * p.sv.b;
  const KT* kg = static_cast<const KT*>(p.k) + kb + kvh * p.sk.h;
  const KT* vg = static_cast<const KT*>(p.v) + vb + kvh * p.sv.h;
  const float* ksg = kQ8 ? p.ks + (kPaged ? 0 : b * p.sks.b) + kvh * p.sks.h : nullptr;
  const float* vsg = kQ8 ? p.vs + (kPaged ? 0 : b * p.svs.b) + kvh * p.svs.h : nullptr;
  const int* kvpos_g = p.kv_pos + (long long)b * p.Lkv;
  const int* bt_b = kPaged ? p.bt + (long long)b * (p.Lkv / p.ps) : nullptr;

#pragma unroll
  for (int i = tid; i < kBlockQ * KD; i += kThreads) {
    const int r = i / KD, d = i % KD, qr = q0 + r;
    q_s[r][d] = (qr < p.Lq && d < D) ? to_f32(qg[qr * p.sq.l + d]) : 0.f;
  }

  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qr = q0 + warp * kRowsPerWarp + r;
    qpos[r] = qr < p.Lq ? p.q_pos[(long long)b * p.Lq + qr] : 0;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  TileRegs<T, KD> regs;     // kVec only
  int kv0 = next_tile<kPaged>(p, bt_b, 0);
  if constexpr (kVec) {
    if (kv0 < p.Lkv) regs.template load<kPaged>(kg, vg, p, bt_b, kv0, tid);
  }

  while (kv0 < p.Lkv) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    if constexpr (kVec) {
      regs.store(k_s, v_s, tid);
    } else {
      // a fully unrolled copy: every load of the tile can be in flight at once
#pragma unroll
      for (int i = tid; i < kBlockKV * KD; i += kThreads) {
        const int j = i / KD, d = i % KD, kr = kv0 + j;
        const long long row = kr < p.Lkv && d < D ? kv_row<kPaged>(p, bt_b, kr) : -1;
        float kx = row >= 0 ? to_f32(kg[row * p.sk.l + d]) : 0.f;
        float vx = row >= 0 ? to_f32(vg[row * p.sv.l + d]) : 0.f;
        if constexpr (kQ8) {
          if (row >= 0) {
            kx *= ksg[row * p.sks.l];
            vx *= vsg[row * p.svs.l];
          }
        }
        k_s[j][d] = kx;
        v_s[j][d] = vx;
      }
    }
    if (tid < kBlockKV) {
      const int kr = kv0 + tid;
      kvpos_s[tid] = kr < p.Lkv && kv_row<kPaged>(p, bt_b, kr) >= 0 ? kvpos_g[kr] : -1;
    }
    __syncthreads();
    const int kv_next = next_tile<kPaged>(p, bt_b, kv0 + kBlockKV);
    if constexpr (kVec) {
      if (kv_next < p.Lkv) regs.template load<kPaged>(kg, vg, p, bt_b, kv_next, tid);
    }

    // scores: lane j scores KV row j against the warp's query rows; one
    // float4 of K serves every row
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < KD; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(&k_s[lane][d]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(&q_s[warp * kRowsPerWarp + r][d]);
        s[r] = fmaf(q4.x, k4.x, fmaf(q4.y, k4.y, fmaf(q4.z, k4.z, fmaf(q4.w, k4.w, s[r]))));
      }
    }
    const int kp = kvpos_s[lane];
    float pj[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool ok = allowed(qpos[r], kp, p);
      const float sr = ok ? s[r] * p.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      pj[r] = ok ? expf(sr - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(pj[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[r][i] *= corr;
    }
    // P @ V: lane owns kDPL columns, consecutive up to 4, else runs of 4
    // columns 128 apart (col_of); one V read serves every row
#pragma unroll 4
    for (int j = 0; j < kBlockKV; ++j) {
      float vv[kDPL];
      if constexpr (kDPL >= 4) {
#pragma unroll
        for (int c = 0; c < kDPL / 4; ++c) {
          const float4 v4 = *reinterpret_cast<const float4*>(&v_s[j][c * 128 + lane * 4]);
          vv[4 * c] = v4.x, vv[4 * c + 1] = v4.y, vv[4 * c + 2] = v4.z, vv[4 * c + 3] = v4.w;
        }
      } else if constexpr (kDPL == 2) {
        const float2 v2 = *reinterpret_cast<const float2*>(&v_s[j][lane * 2]);
        vv[0] = v2.x, vv[1] = v2.y;
      } else {
        vv[0] = v_s[j][lane];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pb = __shfl_sync(kFullMask, pj[r], j);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[r][i] = fmaf(pb, vv[i], acc[r][i]);
      }
    }
    kv0 = kv_next;
  }

  T* og = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qr = q0 + warp * kRowsPerWarp + r;
    if (qr >= p.Lq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = kDPL >= 4 ? (i / 4) * 128 + lane * 4 + i % 4 : lane * kDPL + i;
      if (d < D) og[qr * p.so.l + d] = from_f32<T>(acc[r][i] * inv);
    }
  }
}

// One instantiation's launch, with its dynamic shared memory where it has
// any (allowed past 48 KB once, at first use).
template <typename T, typename KT, int KD, bool kVec, bool kPaged>
cudaError_t launch_one(const Params& p, dim3 grid, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, KT, KD, kVec, kPaged>;
  constexpr int kBytes = CcTiles<KD>::kDynamic ? CcTiles<KD>::kBytes : 0;
  if constexpr (kBytes > 0) {
    static const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (attr != cudaSuccess) return attr;
  }
  kernel<<<grid, kThreads, kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int KD, bool kPaged>
cudaError_t launch_kd(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Lq + kBlockQ - 1) / kBlockQ, p.Hq, p.B);
  if (p.ks != nullptr) return launch_one<T, int8_t, KD, false, kPaged>(p, grid, stream);
  // the prefetch holds a tile in registers: 128 a thread for an f32 tile at
  // KD 256, which spills, so rows past 512 bytes load element by element
  constexpr long long kVecElems = 16 / sizeof(T);
  constexpr bool kFits = KD * sizeof(T) <= 512;
  const bool vec = kFits && p.D == KD && reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.v) % 16 == 0 &&
                   (p.sk.b | p.sk.h | p.sk.l | p.sv.b | p.sv.h | p.sv.l) % kVecElems == 0;
  if constexpr (kFits) {
    if (vec) return launch_one<T, T, KD, true, kPaged>(p, grid, stream);
  }
  return launch_one<T, T, KD, false, kPaged>(p, grid, stream);
}

template <typename T, int KD>
cudaError_t launch_paged(const Params& p, cudaStream_t stream) {
  if (p.bt != nullptr) return launch_kd<T, KD, true>(p, stream);
  return launch_kd<T, KD, false>(p, stream);
}

// The smallest instantiation that holds head_dim (fill_params refuses more
// than 256).
template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch_paged<T, 32>(p, stream);
  if (p.D <= 64) return launch_paged<T, 64>(p, stream);
  if (p.D <= 128) return launch_paged<T, 128>(p, stream);
  if (p.D <= 256) return launch_paged<T, 256>(p, stream);
  return cudaErrorInvalidValue;
}


// Fills the fields both bodies share; false for arguments neither takes.
bool fill_params(Params& p, const void* q, const void* k, const void* v, void* out,
                 const void* q_pos, const void* kv_pos, const void* block_tables,
                 const void* k_scale, const void* v_scale, int page_size,
                 const long long* strides, int B, int Hq, int Hkv, int Lq, int Lkv, int D,
                 float scale, int window, int anchor, int causal, int bc_start, int bc_block) {
  if (B <= 0 || Lq <= 0 || Lkv < 0 || D <= 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535)
    return false;
  if (block_tables != nullptr && (page_size <= 0 || Lkv % page_size != 0)) return false;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return false;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.bt = static_cast<const int*>(block_tables);
  p.ps = page_size;
  p.sq = {strides[0], strides[1], strides[2]};
  p.sk = {strides[3], strides[4], strides[5]};
  p.sv = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.sks = {strides[12], strides[13], strides[14]};
  p.svs = {strides[15], strides[16], strides[17]};
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Lq = Lq;
  p.Lkv = Lkv;
  p.D = D;
  p.scale = scale;
  p.window = window;
  p.anchor = anchor;
  p.causal = causal;
  p.bc_start = bc_start;
  p.bc_block = bc_block;
  return true;
}

}  // namespace
}  // namespace repro_torch

// strides: 18 element strides, (b, h, l) of q, k, v, out, k_scale and
// v_scale in that order (the last six unread without scales).
// block_tables: null (k, v are [B, Lkv, Hkv, D]-like caches) or [B, Lkv /
// page_size] int32 (k, v are [P, page_size, Hkv, D] pools; the k and v
// "b" strides are then unused and "l" steps one pool row).  k_scale,
// v_scale: null (k, v are of q's dtype), or f32 scales of int8 codes k, v,
// [B, Hkv, Lkv]-strided ([P, page_size, Hkv] pools when paged).
// Returns a cudaError_t code (0 = launched), or -1 for arguments the kernel
// does not take.  The CUDA-core body.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, const void* q_pos, const void* kv_pos,
                                     const void* block_tables, const void* k_scale,
                                     const void* v_scale, int page_size,
                                     const long long* strides, int B, int Hq, int Hkv,
                                     int Lq, int Lkv, int D, float scale, int window,
                                     int anchor, int causal, int bc_start, int bc_block,
                                     void* stream) {
  using namespace repro_torch;
  Params p;
  if (!fill_params(p, q, k, v, out, q_pos, kv_pos, block_tables, k_scale, v_scale, page_size,
                   strides, B, Hq, Hkv, Lq, Lkv, D, scale, window, anchor, causal, bc_start,
                   bc_block))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch<float>(p, s));
  if (dtype == kBF16) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return -1;
}

// The tensor-core body, bf16 q with bf16 or int8 K/V; arguments as
// repro_flash_attention's,
// plus the plan: ks warps share each 16-row slab (1, 2 or 4; a block holds
// 64 / ks packed rows), and n_splits splits of split_tiles 64-row KV tiles
// each (the last may be ragged; none may be empty).  With n_splits > 1,
// part_o holds [B * Hkv * row_tiles * n_splits * 64 * D] floats, part_ml
// twice [... * 64], and counters [B * Hkv * row_tiles] int32 zeros, which
// the kernel leaves zero; row_tiles = ceil(Hq / Hkv * Lq * ks / 64).
extern "C" int repro_flash_attention_tc(const void* q, const void* k, const void* v,
                                        void* out, const void* q_pos, const void* kv_pos,
                                        const void* block_tables, const void* k_scale,
                                        const void* v_scale, int page_size,
                                        const long long* strides, int B, int Hq, int Hkv,
                                        int Lq, int Lkv, int D, float scale, int window,
                                        int anchor, int causal, int bc_start, int bc_block,
                                        int ks, int n_splits, int split_tiles, void* part_o,
                                        void* part_ml, void* counters, void* stream) {
  using namespace repro_torch;
  using namespace repro_torch::tc;
  tc::TcParams tp;
  if (!fill_params(tp.a, q, k, v, out, q_pos, kv_pos, block_tables, k_scale, v_scale,
                   page_size, strides, B, Hq, Hkv, Lq, Lkv, D, scale, window, anchor, causal,
                   bc_start, bc_block))
    return -1;
  if (D % 16 != 0 || (D > 128 && D != 256) || (ks != 1 && ks != 2 && ks != 4)) return -1;
  // 16-byte rows and bases for cp.async (q: 8 bf16, int8 K/V: 16 codes);
  // the output takes 8-byte stores, the scales 4-byte copies
  const bool q8 = k_scale != nullptr;
  for (const void* ptr : {q, k, v})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return -1;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % (i >= 3 && q8 ? 16 : 8) != 0) return -1;
  if (q8 && (reinterpret_cast<uintptr_t>(k_scale) | reinterpret_cast<uintptr_t>(v_scale)) % 4)
    return -1;
  if (reinterpret_cast<uintptr_t>(out) % 8 != 0) return -1;
  for (int i = 9; i < 12; ++i)
    if (strides[i] % 4 != 0) return -1;
  const int n_tiles = (Lkv + kTile - 1) / kTile;
  if (split_tiles < 1 || n_splits < 1 || n_splits > kMaxSplits ||
      n_splits != std::max(1, (n_tiles + split_tiles - 1) / split_tiles))
    return -1;
  if (n_splits > 1 && (part_o == nullptr || part_ml == nullptr || counters == nullptr))
    return -1;
  if (block_tables != nullptr &&
      (static_cast<long long>(split_tiles) * kTile + page_size - 1) / page_size + 1 >
          kMaxSplitPages)
    return -1;
  const int block_rows = kRows / ks;
  const long long row_tiles = (static_cast<long long>(Hq / Hkv) * Lq + block_rows - 1) / block_rows;
  if (row_tiles > 65535 || static_cast<long long>(B) * Hkv > 65535) return -1;
  tp.part_o = static_cast<float*>(part_o);
  tp.part_ml = static_cast<float*>(part_ml);
  tp.counters = static_cast<int*>(counters);
  tp.n_splits = n_splits;
  tp.split_tiles = split_tiles;
  tp.group = Hq / Hkv;
  tp.ps_shift = -1;
  if (block_tables != nullptr && (page_size & (page_size - 1)) == 0)
    tp.ps_shift = __builtin_ctz(static_cast<unsigned>(page_size));
  tp.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid(n_splits, static_cast<unsigned>(row_tiles), B * Hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q8) return static_cast<int>(tc::launch_int8(tp, ks, grid, s));
  if (block_tables != nullptr) return static_cast<int>(tc::launch<true, false>(tp, ks, grid, s));
  return static_cast<int>(tc::launch<false, false>(tp, ks, grid, s));
}
