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
//   up to 128, every q/k/v stride and base a multiple of 16 bytes -- every
//   full-width path.  What bounds it: bytes, then latency.  At the paths'
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
//
// * flash_attention_kernel, the CUDA-core body: f32 (the CPU
//   parity's type: TF32 tensor cores would miss its 1e-4), head_dim not a
//   multiple of 16, strides that are not 16-byte multiples.  One block per
//   (batch, q-head, 8 query rows) stages the query tile and 32-row K/V tiles
//   in shared memory as f32 (rows padded by four words so the float4 reads of
//   lane j on row j are conflict-free) and carries the online-softmax state
//   in registers.  Lane j scores KV row j against the warp's two rows; each
//   lane accumulates head_dim/32 output columns.  K/V move as 16-byte chunks
//   held in registers a tile ahead when the rows allow, else element by
//   element.  Paged mode looks the block table up per row; a tile with no
//   mapped page is skipped.
//
// Left for later: wgmma with TMA and a producer warp for long prefills
// (wgmma's 64-row tile does not fit Lq 8-32 per head, and these shapes are
// bound by bytes); int8 K/V; skipping key tiles that lie wholly in future
// blocks of every row of a block-causal tile (they are walked and masked).
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

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 2;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per thread block
constexpr int kBlockKV = 32;                    // KV rows per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, l;  // element strides of dims 0, 1, 2; dim 3 is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos;   // [B, Lq]
  const int* kv_pos;  // [B, Lkv]
  const int* bt;      // [B, Lkv / ps] page table (paged mode), else null
  Strides sq, sk, sv, so;  // paged: sk.l / sv.l step one pool row, sk.b unused
  int B, Hq, Hkv, Lq, Lkv, D, ps;
  float scale;
  int window, anchor, causal, bc_start, bc_block;
};

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

// KD: head_dim rounded up to 32, 64 or 128 (tiles are zero-padded to it).
// kVec: head_dim == KD and every K/V row starts 16-byte aligned, so K/V move
// as 16-byte chunks, prefetched a tile ahead; else element by element.
// kPaged: K/V rows come from a page pool through the block table p.bt.
template <typename T, int KD, bool kVec, bool kPaged>
__global__ void __launch_bounds__(kThreads, 4) flash_attention_kernel(Params p) {
  constexpr int kDPL = KD / 32;                      // output columns per lane
  constexpr int kStride = KD + 4;                    // K/V row pitch in floats
  // a float4 read of row `lane` covers banks 4*lane..4*lane+3 (mod 32): the
  // 8 lanes of each quarter-warp hit distinct banks, so no conflicts
  __shared__ __align__(16) float q_s[kBlockQ][KD];
  __shared__ __align__(16) float k_s[kBlockKV][kStride];
  __shared__ __align__(16) float v_s[kBlockKV][kStride];
  __shared__ int kvpos_s[kBlockKV];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int kvh = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = p.D;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const long long kb = kPaged ? 0 : b * p.sk.b, vb = kPaged ? 0 : b * p.sv.b;
  const T* kg = static_cast<const T*>(p.k) + kb + kvh * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + vb + kvh * p.sv.h;
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

  TileRegs<T, KD> regs;
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
        k_s[j][d] = row >= 0 ? to_f32(kg[row * p.sk.l + d]) : 0.f;
        v_s[j][d] = row >= 0 ? to_f32(vg[row * p.sv.l + d]) : 0.f;
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
    // P @ V: lane owns kDPL consecutive columns; one V read serves every row
#pragma unroll 4
    for (int j = 0; j < kBlockKV; ++j) {
      float vv[kDPL];
      if constexpr (kDPL == 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&v_s[j][lane * 4]);
        vv[0] = v4.x, vv[1] = v4.y, vv[2] = v4.z, vv[3] = v4.w;
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
      const int d = lane * kDPL + i;
      if (d < D) og[qr * p.so.l + d] = from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int KD, bool kPaged>
void launch_kd(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Lq + kBlockQ - 1) / kBlockQ, p.Hq, p.B);
  constexpr long long kVecElems = 16 / sizeof(T);
  const bool vec = p.D == KD && reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.v) % 16 == 0 &&
                   (p.sk.b | p.sk.h | p.sk.l | p.sv.b | p.sv.h | p.sv.l) % kVecElems == 0;
  if (vec) {
    flash_attention_kernel<T, KD, true, kPaged><<<grid, kThreads, 0, stream>>>(p);
  } else {
    flash_attention_kernel<T, KD, false, kPaged><<<grid, kThreads, 0, stream>>>(p);
  }
}

template <typename T, int KD>
void launch_paged(const Params& p, cudaStream_t stream) {
  if (p.bt != nullptr) {
    launch_kd<T, KD, true>(p, stream);
  } else {
    launch_kd<T, KD, false>(p, stream);
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) {
    launch_paged<T, 32>(p, stream);
  } else if (p.D <= 64) {
    launch_paged<T, 64>(p, stream);
  } else {
    launch_paged<T, 128>(p, stream);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRows = 64;        // packed query rows per block at most: 4 warps x 16
constexpr int kTile = 64;        // KV rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;       // K/V ring depth
constexpr int kMaxSplits = 32;
constexpr int kMaxSplitPages = 1024;   // block-table entries of one split

struct TcParams {
  Params a;
  float* part_o;    // [work, n_splits, kRows, D] f32 unnormalised outputs (n_splits > 1)
  float* part_ml;   // [work, n_splits, kRows, 2] their rows' (max, sum), exp2 domain
  int* counters;    // [work] splits finished; 0 between launches
  int n_splits, split_tiles, group;
  int ps_shift;     // log2(page size) when it is a power of two, else -1
  float scale_log2;
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

template <int D>
struct Layout {
  // a shared row is D bf16 + 16 bytes: the 8 rows of an ldmatrix phase then
  // start on 8 distinct 16-byte bank groups
  static constexpr int kPitch = D + 8;
  static constexpr int kTileElems = kTile * kPitch;
  static constexpr int kStageElems = 2 * kTileElems;     // K, then V
  static constexpr int kBytes = kStages * kStageElems * 2;
  static_assert(kRows == kTile, "the Q tile borrows a K tile's room");
  static_assert(kRows * kMaxSplits * 8 <= kBytes, "the merge's (m, l) reuse the ring");
};

// One block: split blockIdx.x of KV head blockIdx.z % Hkv of batch
// blockIdx.z / Hkv, packed rows [64 / KS * blockIdx.y, +64 / KS).  Packed row
// r is query head kvh * group + r / Lq, query row r % Lq.  KS warps share
// each 16-row slab, each scoring 64 / KS keys of every tile with its own
// softmax state, merged at the end: with few rows (MHA at Lq 8 to 32) every
// warp of the block still has work.
template <int D, int KS, bool kPaged>
__global__ void __launch_bounds__(kThreads, 2) flash_tc_kernel(TcParams tp) {
  using L = Layout<D>;
  constexpr int kSlabs = kWarps / KS;       // 16-row slabs of packed rows
  constexpr int kBlockRows = 16 * kSlabs;
  constexpr int kKeys = kTile / KS;         // keys of a tile each warp scores
  static_assert((KS - 1) * kSlabs * (D / 2 + 4) * 32 * 4 <= L::kBytes,
                "the key-split states reuse the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int kvpos_s[kStages][kTile];
  __shared__ unsigned char valid_s[kStages][kTile];   // row inside the split and mapped
  __shared__ int pt_s[kPaged ? kMaxSplitPages : 1];    // the split's block-table entries
  __shared__ long long qoff_s[kRows], ooff_s[kRows];   // packed row -> q / out offset
  __shared__ int last_s;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const Params& p = tp.a;
  const int split = blockIdx.x, rt = blockIdx.y;
  const int b = blockIdx.z / p.Hkv, kvh = blockIdx.z % p.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;      // the fragments' row in 8, column pair
  const int n_rows = tp.group * p.Lq, row0 = rt * kBlockRows;
  const int kv_begin = split * tp.split_tiles * kTile;
  const int kv_end = min(kv_begin + tp.split_tiles * kTile, p.Lkv);
  const int pg0 = kPaged ? kv_begin / p.ps : 0;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq.b;
  const long long kb = kPaged ? 0 : b * p.sk.b, vb = kPaged ? 0 : b * p.sv.b;
  const bf16* kg = static_cast<const bf16*>(p.k) + kb + kvh * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + vb + kvh * p.sv.h;
  const int* kvpos_g = p.kv_pos + (long long)b * p.Lkv;

  // virtual page of KV row kk and the row inside it: a shift and a mask
  // for the power-of-two page sizes of the path
  auto vpage = [&](int kk) { return tp.ps_shift >= 0 ? kk >> tp.ps_shift : kk / p.ps; };
  auto in_page = [&](int kk) { return tp.ps_shift >= 0 ? kk & (p.ps - 1) : kk % p.ps; };
  auto bc_block_of = [&](int pos) {       // block-causal block; positions below bc_start: -1
    return pos >= p.bc_start ? (pos - p.bc_start) / p.bc_block : -1;
  };
  if (tid < kRows) {           // one division per packed row, here and nowhere else
    const int pr = row0 + tid;
    const int h = kvh * tp.group + pr / p.Lq, qi = pr % p.Lq;
    qoff_s[tid] = pr < n_rows && tid < kBlockRows ? h * p.sq.h + qi * p.sq.l : -1;
    ooff_s[tid] = h * p.so.h + qi * p.so.l;
  }
  if constexpr (kPaged) {
    if (kv_end > kv_begin) {
      const int* bt_b = p.bt + (long long)b * (p.Lkv / p.ps);
      const int n_pg = vpage(kv_end - 1) - pg0 + 1;
      for (int i = tid; i < n_pg; i += kThreads) pt_s[i] = bt_b[pg0 + i];
    }
  }
  __syncthreads();
  // page of KV row kk (paged; < 0 when unmapped), 0 in dense mode
  auto page_of = [&](int kk) -> int {
    if constexpr (kPaged) return pt_s[vpage(kk) - pg0];
    return 0;
  };
  // first tile start >= kv0 holding a mapped page (every tile in dense mode);
  // the same for every thread of the block
  auto next_tile = [&](int kv0) -> int {
    if constexpr (kPaged) {
      for (; kv0 < kv_end; kv0 += kTile) {
        const int last = min(kv0 + kTile, kv_end) - 1;
        for (int pg = vpage(kv0); pg <= vpage(last); ++pg)
          if (pt_s[pg - pg0] >= 0) return kv0;
      }
    }
    return kv0;
  };

  // Q: the block's packed rows, into the last stage's K room (free until the
  // walk's first refill); rows past the packed rows are zeros
  bf16* q_s = ring + (kStages - 1) * L::kStageElems;
  {
    constexpr int kPerRow = D / 8;
    for (int c = tid; c < kBlockRows * kPerRow; c += kThreads) {
      const int r = c / kPerRow, cc = c % kPerRow;
      const long long off = qoff_s[r];
      cp_async16(smem_u32(q_s + r * L::kPitch + cc * 8), qg + (off < 0 ? 0 : off) + cc * 8,
                 off >= 0);
    }
    cp_async_commit();
  }

  // the K/V tile at kv0 into ring stage st, with its kv_pos and row validity
  auto load_tile = [&](int kv0, int st) {
    bf16* kd = ring + st * L::kStageElems;
    bf16* vd = kd + L::kTileElems;
    constexpr int kPerRow = D / 8;
#pragma unroll
    for (int c = tid; c < kTile * kPerRow; c += kThreads) {
      const int r = c / kPerRow, cc = c % kPerRow, kk = kv0 + r;
      bool ok = kk < kv_end;
      long long row = kk;
      if constexpr (kPaged) {
        const int page = ok ? page_of(kk) : -1;
        ok = page >= 0;
        row = (long long)page * p.ps + in_page(kk);
      }
      const long long ko = ok ? row * p.sk.l + cc * 8 : 0, vo = ok ? row * p.sv.l + cc * 8 : 0;
      cp_async16(smem_u32(kd + r * L::kPitch + cc * 8), kg + ko, ok);
      cp_async16(smem_u32(vd + r * L::kPitch + cc * 8), vg + vo, ok);
    }
    if (tid < kTile) {
      const int kk = kv0 + tid;
      const bool in = kk < kv_end;
      cp_async4(smem_u32(&kvpos_s[st][tid]), kvpos_g + (in ? kk : 0), in);
      valid_s[st][tid] = in && page_of(kk) >= 0;
    }
  };

  int fetch = next_tile(kv_begin), comp = fetch;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (fetch < kv_end) {
      load_tile(fetch, st);
      fetch = next_tile(fetch + kTile);
    }
    cp_async_commit();
  }

  // this warp's slab of 16 packed rows (the thread holds rows grp and grp + 8
  // of them) and its share kq of each tile's keys
  const int slab = warp % kSlabs, kq = warp / kSlabs;
  const int wrow = row0 + slab * 16;
  const bool warp_active = wrow < n_rows;
  int qpos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int pr = wrow + grp + hf * 8;
    qpos[hf] = pr < n_rows ? p.q_pos[(long long)b * p.Lq + pr % p.Lq] : 0;
  }

  // the mask rule split into a per-row and a per-key half (no division per
  // element); with no option set only kv_pos >= 0 is tested.  Block-causal
  // is a per-row bound: a key's block is at most the row's block qb exactly
  // when kv_pos < bc_start + (qb + 1) * bc_block (prompt keys are block -1,
  // a prompt row's bound is bc_start), so no key's block is computed
  const bool plain = !p.causal && p.window <= 0 && p.bc_block <= 0;
  int qlim[2] = {0x7fffffff, 0x7fffffff};
  if (p.bc_block > 0) {
    qlim[0] = p.bc_start + (bc_block_of(qpos[0]) + 1) * p.bc_block;
    qlim[1] = p.bc_start + (bc_block_of(qpos[1]) + 1) * p.bc_block;
  }

  cp_async_wait<kStages - 1>();      // the Q group has landed
  __syncthreads();
  uint32_t qf[D / 16][4];            // Q as A fragments, held for the whole walk
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int r = slab * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, c = kd * 16 + (lane >> 4) * 8;
    ldsm_x4(smem_u32(q_s + r * L::kPitch + c), qf[kd][0], qf[kd][1], qf[kd][2], qf[kd][3]);
  }

  float acc[D / 8][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int st = 0;
  while (comp < kv_end) {
    cp_async_wait<kStages - 2>();    // this thread's copies of stage st have landed
    __syncthreads();                 // everyone's have; the stage refilled next is consumed
    if (fetch < kv_end) {
      load_tile(fetch, (st + kStages - 1) % kStages);
      fetch = next_tile(fetch + kTile);
    }
    cp_async_commit();

    if (warp_active) {
      const bf16* ks = ring + st * L::kStageElems;
      const bf16* vs = ks + L::kTileElems;
      // this thread's 16 key columns: kv_pos, or -1 past the split or unmapped
      int kp[kKeys / 8][2];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = kq * kKeys + j * 8 + tig * 2 + e;
          kp[j][e] = valid_s[st][c] ? kvpos_s[st][c] : -1;
        }
      // S = Q K^T: 16 rows x kKeys keys as n-tiles of 8 keys.  Step t loads
      // the B fragments of k-step t / kPairs, n-tiles 2 (t % kPairs) and
      // 2 (t % kPairs) + 1 with one ldmatrix.x4, two steps ahead of their mma
      constexpr int kPairs = kKeys / 16, kSSteps = (D / 16) * kPairs;
      auto k_addr = [&](int t) {
        const int r = kq * kKeys + (t % kPairs) * 16 + (lane >> 4) * 8 + (lane & 7);
        const int c = (t / kPairs) * 16 + ((lane >> 3) & 1) * 8;
        return smem_u32(ks + r * L::kPitch + c);
      };
      float s[kKeys / 8][4];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      uint32_t fb[3][4];
#pragma unroll
      for (int t = 0; t < 2 && t < kSSteps; ++t)
        ldsm_x4(k_addr(t), fb[t][0], fb[t][1], fb[t][2], fb[t][3]);
#pragma unroll
      for (int t = 0; t < kSSteps; ++t) {
        if (t + 2 < kSSteps) {
          uint32_t(&f)[4] = fb[(t + 2) % 3];
          ldsm_x4(k_addr(t + 2), f[0], f[1], f[2], f[3]);
        }
        const int j = (t % kPairs) * 2;
        mma_bf16(s[j], qf[t / kPairs], fb[t % 3][0], fb[t % 3][1]);
        mma_bf16(s[j + 1], qf[t / kPairs], fb[t % 3][2], fb[t % 3][3]);
      }
      // the mask per element, then the online softmax in the exp2 domain;
      // both row halves go through each stage together
      if (plain) {                   // the paths' case: the mask is per key
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s[j][i] = kp[j][i % 2] >= 0 ? s[j][i] * tp.scale_log2 : kNegInf;
      } else {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qp = qpos[i / 2], kpos = kp[j][i % 2];
            bool ok = kpos >= 0 && (!p.causal || kpos <= qp) && kpos < qlim[i / 2];
            if (p.window > 0) ok = ok && (abs(qp - kpos) <= p.window || kpos < p.anchor);
            s[j][i] = ok ? s[j][i] * tp.scale_log2 : kNegInf;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], s[j][i]);
#pragma unroll
      for (int o = 1; o <= 2; o *= 2)       // the four lanes of a quad share a row
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFullMask, mx[hf], o));
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        corr[hf] = exp2f(m[hf] - mx[hf]);
        m[hf] = mx[hf];
      }
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float& x = s[j][i];
          x = x == kNegInf ? 0.f : exp2f(x - mx[i / 2]);
          sum[i / 2] += x;
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * corr[hf] + sum[hf];   // quad-summed at the end
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= corr[e / 2];
      // O += P V in k-steps of 16 keys: the C fragments of n-tiles 2kk and
      // 2kk + 1, rounded to bf16, are the A fragment of k-step kk.  Step t
      // loads V's B fragments of k-step t / (D / 16), d-tiles 2 dp and
      // 2 dp + 1 (dp = t % (D / 16)), transposed, two steps ahead
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      constexpr int kDp = D / 16, kVSteps = (kKeys / 16) * kDp;
      auto v_addr = [&](int t) {
        const int r = kq * kKeys + (t / kDp) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int c = (t % kDp) * 16 + (lane >> 4) * 8;
        return smem_u32(vs + r * L::kPitch + c);
      };
#pragma unroll
      for (int t = 0; t < 2 && t < kVSteps; ++t)
        ldsm_x4_trans(v_addr(t), fb[t][0], fb[t][1], fb[t][2], fb[t][3]);
#pragma unroll
      for (int t = 0; t < kVSteps; ++t) {
        if (t + 2 < kVSteps) {
          uint32_t(&f)[4] = fb[(t + 2) % 3];
          ldsm_x4_trans(v_addr(t + 2), f[0], f[1], f[2], f[3]);
        }
        const int dp = t % kDp;
        mma_bf16(acc[2 * dp], pa[t / kDp], fb[t % 3][0], fb[t % 3][1]);
        mma_bf16(acc[2 * dp + 1], pa[t / kDp], fb[t % 3][2], fb[t % 3][3]);
      }
    }
    comp = next_tile(comp + kTile);
    st = (st + 1) % kStages;
  }
  cp_async_wait<0>();

  if constexpr (KS > 1) {
    // the slab's KS key shares merge into warp kq = 0: the others leave their
    // (m, l, acc) in the ring, each register at [share][slab][register][lane]
    constexpr int kRegs = D / 2 + 4;
    float* xs = reinterpret_cast<float*>(smem_raw);
    __syncthreads();                 // every warp is done with the ring
    if (warp_active && kq > 0) {
      float* x = xs + ((kq - 1) * kSlabs + slab) * kRegs * 32 + lane;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(i * 4 + e) * 32] = acc[i][e];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        x[(D / 2 + hf) * 32] = m[hf];
        x[(D / 2 + 2 + hf) * 32] = l[hf];
      }
    }
    __syncthreads();
    if (warp_active && kq == 0) {
#pragma unroll
      for (int k = 1; k < KS; ++k) {
        const float* x = xs + ((k - 1) * kSlabs + slab) * kRegs * 32 + lane;
        float wa[2], wb[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float mk = x[(D / 2 + hf) * 32], mx = fmaxf(m[hf], mk);
          wa[hf] = exp2f(m[hf] - mx);
          wb[hf] = exp2f(mk - mx);
          m[hf] = mx;
          l[hf] = l[hf] * wa[hf] + x[(D / 2 + 2 + hf) * 32] * wb[hf];
        }
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][e] = acc[i][e] * wa[e / 2] + x[(i * 4 + e) * 32] * wb[e / 2];
      }
    }
  }
  const bool writer = warp_active && kq == 0;   // holds the slab's merged state

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(kFullMask, l[hf], 1);
    l[hf] += __shfl_xor_sync(kFullMask, l[hf], 2);
  }
  bf16* og = static_cast<bf16*>(p.o) + b * p.so.b;
  auto out_row = [&](int r) -> bf16* { return og + ooff_s[r]; };   // block-local row r

  if (tp.n_splits == 1) {
    if (!writer) return;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int pr = wrow + grp + hf * 8;
      if (pr >= n_rows) continue;
      const float inv = l[hf] > 0.f ? 1.f / l[hf] : 0.f;   // nothing valid: 0
      bf16* orow = out_row(pr - row0);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + i * 8 + tig * 2) =
            pack_bf16(acc[i][hf * 2] * inv, acc[i][hf * 2 + 1] * inv);
    }
    return;
  }

  // split-KV: this split's partials out; the last block of the (batch, KV
  // head, row tile) to finish merges every split's
  const long long work = (long long)blockIdx.z * gridDim.y + rt;
  const long long part0 = work * tp.n_splits;
  if (writer) {
    float* po = tp.part_o + (part0 + split) * kRows * D;
    float* pml = tp.part_ml + (part0 + split) * kRows * 2;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = slab * 16 + grp + hf * 8;
      if (row0 + r >= n_rows) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(po + r * D + i * 8 + tig * 2) =
            make_float2(acc[i][hf * 2], acc[i][hf * 2 + 1]);
      if (tig == 0) *reinterpret_cast<float2*>(pml + r * 2) = make_float2(m[hf], l[hf]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&tp.counters[work], 1) == tp.n_splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // log-sum-exp merge: row r's weight of split sp is 2^(m_sp - max m) / sum,
  // 0 for a split with nothing valid (l = 0); a row with nothing valid in any
  // split writes 0.  Every split's (m, l) comes to shared memory first, and
  // each thread's loads of a split's partial outputs are in flight together.
  float2* ml_s = reinterpret_cast<float2*>(smem_raw);     // [n_splits][kRows]
  const float2* ml_g = reinterpret_cast<const float2*>(tp.part_ml) + part0 * kRows;
#pragma unroll 4
  for (int i = tid; i < tp.n_splits * kRows; i += kThreads) ml_s[i] = __ldcg(ml_g + i);
  __syncthreads();
  if (tid < kRows) {                  // row tid: its weights replace the maxima
    float mx = kNegInf, total = 0.f;
    for (int sp = 0; sp < tp.n_splits; ++sp) mx = fmaxf(mx, ml_s[sp * kRows + tid].x);
    for (int sp = 0; sp < tp.n_splits; ++sp) {
      float2& x = ml_s[sp * kRows + tid];
      x.x = x.y > 0.f ? exp2f(x.x - mx) : 0.f;
      total += x.x * x.y;
    }
    const float inv = total > 0.f ? 1.f / total : 0.f;
    for (int sp = 0; sp < tp.n_splits; ++sp) ml_s[sp * kRows + tid].x *= inv;
  }
  __syncthreads();
  constexpr int kQuads = D / 4, kItems = kRows * kQuads / kThreads;
  float4 o[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < tp.n_splits; ++sp) {
    const float* po = tp.part_o + (part0 + sp) * kRows * D;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int i = tid + u * kThreads, r = i / kQuads, c = (i % kQuads) * 4;
      const float w = ml_s[sp * kRows + r].x;
      if (r < kBlockRows && row0 + r < n_rows && w != 0.f) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(po + r * D + c));
        o[u].x += w * x.x;
        o[u].y += w * x.y;
        o[u].z += w * x.z;
        o[u].w += w * x.w;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = tid + u * kThreads, r = i / kQuads, c = (i % kQuads) * 4;
    if (r < kBlockRows && row0 + r < n_rows)
      *reinterpret_cast<uint2*>(out_row(r) + c) =
          make_uint2(pack_bf16(o[u].x, o[u].y), pack_bf16(o[u].z, o[u].w));
  }
  if (tid == 0) tp.counters[work] = 0;    // ready for the next launch
}

template <int D, int KS, bool kPaged>
cudaError_t launch_ks(const TcParams& tp, dim3 grid, cudaStream_t stream) {
  auto kernel = flash_tc_kernel<D, KS, kPaged>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kBytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kThreads, Layout<D>::kBytes, stream>>>(tp);
  return cudaGetLastError();
}

template <int D, bool kPaged>
cudaError_t launch_d(const TcParams& tp, int ks, dim3 grid, cudaStream_t stream) {
  if (ks == 4) return launch_ks<D, 4, kPaged>(tp, grid, stream);
  if (ks == 2) return launch_ks<D, 2, kPaged>(tp, grid, stream);
  return launch_ks<D, 1, kPaged>(tp, grid, stream);
}

template <bool kPaged>
cudaError_t launch(const TcParams& tp, int ks, dim3 grid, cudaStream_t stream) {
  switch (tp.a.D) {
    case 16: return launch_d<16, kPaged>(tp, ks, grid, stream);
    case 32: return launch_d<32, kPaged>(tp, ks, grid, stream);
    case 48: return launch_d<48, kPaged>(tp, ks, grid, stream);
    case 64: return launch_d<64, kPaged>(tp, ks, grid, stream);
    case 80: return launch_d<80, kPaged>(tp, ks, grid, stream);
    case 96: return launch_d<96, kPaged>(tp, ks, grid, stream);
    case 112: return launch_d<112, kPaged>(tp, ks, grid, stream);
    default: return launch_d<128, kPaged>(tp, ks, grid, stream);
  }
}

}  // namespace tc

// Fills the fields both bodies share; false for arguments neither takes.
bool fill_params(Params& p, const void* q, const void* k, const void* v, void* out,
                 const void* q_pos, const void* kv_pos, const void* block_tables,
                 int page_size, const long long* strides, int B, int Hq, int Hkv, int Lq,
                 int Lkv, int D, float scale, int window, int anchor, int causal,
                 int bc_start, int bc_block) {
  if (B <= 0 || Lq <= 0 || Lkv < 0 || D <= 0 || D > 128 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535)
    return false;
  if (block_tables != nullptr && (page_size <= 0 || Lkv % page_size != 0)) return false;
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

// strides: 12 element strides, (b, h, l) of q, k, v and out in that order.
// block_tables: null (k, v are [B, Lkv, Hkv, D]-like caches) or [B, Lkv /
// page_size] int32 (k, v are [P, page_size, Hkv, D] pools; the k and v
// "b" strides are then unused and "l" steps one pool row).
// Returns a cudaError_t code (0 = launched), or -1 for arguments the kernel
// does not take.  The CUDA-core body.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, const void* q_pos, const void* kv_pos,
                                     const void* block_tables, int page_size,
                                     const long long* strides, int B, int Hq, int Hkv,
                                     int Lq, int Lkv, int D, float scale, int window,
                                     int anchor, int causal, int bc_start, int bc_block,
                                     void* stream) {
  using namespace repro_torch;
  Params p;
  if (!fill_params(p, q, k, v, out, q_pos, kv_pos, block_tables, page_size, strides, B, Hq,
                   Hkv, Lq, Lkv, D, scale, window, anchor, causal, bc_start, bc_block))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch<float>(p, s));
  if (dtype == kBF16) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return -1;
}

// The tensor-core body, bf16 only; arguments as repro_flash_attention's,
// plus the plan: ks warps share each 16-row slab (1, 2 or 4; a block holds
// 64 / ks packed rows), and n_splits splits of split_tiles 64-row KV tiles
// each (the last may be ragged; none may be empty).  With n_splits > 1,
// part_o holds [B * Hkv * row_tiles * n_splits * 64 * D] floats, part_ml
// twice [... * 64], and counters [B * Hkv * row_tiles] int32 zeros, which
// the kernel leaves zero; row_tiles = ceil(Hq / Hkv * Lq * ks / 64).
extern "C" int repro_flash_attention_tc(const void* q, const void* k, const void* v,
                                        void* out, const void* q_pos, const void* kv_pos,
                                        const void* block_tables, int page_size,
                                        const long long* strides, int B, int Hq, int Hkv,
                                        int Lq, int Lkv, int D, float scale, int window,
                                        int anchor, int causal, int bc_start, int bc_block,
                                        int ks, int n_splits, int split_tiles, void* part_o,
                                        void* part_ml, void* counters, void* stream) {
  using namespace repro_torch;
  using namespace repro_torch::tc;
  tc::TcParams tp;
  if (!fill_params(tp.a, q, k, v, out, q_pos, kv_pos, block_tables, page_size, strides, B,
                   Hq, Hkv, Lq, Lkv, D, scale, window, anchor, causal, bc_start, bc_block))
    return -1;
  if (D % 16 != 0 || (ks != 1 && ks != 2 && ks != 4)) return -1;
  // 16-byte rows and bases for cp.async; the output takes 8-byte stores
  for (const void* ptr : {q, k, v})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return -1;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return -1;
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
  if (block_tables != nullptr) return static_cast<int>(tc::launch<true>(tp, ks, grid, s));
  return static_cast<int>(tc::launch<false>(tp, ks, grid, s));
}
