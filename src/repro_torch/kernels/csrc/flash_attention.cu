// Flash attention with position masks, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_kernel
// (body _flash_kernel) -- the TPU kernel every layer of every ES-dLLM
// iteration calls: the active query rows (the block, or its top-k subset
// after a skip stage, or the whole sequence on a prompt refresh) attend the
// whole KV cache -- and paged_flash_attention_kernel, the same body over a
// shared page pool read through a per-slot block table (the serving path).
//
// What bounds it on this card: at the main path's shapes (Lq <= Lkv of a few
// hundred rows, head_dim 128) the work is a few MFLOP per (batch, head) and
// the bytes are the K/V rows of one head, so the kernel is bound by memory
// traffic and launch latency, not by the tensor cores.  The design keeps
// the whole softmax out of device memory: one thread block per
// (batch, q-head, tile of 8 query rows) stages the query tile and
// 32-row K/V tiles in shared memory (f32, rows padded by four words so the
// float4 reads of lane j on row j are conflict-free) and carries the
// online-softmax state (max, sum, accumulator) in registers in f32.  Each
// warp owns two query rows; lane j scores KV row j of the tile against both
// (one float4 of K feeds 8 FMAs), the row max and sum are warp shuffles,
// and each lane accumulates head_dim/32 consecutive output columns (one
// float4 of V feeds 8 FMAs).  Shared-memory reads, not device memory, were
// the first version's limit: one scalar read per FMA.  K/V reach shared
// memory as 16-byte chunks (8 bf16 or 4 f32 per load), held in registers a
// tile ahead so their latency overlaps the previous tile's math; unaligned
// or odd-width inputs take an element-wise copy instead.
// Scores, probabilities and the mask never reach device memory; K/V are
// read once per query tile (the cache of one head fits in L2).  Ragged
// query and KV edges are masked here, so the caller pads nothing.  Any
// strides with a contiguous last dimension are taken, so the cache's
// [B, S, Hkv, D] layout is read without a transpose copy.  Scalar FMA, no
// wgmma/TMA: a later PR makes it fast.
//
// Paged mode (bt != null): K/V are a pool [P, ps, Hkv, D] read in place;
// KV row r of batch b is pool row bt[b, r / ps] * ps + r % ps.  The lookup
// is per row, not per tile: a 32-row tile spans several pages at page size
// 8 or 16.  A row of an unmapped page (bt < 0) is masked as kv_pos = -1 and
// staged as zeros without a load.  On the TPU, repeated garbage-page indices
// let the pipeline skip the DMA; here the tile walk skips every tile whose
// pages are all unmapped, so the bytes moved follow the mapped pages.
//
// Mask (exactly _flash_kernel's): kv_pos < 0 is masked; causal keeps
// kv_pos <= q_pos; window > 0 keeps |q_pos - kv_pos| <= window, plus
// kv_pos < anchor when anchor > 0; bc_block > 0 is block-causal (positions
// below bc_start are block -1).  A query row with nothing valid writes 0.
#include <stdint.h>

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

}  // namespace
}  // namespace repro_torch

// strides: 12 element strides, (b, h, l) of q, k, v and out in that order.
// block_tables: null (k, v are [B, Lkv, Hkv, D]-like caches) or [B, Lkv /
// page_size] int32 (k, v are [P, page_size, Hkv, D] pools; the k and v
// "b" strides are then unused and "l" steps one pool row).
// Returns a cudaError_t code (0 = launched), or -1 for arguments the kernel
// does not take.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, const void* q_pos, const void* kv_pos,
                                     const void* block_tables, int page_size,
                                     const long long* strides, int B, int Hq, int Hkv,
                                     int Lq, int Lkv, int D, float scale, int window,
                                     int anchor, int causal, int bc_start, int bc_block,
                                     void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Lq <= 0 || Lkv < 0 || D <= 0 || D > 128 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535)
    return -1;
  if (block_tables != nullptr && (page_size <= 0 || Lkv % page_size != 0)) return -1;
  Params p;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return static_cast<int>(launch<float>(p, s));
  if (dtype == kBF16) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return -1;
}
