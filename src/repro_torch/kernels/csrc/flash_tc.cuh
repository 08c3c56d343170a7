// The tensor-core body of the flash-attention kernels (see flash_attention.cu
// for what it replaces and its design), in a header so that two translation
// units build its instantiations in parallel: flash_attention.cu the bf16
// K/V ones, flash_attention_int8.cu the int8 K/V ones.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace repro_torch {

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
  const float* ks;    // int8 K/V: f32 scales [B, Hkv, Lkv]-strided (paged [P * ps, Hkv]),
  const float* vs;    //   null for bf16/f32 K/V
  Strides sks, svs;   // their element strides of dims b, h, l (paged: b unused)
  int B, Hq, Hkv, Lq, Lkv, D, ps;
  float scale;
  int window, anchor, causal, bc_start, bc_block;
};

// ---------------------------------------------------------------------------
// The tensor-core body (bf16)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRows = 64;        // packed query rows per block at most: 4 warps x 16
constexpr int kTile = 64;        // KV rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
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

// Two int8 codes of a word (the bytes __byte_perm's selector puts at the
// low end of each 16-bit lane) as bf16x2, exactly and with no conversion
// instruction: a code's low 7 bits under bf16's exponent of 128 read 128 +
// (x & 127), and subtracting 128, or 256 for a negative code (its bit 7,
// which is the exponent's lowest bit there), leaves x.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t word, uint32_t sel) {
  const uint32_t lanes = __byte_perm(word, 0u, sel);
  const uint32_t m = (lanes & 0x007f007fu) | 0x43004300u;
  const uint32_t c = (lanes & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// kQ8 = false: the ring holds kStages bf16 K/V stages.  kQ8 = true (int8
// K/V): one bf16 K/V stage, the tile the mma reads, at the start, then the
// ring of kStages int8 stages (D bytes a row, unpadded: only 16-byte reads
// touch it); each tile is widened from its ring stage into the bf16 stage.
//
// D <= 128: a 3-stage ring, and each warp holds its 16 rows of Q as A
// fragments for the whole walk (D / 4 registers).  D = 256 (Gemma-3): the O
// accumulator alone is 128 f32 registers a thread, so Q stays resident in
// shared memory after the ring (kQRes) and each k-step loads its A fragment
// with one ldmatrix; the ring drops to 2 stages so that ring and Q fit the
// 227 KB a block may use, one block per SM.
template <int D, bool kQ8 = false>
struct Layout {
  static constexpr bool kQRes = D > 128;
  static constexpr int kStages = kQRes ? 2 : 3;    // K/V ring depth
  // a shared row is D bf16 + 16 bytes: the 8 rows of an ldmatrix phase then
  // start on 8 distinct 16-byte bank groups
  static constexpr int kPitch = D + 8;
  static constexpr int kTileElems = kTile * kPitch;
  static constexpr int kStageElems = 2 * kTileElems;     // K, then V
  static constexpr int kStage8Bytes = 2 * kTile * D;     // an int8 stage: K, then V
  static constexpr int kRing8Offset = kStageElems * 2;   // bytes before the int8 ring
  static constexpr int kRingBytes = kQ8 ? kRing8Offset + kStages * kStage8Bytes
                                        : kStages * kStageElems * 2;
  static constexpr int kQOffset = kRingBytes;            // bytes before the resident Q
  static constexpr int kNeed = kRingBytes + (kQRes ? kRows * kPitch * 2 : 0);
  // the merges below reuse this memory: the key-split states (at most 3 x
  // (D / 2 + 4) x 128 floats) and the split merge's (m, l)
  static constexpr int kMerge = 3 * (D / 2 + 4) * 32 * 4 > kRows * kMaxSplits * 8
                                    ? 3 * (D / 2 + 4) * 32 * 4 : kRows * kMaxSplits * 8;
  static constexpr int kBytes = kNeed > kMerge ? kNeed : kMerge;
  static_assert(kRows == kTile, "the Q tile borrows a K tile's room");
  static_assert(kRows * kMaxSplits * 8 <= kBytes, "the merge's (m, l) reuse the ring");
};

// One block: split blockIdx.x of KV head blockIdx.z % Hkv of batch
// blockIdx.z / Hkv, packed rows [64 / KS * blockIdx.y, +64 / KS).  Packed row
// r is query head kvh * group + r / Lq, query row r % Lq.  KS warps share
// each 16-row slab, each scoring 64 / KS keys of every tile with its own
// softmax state, merged at the end: with few rows (MHA at Lq 8 to 32) every
// warp of the block still has work.
//
// kQ8: K/V are int8 codes with f32 per-row scales.  Their tiles move as
// 16-byte cp.async copies (half the bytes of bf16) and their scales as
// 4-byte ones into a ring of their own; once a stage has landed, the block
// widens its codes into the bf16 stage (codes -127..127 are exact in bf16)
// with integer and bf16x2 operations (s8x2_to_bf16x2), which timed about
// 10% faster a call than int-to-float conversions, and the mma runs on
// codes: k_scale[j] multiplies score column j in f32 after Q K^T, and
// v_scale[j] column j of P before P V (the row sums l take P unscaled).
// The widening is what the int8 form costs over bf16 (PERF.md); a barrier
// narrowed to the warps that share a tile's keys gained nothing measurable.
template <int D, int KS, bool kPaged, bool kQ8>
__global__ void __launch_bounds__(kThreads, Layout<D, kQ8>::kQRes ? 1 : 2)
    flash_tc_kernel(TcParams tp) {
  using L = Layout<D, kQ8>;
  constexpr int kStages = L::kStages;
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
  __shared__ float scale_s[kQ8 ? kStages : 1][2][kTile];   // int8: each stage's K, V scales
  __shared__ int last_s;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  int8_t* ring8 = reinterpret_cast<int8_t*>(smem_raw + L::kRing8Offset);   // kQ8 only

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
  using KT = typename std::conditional<kQ8, int8_t, bf16>::type;   // K/V element
  const KT* kg = static_cast<const KT*>(p.k) + kb + kvh * p.sk.h;
  const KT* vg = static_cast<const KT*>(p.v) + vb + kvh * p.sv.h;
  const float* ksg = kQ8 ? p.ks + (kPaged ? 0 : b * p.sks.b) + kvh * p.sks.h : nullptr;
  const float* vsg = kQ8 ? p.vs + (kPaged ? 0 : b * p.svs.b) + kvh * p.svs.h : nullptr;
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

  // Q: the block's packed rows, into the last stage's K room (int8: the bf16
  // stage's), free until the walk's first refill (first widening), or with
  // kQRes into its own room after the ring; rows past the packed rows are
  // zeros
  bf16* q_s = L::kQRes ? reinterpret_cast<bf16*>(smem_raw + L::kQOffset)
                       : kQ8 ? ring : ring + (kStages - 1) * L::kStageElems;
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
  // (int8: the codes into int8 stage st, its scales into scale_s[st])
  auto load_tile = [&](int kv0, int st) {
    constexpr int kElems = 16 / sizeof(KT);              // elements a 16-byte copy
    constexpr int kPerRow = D / kElems;
    constexpr int kRowPitch = kQ8 ? D : L::kPitch;       // elements of a shared row
    KT* kd = kQ8 ? reinterpret_cast<KT*>(ring8 + st * L::kStage8Bytes)
                 : reinterpret_cast<KT*>(ring + st * L::kStageElems);
    KT* vd = kd + (kQ8 ? kTile * D : L::kTileElems);
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
      const long long ko = ok ? row * p.sk.l + cc * kElems : 0;
      const long long vo = ok ? row * p.sv.l + cc * kElems : 0;
      cp_async16(smem_u32(kd + r * kRowPitch + cc * kElems), kg + ko, ok);
      cp_async16(smem_u32(vd + r * kRowPitch + cc * kElems), vg + vo, ok);
    }
    if (tid < kTile) {
      const int kk = kv0 + tid;
      const bool in = kk < kv_end;
      cp_async4(smem_u32(&kvpos_s[st][tid]), kvpos_g + (in ? kk : 0), in);
      valid_s[st][tid] = in && page_of(kk) >= 0;
    }
    if constexpr (kQ8) {     // thread t < 64: K scale of row t; 64 + t: V scale
      const int r = tid % kTile, kk = kv0 + r;
      const bool isv = tid >= kTile;
      bool ok = kk < kv_end;
      long long row = kk;
      if constexpr (kPaged) {
        const int page = ok ? page_of(kk) : -1;
        ok = page >= 0;
        row = (long long)page * p.ps + in_page(kk);
      }
      const float* sg = isv ? vsg + (ok ? row * p.svs.l : 0) : ksg + (ok ? row * p.sks.l : 0);
      cp_async4(smem_u32(&scale_s[st][isv][r]), sg, ok);
    }
  };
  static_assert(!kQ8 || kThreads == 2 * kTile, "a thread per scale of a tile");

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
  // Q's A fragment of k-step kd (16 head dims) for this warp's slab
  auto q_addr = [&](int kd) {
    const int r = slab * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, c = kd * 16 + (lane >> 4) * 8;
    return smem_u32(q_s + r * L::kPitch + c);
  };
  // Q as A fragments, held for the whole walk (kQRes: one k-step's, loaded
  // as the walk needs it)
  uint32_t qf[L::kQRes ? 1 : D / 16][4];
  if constexpr (!L::kQRes) {
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      ldsm_x4(q_addr(kd), qf[kd][0], qf[kd][1], qf[kd][2], qf[kd][3]);
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
    if constexpr (kQ8) {
      // widen int8 stage st into the bf16 stage, 16 codes a thread a step:
      // the kSlabs warps that score keys [kq * kKeys, +kKeys) widen those
      // K and V rows and wait only for each other (one warp at KS = 4)
      const int8_t* src = ring8 + st * L::kStage8Bytes;
      constexpr int kPerRow = D / 16;
#pragma unroll 4
      for (int c = tid; c < 2 * kTile * kPerRow; c += kThreads) {
        const int r = c / kPerRow, cc = c % kPerRow;          // r < 64: K, else V
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * D + cc * 16);
        const uint32_t x[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[2 * e] = s8x2_to_bf16x2(x[e], 0x4140);          // codes 0, 1 of the word
          w[2 * e + 1] = s8x2_to_bf16x2(x[e], 0x4342);      // codes 2, 3
        }
        bf16* dst = ring + (r / kTile) * L::kTileElems + (r % kTile) * L::kPitch + cc * 16;
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
    }

    if (warp_active) {
      const bf16* ks = kQ8 ? ring : ring + st * L::kStageElems;
      const bf16* vs = ks + L::kTileElems;
      // this thread's key columns: kv_pos, or -1 past the split or unmapped;
      // read before Q K^T, or at D = 256 after it, where these kKeys / 4
      // registers would push the walk past 255
      int kp[kKeys / 8][2];
      auto load_kp = [&] {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = kq * kKeys + j * 8 + tig * 2 + e;
            kp[j][e] = valid_s[st][c] ? kvpos_s[st][c] : -1;
          }
      };
      if constexpr (!L::kQRes) load_kp();
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
        const int kd = t / kPairs, j = (t % kPairs) * 2;
        if constexpr (L::kQRes) {
          if (t % kPairs == 0) ldsm_x4(q_addr(kd), qf[0][0], qf[0][1], qf[0][2], qf[0][3]);
        }
        const uint32_t(&a)[4] = qf[L::kQRes ? 0 : kd];
        mma_bf16(s[j], a, fb[t % 3][0], fb[t % 3][1]);
        mma_bf16(s[j + 1], a, fb[t % 3][2], fb[t % 3][3]);
      }
      if constexpr (L::kQRes) load_kp();
      if constexpr (kQ8) {           // k_scale of each score column, in f32
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] *= scale_s[st][0][kq * kKeys + j * 8 + tig * 2 + i % 2];
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
      if constexpr (kQ8) {           // v_scale of each column of P (l keeps P unscaled)
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] *= scale_s[st][1][kq * kKeys + j * 8 + tig * 2 + i % 2];
      }
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

template <int D, int KS, bool kPaged, bool kQ8>
cudaError_t launch_ks(const TcParams& tp, dim3 grid, cudaStream_t stream) {
  static_assert(Layout<D, kQ8>::kBytes <= 227 * 1024, "past the shared memory of a block");
  auto kernel = flash_tc_kernel<D, KS, kPaged, kQ8>;
  constexpr int kBytes = Layout<D, kQ8>::kBytes;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kThreads, kBytes, stream>>>(tp);
  return cudaGetLastError();
}

template <int D, bool kPaged, bool kQ8>
cudaError_t launch_d(const TcParams& tp, int ks, dim3 grid, cudaStream_t stream) {
  if (ks == 4) return launch_ks<D, 4, kPaged, kQ8>(tp, grid, stream);
  if (ks == 2) return launch_ks<D, 2, kPaged, kQ8>(tp, grid, stream);
  return launch_ks<D, 1, kPaged, kQ8>(tp, grid, stream);
}

template <bool kPaged, bool kQ8>
cudaError_t launch(const TcParams& tp, int ks, dim3 grid, cudaStream_t stream) {
  switch (tp.a.D) {
    case 16: return launch_d<16, kPaged, kQ8>(tp, ks, grid, stream);
    case 32: return launch_d<32, kPaged, kQ8>(tp, ks, grid, stream);
    case 48: return launch_d<48, kPaged, kQ8>(tp, ks, grid, stream);
    case 64: return launch_d<64, kPaged, kQ8>(tp, ks, grid, stream);
    case 80: return launch_d<80, kPaged, kQ8>(tp, ks, grid, stream);
    case 96: return launch_d<96, kPaged, kQ8>(tp, ks, grid, stream);
    case 112: return launch_d<112, kPaged, kQ8>(tp, ks, grid, stream);
    case 128: return launch_d<128, kPaged, kQ8>(tp, ks, grid, stream);
    case 256: return launch_d<256, kPaged, kQ8>(tp, ks, grid, stream);
    default: return cudaErrorInvalidValue;   // no instantiation: never a smaller one
  }
}

// The int8 K/V instantiations, compiled in flash_attention_int8.cu so that
// nvcc builds the two halves of the tensor-core body at once.
cudaError_t launch_int8(const TcParams& tp, int ks, dim3 grid, cudaStream_t stream);

}  // namespace tc

}  // namespace repro_torch
