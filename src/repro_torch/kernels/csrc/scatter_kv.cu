// In-place KV-cache row scatter and copy-on-write page fork, written by hand
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/scatter_kv.py, scatter_kv_kernel -- the K/V
// write of ES-dLLM's Alg. 1: cache[b, idx[b, k]] = new[b, k], for the rows an
// iteration computed, in every layer -- and paged_scatter_kv_kernel, the
// same write into a shared page pool through a per-slot block table:
// pool[bt[b, i / ps], i % ps] = new[b, k] for i = idx[b, k] (the serving
// path).  The TPU kernels route each row by scalar prefetch and update the
// cache in place through input_output_aliases.
//
// What bounds it on this card: data movement -- it reads K fresh rows and
// writes them once -- but at the paths' sizes (0.1-4 MB) the bytes take
// well under 2 us at 3.35 TB/s, so what a call costs is the launch and the
// device-memory latencies it waits for one after the other.  The design
// writes straight into the cache the caller passes (no copy of the cache,
// as the TPU's aliasing does) and keeps that chain short:
//
//   * source loads first: the address of new[b, k] depends only on the
//     block and thread index, so every thread issues all its 16-byte loads
//     of the row (kLoads = 4 of them, unrolled into registers, as inline asm
//     the compiler cannot sink below the branches) before it reads the masks,
//     idx and, paged, bt.  The idx -> bt chain then overlaps the data load
//     instead of preceding it; a token the masks drop has cost one read.
//     The mask bytes and idx are read independently of each other (no
//     short-circuit chain), and bt as soon as idx is known.
//   * the block shape comes from the caller (kernels/scatter_kv.py::plan):
//     a row is cut into pieces of chunk_bytes, one group of threads moves
//     one piece (threads / rows_per_block threads, kLoads loads each), and a
//     block moves rows_per_block pieces.  The planner gives a row one group
//     of up to 256 threads (a row past 16 KB is cut into pieces; cutting a
//     decode's few rows across more blocks was timed and did not pay; nor
//     did fewer or more loads a thread) and packs the 1 KB rows
//     of Dream's 4 KV heads several to a block at prefill sizes.  The grid
//     is one-dimensional over the pieces, ordered (token, tensor, piece of
//     the row), so K and V of a token share a block's idx and bt reads.
//
// Masks (optional): row_mask [B] bytes (rows a mixed-mode pass does not own)
// and token_mask [B, K] bytes (the adaptive cache's partial refresh).  A
// token is written only where both pass, as the reference's keep =
// row_mask[:, None] & token_mask.  The reference gathers the old rows and
// writes them back (dense) or routes unowned rows to the garbage page
// (paged); an in-place kernel gets the same cache by skipping the write,
// without the extra gather.
//
// Paged mode (bt != null): a row of an unmapped page (bt < 0) lands on the
// garbage page 0, as on the TPU.  Several blocks may then write one garbage
// row at once; that race is harmless because page 0 is only ever read under
// a mask (kv_pos = -1), so its bytes never reach a result.
//
// Assumptions: the caller's idx holds distinct rows per batch entry (two
// blocks writing one mapped row would race); rows outside [0, S) and pages
// outside [0, P) are dropped, as an out-of-range scatter update is dropped in
// the reference; every pointer and the row size are multiples of 16 bytes
// (any cache with H*D*elem a multiple of 16 and a 16-byte-aligned base),
// else the call is refused.
//
// Quantizing scatter (repro_quant_scatter_rows): the same two TPU kernels'
// write under the int8 KV cache, where the reference runs _quantize_rows
// (src/repro/models/attention.py:66) in XLA and then four scatters (K and V
// codes, K and V scales).  Here one launch per layer does all of it: each
// (token, K or V, head) is one group of G = pow2(Dh / E) threads, each of
// which reads E consecutive elements of the new bf16 or f32 row (E = 4, or
// 8 past Dh 128, so that Gemma-3's 256 still takes one warp), the group
// reduces amax over Dh in f32 with xor shuffles, scale = max(amax / 127,
// 1e-8), code = clamp(rint(x / scale), +-127) -- IEEE division and
// round-half-even, as jnp.round and torch.round, so the codes and scales
// equal the plain version bit for bit (the build has no fast-math flag) --
// and the group writes its E codes a thread as one 32- or 64-bit store and
// lane 0 the scale.  NaN propagates through amax and the scale as in the
// reference (a non-finite row's scale is NaN or inf), and a NaN code is 0,
// as XLA converts it.  Scales are written per element, so the 16-byte row
// rule does not apply to them (a scale row is Hkv * 4 bytes: 4 on reduced
// Dream).  What bounds it: bytes again (2 B new-row bytes read, 1 B code
// and 4 / Dh B scale written per element), and at the paths' sizes the
// launch.  Routing, masks and the garbage page are the row scatter's.
//
// Fork (repro_fork_pages) replaces src/repro/kernels/scatter_kv.py,
// fork_pages_kernel -- the copy-on-write copy behind prefix page sharing:
// pool[g, dst[f]] = pool[g, src[f]] for every layer group g and pair f, in the
// K and the V pool [G, P, ps, Hkv, Dh], in place (the TPU kernel aliases the
// pool through input_output_aliases and routes pages by scalar prefetch).
// What bounds it: data movement only, 2 * F * G * 2 planes * page bytes (a
// read and a write of each page), so HBM bandwidth.  The design gives each
// (pair, layer group, plane) one thread block, which streams the page with
// 16-byte loads, four in flight per thread before their stores.  A pair with
// src == dst (the (0, 0) pads of a fork list) writes nothing.  Race-free
// only because no real destination is also a source of the same call; the
// wrapper checks that on the host, and that every page is in [0, P).
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;   // 16-byte loads a thread keeps in flight

struct Pair {
  char* cache;      // dense [B, S, row_bytes]; paged [P * ps, row_bytes]
  const char* src;  // [B, K, row_bytes]
};

// 16 bytes from device memory, issued where it stands: volatile asm is not
// moved below the branches that follow it
__device__ __forceinline__ uint4 load16(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

// A scatter's arguments, as the entry point resolved them
struct ScatterArgs {
  Pair p0, p1;
  const int* idx;            // [B, K]
  const uint8_t* row_mask;   // [B] or null
  const uint8_t* token_mask; // [B, K] or null
  const int* bt;             // [B, S / ps] or null (dense)
  int pairs, S, K, P, ps;
  long long row_vecs;        // 16-byte vectors of a row
  int pieces, splits, group, rows_per_block;
};

// One group of `group` threads per row piece; piece = (tok * pairs + z) *
// splits + split, and thread t of a group moves the 16-byte vectors split *
// group * kLoads + t + u * group (u < kLoads) of its row that lie inside it.
__global__ void __launch_bounds__(kThreads) scatter_rows_kernel(const ScatterArgs a) {
  const int piece = blockIdx.x * a.rows_per_block + threadIdx.x / a.group;
  if (piece >= a.pieces) return;
  const int row = piece / a.splits, tok = row / a.pairs;
  const Pair p = (row - tok * a.pairs) ? a.p1 : a.p0;
  const long long v0 =
      (long long)(piece - row * a.splits) * a.group * kLoads + threadIdx.x % a.group;
  const uint4* src = reinterpret_cast<const uint4*>(p.src) + tok * a.row_vecs;
  uint4 r[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const long long v = v0 + (long long)u * a.group;
    if (v < a.row_vecs) r[u] = load16(src + v);
  }
  const int b = tok / a.K;
  const bool keep_row = a.row_mask == nullptr || a.row_mask[b] != 0;
  const bool keep_tok = a.token_mask == nullptr || a.token_mask[tok] != 0;
  const int i = a.idx[tok];
  if (i < 0 || i >= a.S) return;
  long long dest = (long long)b * a.S + i;
  if (a.bt != nullptr) {
    const int page = max(a.bt[(long long)b * (a.S / a.ps) + i / a.ps], 0);  // unmapped: page 0
    if (page >= a.P) return;
    dest = (long long)page * a.ps + i % a.ps;
  }
  if (!(keep_row & keep_tok)) return;
  uint4* dst = reinterpret_cast<uint4*>(p.cache) + dest * a.row_vecs;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const long long v = v0 + (long long)u * a.group;
    if (v < a.row_vecs) dst[v] = r[u];
  }
}

// max that propagates NaN, as jnp.max / jnp.maximum do (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

struct QuantArgs {
  int8_t* codes[2];          // K, V: dense [B, S, Hkv, Dh]; paged [P * ps, Hkv, Dh]
  float* scales[2];          // K, V: dense [B, S, Hkv]; paged [P * ps, Hkv]
  const void* src[2];        // K, V: [B, K, Hkv, Dh] new rows, bf16 or f32
  const int* idx;            // [B, K]
  const uint8_t* row_mask;   // [B] or null
  const uint8_t* token_mask; // [B, K] or null
  const int* bt;             // [B, S / ps] or null (dense)
  int S, K, Hkv, Dh, P, ps;
  int items, group, per_block;   // items = B * K * 2 * Hkv
};

// One group of `group` threads per item = (tok * 2 + plane) * Hkv + head;
// thread t of a group holds elements E t .. E t + E - 1 of the head's Dh.
__device__ __forceinline__ uint2 load8(const uint2* p) {
  uint2 r;
  asm volatile("ld.global.v2.u32 {%0, %1}, [%2];\n" : "=r"(r.x), "=r"(r.y) : "l"(p));
  return r;
}

// Elements a thread of the quantizing scatter holds: 4, or 8 past Dh 128.
__host__ __device__ constexpr int quant_elems(int dh) { return dh > 128 ? 8 : 4; }

template <typename T, int E>
__global__ void __launch_bounds__(kThreads) quant_scatter_kernel(const QuantArgs a) {
  constexpr int kWords = E * sizeof(T) / 4;   // 32-bit words of a thread's elements
  const int item = blockIdx.x * a.per_block + threadIdx.x / a.group;
  const int t = threadIdx.x % a.group;
  const bool live = item < a.items;
  const int head = live ? item % a.Hkv : 0, tp = live ? item / a.Hkv : 0;
  const int plane = tp & 1, tok = tp >> 1;
  const int d0 = E * t;
  const bool mine = live && d0 < a.Dh;
  // the row's load first, then its destination's (the masks and idx, then
  // bt), all issued before the reduction waits on the row: the idx -> bt
  // chain overlaps the data load, as in scatter_rows_kernel
  uint32_t w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = 0u;
  long long dest = -1;
  if (mine) {
    // pointers picked by selects: a dynamic index into the parameter arrays
    // would copy the whole argument struct to local memory in every thread
    const T* src = static_cast<const T*>(plane ? a.src[1] : a.src[0]) +
                   ((long long)tok * a.Hkv + head) * a.Dh + d0;
    if constexpr (kWords >= 4) {
#pragma unroll
      for (int c = 0; c < kWords / 4; ++c) {
        const uint4 r = load16(reinterpret_cast<const uint4*>(src) + c);
        w[4 * c] = r.x, w[4 * c + 1] = r.y, w[4 * c + 2] = r.z, w[4 * c + 3] = r.w;
      }
    } else {
      const uint2 r2 = load8(reinterpret_cast<const uint2*>(src));
      w[0] = r2.x, w[1] = r2.y;
    }
    const int b = tok / a.K;
    const bool keep_row = a.row_mask == nullptr || a.row_mask[b] != 0;
    const bool keep_tok = a.token_mask == nullptr || a.token_mask[tok] != 0;
    const int i = a.idx[tok];
    if (i >= 0 && i < a.S) {
      dest = (long long)b * a.S + i;
      if (a.bt != nullptr) {
        const int page = max(a.bt[(long long)b * (a.S / a.ps) + i / a.ps], 0);  // unmapped: 0
        dest = page < a.P ? (long long)page * a.ps + i % a.ps : -1;
      }
    }
    if (!(keep_row & keep_tok)) dest = -1;
  }
  float x[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if constexpr (sizeof(T) == 4) {
      x[e] = __uint_as_float(w[e]);
    } else {                         // a bf16 is the top half of its f32
      x[e] = __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) amax = max_nan(amax, fabsf(x[e]));
  // every thread of the warp takes part; xor partners stay inside the group
  for (int o = a.group / 2; o > 0; o >>= 1)
    amax = max_nan(amax, __shfl_xor_sync(kFullMask, amax, o));
  if (dest < 0) return;
  const float scale = max_nan(amax / 127.f, 1e-8f);
  uint32_t codes[E / 4] = {};        // the E codes, element e in byte e % 4 of word e / 4
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float r = rintf(x[e] / scale);
    const int q = static_cast<int>(r != r ? 0.f : fminf(fmaxf(r, -127.f), 127.f));
    codes[e / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (e % 4));
  }
  const long long slot = dest * a.Hkv + head;
  int8_t* dst = (plane ? a.codes[1] : a.codes[0]) + slot * a.Dh + d0;
  if constexpr (E == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(codes[0], codes[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = codes[0];
  }
  if (t == 0) (plane ? a.scales[1] : a.scales[0])[slot] = scale;
}

constexpr int kForkUnroll = 4;

__global__ void __launch_bounds__(kThreads)
    fork_pages_kernel(char* k, char* v, const int* src, const int* dst, int P,
                      long long page_bytes) {
  const int f = blockIdx.x, g = blockIdx.y;
  char* pool = blockIdx.z ? v : k;
  const int s = src[f], d = dst[f];
  if (s == d || s < 0 || d < 0 || s >= P || d >= P) return;
  const uint4* from = reinterpret_cast<const uint4*>(pool + ((long long)g * P + s) * page_bytes);
  uint4* to = reinterpret_cast<uint4*>(pool + ((long long)g * P + d) * page_bytes);
  const long long n = page_bytes / 16;
  for (long long i = threadIdx.x; i < n; i += kForkUnroll * kThreads) {
    uint4 r[kForkUnroll];
#pragma unroll
    for (int u = 0; u < kForkUnroll; ++u) {
      const long long j = i + (long long)u * kThreads;
      if (j < n) r[u] = from[j];
    }
#pragma unroll
    for (int u = 0; u < kForkUnroll; ++u) {
      const long long j = i + (long long)u * kThreads;
      if (j < n) to[j] = r[u];
    }
  }
}

}  // namespace
}  // namespace repro_torch

// k, v: the K and V pools, same shape, each [G, P, page_bytes].  src/dst:
// [F] int32 page pairs.  Returns a cudaError_t code (0 = launched), or -1
// for arguments the kernel does not take.
extern "C" int repro_fork_pages(void* k, void* v, const void* src, const void* dst, int F,
                                int G, int P, long long page_bytes, void* stream) {
  using namespace repro_torch;
  if (F <= 0 || G <= 0 || G > 65535 || P <= 0 || page_bytes <= 0) return -1;
  const uintptr_t align = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                          static_cast<uintptr_t>(page_bytes);
  if (align % 16 != 0) return -1;
  fork_pages_kernel<<<dim3(F, G, 2), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k), static_cast<char*>(v), static_cast<const int*>(src),
      static_cast<const int*>(dst), P, page_bytes);
  return static_cast<int>(cudaGetLastError());
}

// kc/vc: int8 code caches, ks/vs: f32 scale caches, kn/vn: new rows
// [B, K, Hkv, Dh] of dtype (kF32 or kBF16).  block_tables as in
// repro_scatter_rows.  group: threads an item, a power of two >= Dh / E
// (E = 4, or 8 past Dh 128) and <= 32; per_block: items a block (group *
// per_block <= 256).  Dh must be a multiple of E and at most 256.  Returns a cudaError_t code (0 =
// launched), or -1 for arguments the kernel does not take.
extern "C" int repro_quant_scatter_rows(void* kc, void* ks, const void* kn, void* vc, void* vs,
                                        const void* vn, int dtype, const void* idx,
                                        const void* row_mask, const void* token_mask,
                                        const void* block_tables, int B, int S, int K, int Hkv,
                                        int Dh, int num_pages, int page_size, int group,
                                        int per_block, void* stream) {
  using namespace repro_torch;
  const int elems = quant_elems(Dh);
  if (B <= 0 || K <= 0 || S < 0 || Hkv <= 0 || Dh <= 0 || Dh % elems != 0 || Dh > 256)
    return -1;
  if (dtype != kF32 && dtype != kBF16) return -1;
  if (block_tables != nullptr && (page_size <= 0 || S % page_size != 0 || num_pages <= 0))
    return -1;
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 || group * elems < Dh) return -1;
  if (per_block < 1 || group * per_block > kThreads) return -1;
  const uintptr_t vec = dtype == kF32 || elems == 8 ? 16 : 8;
  if ((reinterpret_cast<uintptr_t>(kn) | reinterpret_cast<uintptr_t>(vn)) % vec != 0 ||
      (reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc)) % elems != 0 ||
      (reinterpret_cast<uintptr_t>(ks) | reinterpret_cast<uintptr_t>(vs)) % 4 != 0)
    return -1;
  const long long items = (long long)B * K * 2 * Hkv;
  if (items > INT_MAX - per_block) return -1;
  QuantArgs a{{static_cast<int8_t*>(kc), static_cast<int8_t*>(vc)},
              {static_cast<float*>(ks), static_cast<float*>(vs)},
              {kn, vn},
              static_cast<const int*>(idx),
              static_cast<const uint8_t*>(row_mask),
              static_cast<const uint8_t*>(token_mask),
              static_cast<const int*>(block_tables),
              S, K, Hkv, Dh, num_pages, page_size,
              static_cast<int>(items), group, per_block};
  const int blocks = static_cast<int>((items + per_block - 1) / per_block);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && elems == 8)
    quant_scatter_kernel<float, 8><<<blocks, group * per_block, 0, s>>>(a);
  else if (dtype == kF32)
    quant_scatter_kernel<float, 4><<<blocks, group * per_block, 0, s>>>(a);
  else if (elems == 8)
    quant_scatter_kernel<__nv_bfloat16, 8><<<blocks, group * per_block, 0, s>>>(a);
  else
    quant_scatter_kernel<__nv_bfloat16, 4><<<blocks, group * per_block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// pairs: 1 (c0/n0) or 2 (c0/n0 and c1/n1, same shapes).  row_mask: null or
// [B] bytes; token_mask: null or [B, K] bytes.  block_tables: null (caches
// are [B, S, row]) or [B, S / page_size] int32 (caches are pools
// [num_pages, page_size, row]).  threads, rows_per_block, chunk_bytes: the
// block shape (kernels/scatter_kv.py::plan): rows_per_block groups of
// threads / rows_per_block threads, each moving chunk_bytes = 16 * kLoads *
// group bytes of a row.  Returns a
// cudaError_t code (0 = launched), or -1 for arguments the kernel does not
// take (among them pointers or a row size that are not 16-byte multiples).
extern "C" int repro_scatter_rows(void* c0, const void* n0, void* c1, const void* n1,
                                  const void* idx, const void* row_mask,
                                  const void* token_mask, const void* block_tables, int pairs,
                                  int B, int S, int K, int num_pages, int page_size,
                                  long long row_bytes, int threads, int rows_per_block,
                                  int chunk_bytes, void* stream) {
  using namespace repro_torch;
  if (pairs < 1 || pairs > 2 || B <= 0 || K <= 0 || S < 0 || row_bytes <= 0) return -1;
  if (block_tables != nullptr && (page_size <= 0 || S % page_size != 0 || num_pages <= 0))
    return -1;
  if (threads < 1 || threads > kThreads || rows_per_block < 1 || threads % rows_per_block != 0)
    return -1;
  const int group = threads / rows_per_block;
  if (chunk_bytes != 16 * kLoads * group) return -1;
  const Pair p0{static_cast<char*>(c0), static_cast<const char*>(n0)};
  const Pair p1 = pairs == 2 ? Pair{static_cast<char*>(c1), static_cast<const char*>(n1)} : p0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(c0) | reinterpret_cast<uintptr_t>(n0) |
                          reinterpret_cast<uintptr_t>(p1.cache) |
                          reinterpret_cast<uintptr_t>(p1.src) | static_cast<uintptr_t>(row_bytes);
  if (align % 16 != 0) return -1;
  const long long splits = (row_bytes + chunk_bytes - 1) / chunk_bytes;
  const long long pieces = (long long)B * K * pairs * splits;
  if (pieces > INT_MAX - rows_per_block) return -1;   // the grid and piece indices are ints
  const int blocks = static_cast<int>((pieces + rows_per_block - 1) / rows_per_block);
  const ScatterArgs a{p0, p1, static_cast<const int*>(idx),
                      static_cast<const uint8_t*>(row_mask),
                      static_cast<const uint8_t*>(token_mask),
                      static_cast<const int*>(block_tables), pairs, S, K, num_pages, page_size,
                      row_bytes / 16, static_cast<int>(pieces), static_cast<int>(splits), group,
                      rows_per_block};
  scatter_rows_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
