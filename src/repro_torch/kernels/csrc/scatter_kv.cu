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
