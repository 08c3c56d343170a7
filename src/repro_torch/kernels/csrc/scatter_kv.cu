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
// What bounds it on this card: pure data movement -- it reads K fresh rows
// and writes them once, so memory bandwidth and, at decode sizes (a few
// hundred KB), launch latency bound it.  The design writes straight into the
// cache the caller passes (no copy of the cache, as the TPU's aliasing
// does): one thread block per (row k, batch b, tensor) copies the row's
// H*D contiguous elements with 16-byte loads and stores.  K and V go in one
// launch (gridDim.z = 2).
//
// keep (optional, [B, K] bytes): a token whose keep byte is 0 is not
// written.  It carries the reference's row_mask (rows a mixed-mode pass
// does not own) and token_mask (the adaptive cache's partial refresh).  The
// reference gathers the old rows and writes them back (dense) or routes
// unowned rows to the garbage page (paged); an in-place kernel gets the same
// cache by skipping the write, without the extra gather.
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
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

struct Pair {
  char* cache;      // dense [B, S, row_bytes]; paged [P * ps, row_bytes]
  const char* src;  // [B, K, row_bytes]
};

__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(Pair p0, Pair p1, const int* idx, const uint8_t* keep, const int* bt,
                        int S, int K, int P, int ps, long long row_bytes) {
  const int k = blockIdx.x, b = blockIdx.y;
  const Pair p = blockIdx.z ? p1 : p0;
  const long long tok = (long long)b * K + k;
  if (keep != nullptr && keep[tok] == 0) return;
  const int row = idx[tok];
  if (row < 0 || row >= S) return;
  long long dest = (long long)b * S + row;
  if (bt != nullptr) {
    const int page = max(bt[(long long)b * (S / ps) + row / ps], 0);  // unmapped: page 0
    if (page >= P) return;
    dest = (long long)page * ps + row % ps;
  }
  uint4* dst = reinterpret_cast<uint4*>(p.cache + dest * row_bytes);
  const uint4* src = reinterpret_cast<const uint4*>(p.src + tok * row_bytes);
  for (long long i = threadIdx.x; i < row_bytes / 16; i += kThreads) dst[i] = src[i];
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

// pairs: 1 (c0/n0) or 2 (c0/n0 and c1/n1, same shapes).  keep: null or
// [B, K] bytes.  block_tables: null (caches are [B, S, row]) or [B, S /
// page_size] int32 (caches are pools [num_pages, page_size, row]).
// Returns a cudaError_t code (0 = launched), or -1 for arguments the kernel
// does not take (among them pointers or a row size that are not 16-byte
// multiples).
extern "C" int repro_scatter_rows(void* c0, const void* n0, void* c1, const void* n1,
                                  const void* idx, const void* keep, const void* block_tables,
                                  int pairs, int B, int S, int K, int num_pages, int page_size,
                                  long long row_bytes, void* stream) {
  using namespace repro_torch;
  if (pairs < 1 || pairs > 2 || B <= 0 || K <= 0 || B > 65535 || row_bytes <= 0) return -1;
  if (block_tables != nullptr && (page_size <= 0 || S % page_size != 0 || num_pages <= 0))
    return -1;
  const Pair p0{static_cast<char*>(c0), static_cast<const char*>(n0)};
  const Pair p1 = pairs == 2 ? Pair{static_cast<char*>(c1), static_cast<const char*>(n1)} : p0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(c0) | reinterpret_cast<uintptr_t>(n0) |
                          reinterpret_cast<uintptr_t>(p1.cache) |
                          reinterpret_cast<uintptr_t>(p1.src) | static_cast<uintptr_t>(row_bytes);
  if (align % 16 != 0) return -1;
  scatter_rows_kernel<<<dim3(K, B, pairs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p0, p1, static_cast<const int*>(idx), static_cast<const uint8_t*>(keep),
      static_cast<const int*>(block_tables), S, K, num_pages, page_size, row_bytes);
  return static_cast<int>(cudaGetLastError());
}
