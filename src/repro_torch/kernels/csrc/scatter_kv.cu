// In-place KV-cache row scatter, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/scatter_kv.py, scatter_kv_kernel -- the K/V
// write of ES-dLLM's Alg. 1: cache[b, idx[b, k]] = new[b, k], for the rows an
// iteration computed, in every layer.  The TPU kernel routes each row by
// scalar prefetch and updates the cache in place through
// input_output_aliases.
//
// What bounds it on this card: pure data movement -- it reads K fresh rows
// and writes them once, so memory bandwidth and, at decode sizes (a few
// hundred KB), launch latency bound it.  The design writes straight into the
// cache the caller passes (no copy of the cache, as the TPU's aliasing
// does): one thread block per (row k, batch b, tensor) copies the row's
// H*D contiguous elements with 16-byte loads and stores.  K and V go in one
// launch (gridDim.z = 2).
//
// Assumptions: the caller's idx holds distinct rows per batch entry (two
// blocks writing one row would race); rows outside [0, S) are dropped, as
// an out-of-range scatter update is dropped in the reference; every pointer
// and the row size are multiples of 16 bytes (any cache with H*D*elem a
// multiple of 16 and a 16-byte-aligned base), else the call is refused.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

struct Pair {
  char* cache;      // [B, S, row_bytes]
  const char* src;  // [B, K, row_bytes]
};

__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(Pair p0, Pair p1, const int* idx, int S, int K, long long row_bytes) {
  const int k = blockIdx.x, b = blockIdx.y;
  const Pair p = blockIdx.z ? p1 : p0;
  const int row = idx[(long long)b * K + k];
  if (row < 0 || row >= S) return;
  uint4* dst = reinterpret_cast<uint4*>(p.cache + ((long long)b * S + row) * row_bytes);
  const uint4* src = reinterpret_cast<const uint4*>(p.src + ((long long)b * K + k) * row_bytes);
  for (long long i = threadIdx.x; i < row_bytes / 16; i += kThreads) dst[i] = src[i];
}

}  // namespace
}  // namespace repro_torch

// pairs: 1 (c0/n0) or 2 (c0/n0 and c1/n1, same shapes).  Returns a
// cudaError_t code (0 = launched), or -1 for arguments the kernel does not
// take (among them pointers or a row size that are not 16-byte multiples).
extern "C" int repro_scatter_rows(void* c0, const void* n0, void* c1, const void* n1,
                                  const void* idx, int pairs, int B, int S, int K,
                                  long long row_bytes, void* stream) {
  using namespace repro_torch;
  if (pairs < 1 || pairs > 2 || B <= 0 || K <= 0 || B > 65535 || row_bytes <= 0) return -1;
  const Pair p0{static_cast<char*>(c0), static_cast<const char*>(n0)};
  const Pair p1 = pairs == 2 ? Pair{static_cast<char*>(c1), static_cast<const char*>(n1)} : p0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(c0) | reinterpret_cast<uintptr_t>(n0) |
                          reinterpret_cast<uintptr_t>(p1.cache) |
                          reinterpret_cast<uintptr_t>(p1.src) | static_cast<uintptr_t>(row_bytes);
  if (align % 16 != 0) return -1;
  scatter_rows_kernel<<<dim3(K, B, pairs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p0, p1, static_cast<const int*>(idx), S, K, row_bytes);
  return static_cast<int>(cudaGetLastError());
}
