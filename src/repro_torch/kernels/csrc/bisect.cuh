// Shared pieces of the bisection kernels (bucketize.cu, unpack.cu): the
// counted predicate and the branch-free bisection of `_bsearch`
// (src/repro/kernels/bucketize.py:38-51), so the packed and the unpacked
// routes compare exactly alike, plus the host-side step count. The
// persistent grid of the shared-memory routes is launch.cuh's smem_grid.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace repro {

// The counted predicate, in the comparisons torch.searchsorted uses:
// right -> !(boundary > q), left -> !(boundary >= q). For numbers this is
// boundary <= q / boundary < q; a NaN query counts every boundary (NaN sorts
// above every number, as in jnp.searchsorted).
template <typename T, bool kRight>
__device__ __forceinline__ bool counted(T boundary, T q) {
  return kRight ? !(boundary > q) : !(boundary >= q);
}

// The count of boundaries b[0..nb) that `counted` accepts for q, over sorted
// boundaries, in `steps` = ceil(log2(nb + 1)) probes. kGlobal reads the
// boundaries through the read-only path (L2); otherwise from shared memory.
template <typename T, bool kRight, bool kGlobal>
__device__ __forceinline__ int32_t bisect(const T* b, int64_t nb, int steps,
                                          T q) {
  int64_t lo = 0;
  for (int k = steps - 1; k >= 0; --k) {
    const int64_t cand = lo + (int64_t(1) << k);
    if (cand <= nb) {
      T v;
      if constexpr (kGlobal) {
        v = __ldg(b + (cand - 1));
      } else {
        v = b[cand - 1];
      }
      if (counted<T, kRight>(v, q)) lo = cand;
    }
  }
  return static_cast<int32_t>(lo);
}

// The probe offset a window of `len` > 1 boundaries is split at: len / 2,
// or with `odd` the odd one of ceil(len / 2) and ceil(len / 2) - 1 (any
// offset in [1, ceil(len / 2)] keeps the count inside the shrunk window).
// Halving by len / 2 makes every lane's window start a multiple of a large
// power of two when nb is a multiple of one (4096, or 58,112 = 227 * 256),
// so the probes of a step land in one shared-memory bank (up to a 32-way
// conflict); odd offsets spread the starts over the banks, at the price of
// about one more probe. bucketize.cu takes them when 256 divides nb.
__device__ __forceinline__ int window_split(int len, bool odd) {
  if (!odd) return len >> 1;
  const int c = (len + 1) >> 1;
  return (c & 1) || c == 1 ? c : c - 1;
}

// Four searches over nb >= 1 boundaries in shared memory, interleaved step by
// step so their probes are in flight together. Each keeps a window
// [lo, lo + len] that holds the count and shrinks it with one probe, len
// uniform across the threads, so a probe is an add, a load, a compare and a
// conditional add, with no bounds guard: about log2(nb) + 1 probes. On sorted
// boundaries (the contract) it gives the count `bisect` gives, and
// torch.searchsorted.
template <typename T, bool kRight>
__device__ __forceinline__ void bisect4(const T* sb, int nb, bool odd,
                                        const T (&q)[4], int32_t (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) lo[j] = 0;
  for (int len = nb; len > 1;) {
    const int half = window_split(len, odd);
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = sb[lo[j] + half - 1];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (counted<T, kRight>(v[j], q[j])) lo[j] += half;
    len -= half;
  }
  T v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = sb[lo[j]];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (counted<T, kRight>(v[j], q[j])) lo[j] += 1;
}

inline int bisect_steps(int64_t nb) {  // ceil(log2(nb + 1)), at least 1
  int s = 0;
  while ((int64_t(1) << s) <= nb) ++s;
  return s < 1 ? 1 : s;
}

}  // namespace repro
