// Shared pieces of the bisection kernels (bucketize.cu, unpack.cu): the
// counted predicate and the branch-free bisection of `_bsearch`
// (src/repro/kernels/bucketize.py:38-51), so the packed and the unpacked
// routes compare exactly alike, plus the host-side step count and the
// persistent grid of the shared-memory route.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

inline int bisect_steps(int64_t nb) {  // ceil(log2(nb + 1)), at least 1
  int s = 0;
  while ((int64_t(1) << s) <= nb) ++s;
  return s < 1 ? 1 : s;
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory and size a
// persistent grid for `n` items at `threads` a block: at most as many blocks
// as the card keeps resident, so each block stages its shared data once.
template <typename Kernel>
cudaError_t smem_grid(Kernel kernel, int threads, size_t smem, int64_t n,
                      unsigned* grid_out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  int64_t grid = (n + threads - 1) / threads;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;
  *grid_out = static_cast<unsigned>(grid);
  return cudaSuccess;
}

}  // namespace repro
