// Hopper kernels for `bucketize` (searchsorted): per query, the count of sorted
// boundaries <= q (right) or < q (left), as int32.
//
// Replaces two Pallas TPU kernels in src/repro/kernels/bucketize.py:
//   * bucketize_kernel: boundaries resident in VMEM (up to 2^21 entries), a
//     branch-free log2(B) bisection per lane, 1024-query tiles.
//   * bucketize_count_kernel: for boundary lists beyond VMEM, a (query tile x
//     2048-boundary tile) grid of comparisons summed into the output, with
//     sentinel-padded boundaries.
//
// What bounds it on the H100: bytes. The least work is one read of each query
// and each boundary and one write of each count, 4 bytes apiece, at 3.35 TB/s.
// The bisection does O(Q log B) further reads, but they hit shared memory or
// the 50 MB L2, never device memory again.
//
// Design:
//   * smem route (B <= 58,112, the 227 KB a block may opt in to): a persistent
//     grid of at most (SMs x resident blocks) blocks. Each block stages the
//     boundaries in dynamic shared memory once and then walks the queries with a
//     grid-stride loop, one thread per query, running the same branch-free
//     bisection as `_bsearch` (bucketize.py:38-51), with the same `cand <= n_b`
//     guard (csrc/bisect.cuh, shared with the packed route of unpack.cu). Staging once per block, not once per 1024 queries, keeps the
//     shared-memory fill off the critical path.
//   * global route (any B): there is no VMEM ceiling to tile around on Hopper,
//     so the TPU's O(Q*B) tiled count becomes the same O(Q log B) bisection,
//     reading the boundaries through the read-only path (__ldg) from L2. The
//     kernel masks the ragged end of the query range itself and needs no
//     sentinel padding of the boundaries.
//   * float32 compares as torch.searchsorted does, so a NaN query counts
//     every boundary (NaN sorts above every number, as in jnp.searchsorted).
// Each launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError(). Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bisect.cuh"

namespace {

using repro::bisect;
using repro::bisect_steps;

constexpr int kSmemThreads = 1024;
constexpr int kGlobalThreads = 256;

template <typename T, bool kRight>
__global__ void __launch_bounds__(kSmemThreads)
    bucketize_smem_kernel(const T* __restrict__ boundaries, int64_t nb,
                          int steps, const T* __restrict__ queries,
                          int32_t* __restrict__ out, int64_t nq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);
  for (int64_t i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = boundaries[i];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nq; i += stride) {
    out[i] = bisect<T, kRight, false>(sb, nb, steps, queries[i]);
  }
}

template <typename T, bool kRight>
__global__ void bucketize_global_kernel(const T* __restrict__ boundaries,
                                        int64_t nb, int steps,
                                        const T* __restrict__ queries,
                                        int32_t* __restrict__ out, int64_t nq) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nq; i += stride) {
    out[i] = bisect<T, kRight, true>(boundaries, nb, steps, __ldg(queries + i));
  }
}

template <typename T>
int launch(const void* b, int64_t nb, const void* q, int64_t nq, void* out,
           int right, int global, cudaStream_t stream) {
  using Kernel = void (*)(const T*, int64_t, int, const T*, int32_t*, int64_t);
  const int steps = bisect_steps(nb);
  const T* bp = static_cast<const T*>(b);
  const T* qp = static_cast<const T*>(q);
  int32_t* op = static_cast<int32_t*>(out);
  if (global) {
    Kernel k = right ? bucketize_global_kernel<T, true>
                     : bucketize_global_kernel<T, false>;
    int64_t grid = (nq + kGlobalThreads - 1) / kGlobalThreads;
    if (grid > 0x7fffffff) grid = 0x7fffffff;
    k<<<static_cast<unsigned>(grid), kGlobalThreads, 0, stream>>>(bp, nb, steps,
                                                                  qp, op, nq);
    return static_cast<int>(cudaGetLastError());
  }
  Kernel k = right ? bucketize_smem_kernel<T, true>
                   : bucketize_smem_kernel<T, false>;
  const size_t smem = static_cast<size_t>(nb) * sizeof(T);
  unsigned grid = 0;
  cudaError_t err = repro::smem_grid(k, kSmemThreads, smem, nq, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<grid, kSmemThreads, smem, stream>>>(bp, nb, steps, qp, op, nq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = int32, 1 = float32. right: 1 -> count(b <= q), 0 -> count(b < q).
// global: 0 -> boundaries staged in shared memory (nb * 4 <= 232,448 bytes),
//         1 -> bisection through L2 (any nb).
extern "C" int repro_bucketize(const void* boundaries, int64_t nb,
                               const void* queries, int64_t nq, void* out,
                               int dtype, int right, int global,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<int32_t>(boundaries, nb, queries, nq, out, right, global, s);
  if (dtype == 1)
    return launch<float>(boundaries, nb, queries, nq, out, right, global, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_bucketize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
