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
//   * smem route (B <= 58,112, the 227 KB a block may opt in to): blocks of
//     256 threads, each stages the boundaries in dynamic shared memory once
//     and then takes 1024-query tiles; the first tile's queries are loaded
//     before the staging, so the two overlap. A thread runs four searches,
//     interleaved step by step (bisect4 in csrc/bisect.cuh: a window shrunk
//     by one probe a step, at odd offsets when 256 divides nb so the lanes'
//     probes spread over the shared-memory banks; on sorted boundaries it
//     counts what the branch-free bisection of `_bsearch`,
//     bucketize.py:38-51, counts, with no bounds guard), on four queries
//     from one 16-byte load, and stores the four counts with one 16-byte
//     store, when the queries and counts are 16-byte aligned; otherwise (a
//     view at an odd offset is legal input) it takes queries t, t + 256,
//     t + 512, t + 768 of the tile with scalar loads. One tile a block while the boundaries are no more than a
//     tile's queries; above that, a persistent grid of at most (SMs x
//     resident blocks), so the staging is paid once a block (launch.cuh's
//     smem_grid, which reads the occupancy once per kernel and device and
//     opts in beyond 48 KB only).
//   * The host side of a launch is short: kernels/bucketize.py binds the entry
//     once and plans the route (launch_plan: load width, persistent or not);
//     the C entry sizes the grid and launches.
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
using repro::bisect4;
using repro::bisect_steps;

constexpr int kSmemThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kSmemThreads * kPerThread;  // queries a block step
constexpr int kGlobalThreads = 256;

template <typename T>
__device__ __forceinline__ T from_bits(int b);

template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(int b) {
  return b;
}

template <>
__device__ __forceinline__ float from_bits<float>(int b) {
  return __int_as_float(b);
}

// This thread's four queries of the tile at `base`: one 16-byte load at
// base + 4t (kVec), else queries base + t + 256j. Past nq they repeat a query
// in range; store4 leaves those out.
template <typename T, bool kVec>
__device__ __forceinline__ void load4(const T* __restrict__ queries,
                                      int64_t nq, int64_t base, T (&q)[4]) {
  if constexpr (kVec) {
    const int64_t i = base + kPerThread * threadIdx.x;
    if (i + kPerThread <= nq) {
      const int4 w = __ldcs(reinterpret_cast<const int4*>(queries + i));
      q[0] = from_bits<T>(w.x);
      q[1] = from_bits<T>(w.y);
      q[2] = from_bits<T>(w.z);
      q[3] = from_bits<T>(w.w);
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        q[j] = queries[i + j < nq ? i + j : nq - 1];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t p = base + threadIdx.x + j * kSmemThreads;
      q[j] = queries[p < nq ? p : nq - 1];
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(int32_t* __restrict__ out, int64_t nq,
                                       int64_t base, const int32_t (&lo)[4]) {
  if constexpr (kVec) {
    const int64_t i = base + kPerThread * threadIdx.x;
    if (i + kPerThread <= nq) {
      __stcs(reinterpret_cast<int4*>(out + i),
             make_int4(lo[0], lo[1], lo[2], lo[3]));
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (i + j < nq) out[i + j] = lo[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t p = base + threadIdx.x + j * kSmemThreads;
      if (p < nq) out[p] = lo[j];
    }
  }
}

template <typename T, bool kRight, bool kVec>
__global__ void __launch_bounds__(kSmemThreads)
    bucketize_smem_kernel(const T* __restrict__ boundaries, int64_t nb,
                          const T* __restrict__ queries,
                          int32_t* __restrict__ out, int64_t nq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);
  const int64_t tiles = (nq + kTile - 1) / kTile;
  int64_t tile = blockIdx.x;
  T q[kPerThread];
  int32_t lo[kPerThread];
  // the first tile's queries are in flight while the boundaries are staged
  if (tile < tiles) load4<T, kVec>(queries, nq, tile * kTile, q);
  const int nbi = static_cast<int>(nb);
  const bool odd = (nbi & 255) == 0;  // see window_split
  for (int i = threadIdx.x; i < nbi; i += kSmemThreads)
    sb[i] = __ldg(boundaries + i);
  __syncthreads();
  for (; tile < tiles; tile += gridDim.x) {
    if (tile != blockIdx.x) load4<T, kVec>(queries, nq, tile * kTile, q);
    bisect4<T, kRight>(sb, nbi, odd, q, lo);
    store4<kVec>(out, nq, tile * kTile, lo);
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

template <auto kKernel, typename T>
int launch_smem(const T* bp, int64_t nb, const T* qp, int32_t* op, int64_t nq,
                int persistent, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nb) * sizeof(T);
  int64_t tiles = (nq + kTile - 1) / kTile;
  unsigned grid = 0;
  if (persistent) {
    cudaError_t err = repro::smem_grid<kKernel>(kSmemThreads, smem, tiles,
                                                &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    if (smem > repro::kSmemNoOptIn) return static_cast<int>(
        cudaErrorInvalidValue);  // only the persistent route opts in
    grid = static_cast<unsigned>(tiles > 0x7fffffff ? 0x7fffffff : tiles);
  }
  kKernel<<<grid, kSmemThreads, smem, stream>>>(bp, nb, qp, op, nq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kRight>
int launch_smem_route(const T* bp, int64_t nb, const T* qp, int32_t* op,
                      int64_t nq, int vec, int persistent,
                      cudaStream_t stream) {
  if (vec)
    return launch_smem<bucketize_smem_kernel<T, kRight, true>>(
        bp, nb, qp, op, nq, persistent, stream);
  return launch_smem<bucketize_smem_kernel<T, kRight, false>>(
      bp, nb, qp, op, nq, persistent, stream);
}

template <typename T>
int launch(const void* b, int64_t nb, const void* q, int64_t nq, void* out,
           int flags, cudaStream_t stream) {
  const int right = (flags >> 1) & 1, vec = (flags >> 3) & 1,
            persistent = (flags >> 4) & 1;
  const T* bp = static_cast<const T*>(b);
  const T* qp = static_cast<const T*>(q);
  int32_t* op = static_cast<int32_t*>(out);
  if (flags & 4) {
    const int steps = bisect_steps(nb);
    auto k = right ? bucketize_global_kernel<T, true>
                   : bucketize_global_kernel<T, false>;
    int64_t grid = (nq + kGlobalThreads - 1) / kGlobalThreads;
    if (grid > 0x7fffffff) grid = 0x7fffffff;
    k<<<static_cast<unsigned>(grid), kGlobalThreads, 0, stream>>>(bp, nb, steps,
                                                                  qp, op, nq);
    return static_cast<int>(cudaGetLastError());
  }
  if (nb < 1 || nb * static_cast<int64_t>(sizeof(T)) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((reinterpret_cast<uintptr_t>(qp) |
               reinterpret_cast<uintptr_t>(op)) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return right ? launch_smem_route<T, true>(bp, nb, qp, op, nq, vec,
                                            persistent, stream)
               : launch_smem_route<T, false>(bp, nb, qp, op, nq, vec,
                                             persistent, stream);
}

}  // namespace

// flags, one bit each: 1 float32 (else int32); 2 right: count(b <= q) (else
// count(b < q)); 4 global: bisection through L2, any nb (else the boundaries
// are staged in shared memory, 1 <= nb, nb * 4 <= 232,448 bytes); on the
// shared-memory route, as kernels/bucketize.py's launch_plan sets them,
// 8 vec: one 16-byte load and store a thread (queries and out 16-byte
// aligned), 16 persistent: a grid of at most the resident blocks.
extern "C" int repro_bucketize(const void* boundaries, int64_t nb,
                               const void* queries, int64_t nq, void* out,
                               int flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq <= 0) return 0;
  return (flags & 1)
             ? launch<float>(boundaries, nb, queries, nq, out, flags, s)
             : launch<int32_t>(boundaries, nb, queries, nq, out, flags, s);
}

extern "C" const char* repro_bucketize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
