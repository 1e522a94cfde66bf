// Hopper kernel for `segment_sum`: the sum of values per segment id, ids
// outside [0, G) dropped, G <= 4096, for float32 values and for int32 values
// (summed as uint32, so they wrap as int32 sums do, without undefined
// behaviour). One template, two instantiations.
//
// Replaces the Pallas TPU kernel segment_sum_kernel in
// src/repro/kernels/segment_reduce.py: a (1024 x G) one-hot built in vector
// registers and contracted on the MXU, accumulated into a resident [G] output
// across the sequential grid.
//
// What bounds it on the H100: bytes. The least work is one read of each value
// and id (8 bytes a row) and one write of the G sums, at 3.35 TB/s. The one-hot
// product of the TPU form would be 2*N*G operations of waste here.
//
// Design, deterministic by construction: the engine's bit-identity contracts
// (stream depth invariance, shared scan == solo run, recovered == clean) need
// the same bits on every run, so no float atomic whose order varies is used.
// Every add happens in an order fixed by N, G and the constants below, never
// by the SM count, the grid or the scheduling:
//   1. segsum_partial_kernel: the rows are cut into chunks of `chunk_rows`
//      (kernels/segment_reduce.py's plan: 8192 rows, or 64 G rounded up to a
//      power of two for the match route), and chunk c's partial sums go to
//      column c of a [G, nchunks] scratch. Blocks of 256 threads take chunks
//      grid-stride, so a capped grid gives the same bits. In a chunk, a thread
//      takes rows base + 4t .. base + 4t + 3 of each 1024-row step (one 16-byte
//      load of values and one of ids when both are aligned; the same rows by
//      scalar loads otherwise) and adds them in row order:
//        * G = 1 ("one"): into a register;
//        * G <= 32 ("small"): into its own column of a [G][256] shared array,
//          thread t at t + 256 g, so the 32 lanes of a warp hit 32 banks;
//        * larger G ("match"): each warp keeps a [G] array in shared memory;
//          lanes holding equal ids find each other with __match_any_sync and
//          the lowest lane of each group adds the group's values, in lane
//          order, into the warp's array.
//      The chunk's partial of a group is then a fixed tree: thread partials
//      summed 8 to a lane in thread order and a warp's 32 lanes by an xor
//      butterfly (one warp a group), or, for the match route, the 8 warp
//      arrays in warp order.
//   2. segsum_final_kernel: one block a group sums its scratch row: each
//      thread the chunks t, t + 256, ... in order, then a butterfly and the 8
//      warps in order.
// tests/torch_twins.py's segment_sum_emulated repeats this order in numpy.
// The shared-memory opt-in of the match route (129 KB at G = 4096) is made
// once per device (launch.cuh). Both launches go on the caller's stream,
// allocate nothing, and the entry returns cudaGetLastError(). Offsets are
// 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kStep = kThreads * kPerThread;  // rows a block takes a step
constexpr unsigned kFull = 0xffffffffu;

enum Route { kOne = 0, kSmall = 1, kMatch = 2 };

template <typename A>
__device__ __forceinline__ A from_bits(int b);

template <>
__device__ __forceinline__ float from_bits<float>(int b) {
  return __int_as_float(b);
}

template <>
__device__ __forceinline__ uint32_t from_bits<uint32_t>(int b) {
  return static_cast<uint32_t>(b);
}

template <typename A>
__device__ __forceinline__ A warp_sum(A s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// Rows r .. r + 3 (r = step base + 4t): values and ids, id -1 past `end`.
template <typename A, bool kVec>
__device__ __forceinline__ void load_rows(const A* __restrict__ values,
                                          const int32_t* __restrict__ ids,
                                          int64_t r, int64_t end,
                                          A (&v)[kPerThread],
                                          int (&id)[kPerThread]) {
  if (kVec && r + kPerThread <= end) {
    const int4 w = __ldcs(reinterpret_cast<const int4*>(values + r));
    const int4 d = __ldcs(reinterpret_cast<const int4*>(ids + r));
    v[0] = from_bits<A>(w.x);
    v[1] = from_bits<A>(w.y);
    v[2] = from_bits<A>(w.z);
    v[3] = from_bits<A>(w.w);
    id[0] = d.x;
    id[1] = d.y;
    id[2] = d.z;
    id[3] = d.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const bool in = r + j < end;
      v[j] = in ? values[r + j] : A(0);
      id[j] = in ? ids[r + j] : -1;
    }
  }
}

template <typename A, int kRoute, bool kVec>
__global__ void __launch_bounds__(kThreads)
    segsum_partial_kernel(const A* __restrict__ values,
                          const int32_t* __restrict__ ids, int64_t n, int g,
                          int64_t chunk_rows, int64_t nchunks,
                          A* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sm = reinterpret_cast<A*>(smem_raw);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned ug = static_cast<unsigned>(g);
  for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int64_t begin = c * chunk_rows;
    const int64_t end = begin + chunk_rows < n ? begin + chunk_rows : n;
    if constexpr (kRoute == kOne) {
      A acc = A(0);
      for (int64_t base = begin; base < end; base += kStep) {
        A v[kPerThread];
        int id[kPerThread];
        load_rows<A, kVec>(values, ids, base + kPerThread * t, end, v, id);
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          if (id[j] == 0) acc += v[j];
      }
      acc = warp_sum(acc);
      if (lane == 0) sm[warp] = acc;
      __syncthreads();
      if (t == 0) {
        A s = A(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += sm[w];
        partial[c] = s;
      }
      __syncthreads();
    } else if constexpr (kRoute == kSmall) {
      A* col = sm + t;  // this thread's column: col[k * kThreads]
      for (int k = 0; k < g; ++k) col[k * kThreads] = A(0);
      for (int64_t base = begin; base < end; base += kStep) {
        A v[kPerThread];
        int id[kPerThread];
        load_rows<A, kVec>(values, ids, base + kPerThread * t, end, v, id);
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          if (static_cast<unsigned>(id[j]) < ug) col[id[j] * kThreads] += v[j];
      }
      __syncthreads();
      for (int k = warp; k < g; k += kWarps) {
        const A* row = sm + k * kThreads;
        A s = A(0);
#pragma unroll
        for (int i = 0; i < kThreads / 32; ++i) s += row[lane + 32 * i];
        s = warp_sum(s);
        if (lane == 0) partial[static_cast<int64_t>(k) * nchunks + c] = s;
      }
      __syncthreads();
    } else {
      A* wacc = sm + warp * g;                  // [kWarps][g]
      A* stage = sm + kWarps * g + warp * 32;   // [kWarps][32]
      for (int i = t; i < kWarps * g; i += kThreads) sm[i] = A(0);
      __syncthreads();
      for (int64_t base = begin; base < end; base += kStep) {
        A v[kPerThread];
        int id[kPerThread];
        load_rows<A, kVec>(values, ids, base + kPerThread * t, end, v, id);
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const bool live = static_cast<unsigned>(id[j]) < ug;
          const unsigned peers = __match_any_sync(kFull, live ? id[j] : -1);
          stage[lane] = v[j];
          __syncwarp();
          if (live && __ffs(peers) - 1 == lane) {
            A s = A(0);
            for (unsigned m = peers; m != 0u; m &= m - 1u)
              s += stage[__ffs(m) - 1];
            wacc[id[j]] += s;
          }
          __syncwarp();
        }
      }
      __syncthreads();
      for (int k = t; k < g; k += kThreads) {
        A s = A(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += sm[w * g + k];
        partial[static_cast<int64_t>(k) * nchunks + c] = s;
      }
      __syncthreads();
    }
  }
}

template <typename A>
__global__ void __launch_bounds__(kThreads)
    segsum_final_kernel(const A* __restrict__ partial, int64_t nchunks,
                        A* __restrict__ out) {
  __shared__ A ws[kWarps];
  const int k = blockIdx.x;  // one block a group
  const A* row = partial + static_cast<int64_t>(k) * nchunks;
  A s = A(0);
  int64_t b = threadIdx.x;
  // the adds stay in chunk order; the loads of eight go out together
  for (; b + 7 * kThreads < nchunks; b += 8 * kThreads) {
    A x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = row[b + i * kThreads];
#pragma unroll
    for (int i = 0; i < 8; ++i) s += x[i];
  }
  for (; b < nchunks; b += kThreads) s += row[b];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    A tot = A(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += ws[w];
    out[k] = tot;
  }
}

template <auto kKernel, typename A, int kRoute>
int launch_partial(const void* values, const void* ids, int64_t n, int g,
                   int64_t chunk_rows, int64_t nchunks, unsigned grid,
                   void* partial, cudaStream_t s) {
  size_t smem = sizeof(A) * kWarps;
  if (kRoute == kSmall) smem = sizeof(A) * static_cast<size_t>(g) * kThreads;
  if (kRoute == kMatch)
    smem = sizeof(A) * (static_cast<size_t>(kWarps) * g + kWarps * 32);
  if (smem > repro::kSmemNoOptIn) {
    repro::KernelCache<kKernel>* c = nullptr;
    int dev = 0;
    cudaError_t err = repro::kernel_facts<kKernel>(kThreads, &c, &dev);
    if (err == cudaSuccess) err = repro::opt_in<kKernel>(*c, dev, smem, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kKernel<<<grid, kThreads, smem, s>>>(
      static_cast<const A*>(values), static_cast<const int32_t*>(ids), n, g,
      chunk_rows, nchunks, static_cast<A*>(partial));
  return static_cast<int>(cudaGetLastError());
}

template <typename A, int kRoute>
int launch_route(const void* values, const void* ids, int64_t n, int g,
                 int vec, int64_t chunk_rows, int64_t nchunks, unsigned grid,
                 void* partial, cudaStream_t s) {
  if (vec)
    return launch_partial<segsum_partial_kernel<A, kRoute, true>, A, kRoute>(
        values, ids, n, g, chunk_rows, nchunks, grid, partial, s);
  return launch_partial<segsum_partial_kernel<A, kRoute, false>, A, kRoute>(
      values, ids, n, g, chunk_rows, nchunks, grid, partial, s);
}

template <typename A>
int launch(const void* values, const void* ids, int64_t n, int g, int route,
           int vec, int64_t chunk_rows, int64_t nchunks, int64_t max_blocks,
           void* partial, void* out, cudaStream_t s) {
  int64_t grid = nchunks;
  if (max_blocks > 0 && grid > max_blocks) grid = max_blocks;
  if (grid > 0x7fffffff) grid = 0x7fffffff;
  const unsigned ug = static_cast<unsigned>(grid);
  int err = route == kOne
                ? launch_route<A, kOne>(values, ids, n, g, vec, chunk_rows,
                                        nchunks, ug, partial, s)
            : route == kSmall
                ? launch_route<A, kSmall>(values, ids, n, g, vec, chunk_rows,
                                          nchunks, ug, partial, s)
                : launch_route<A, kMatch>(values, ids, n, g, vec, chunk_rows,
                                          nchunks, ug, partial, s);
  if (err != 0) return err;
  segsum_final_kernel<A><<<static_cast<unsigned>(g), kThreads, 0, s>>>(
      static_cast<const A*>(partial), nchunks, static_cast<A*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values: [n] float32 (dtype 1) or int32 (dtype 0); ids: int32 [n]; partial:
// scratch of the values' dtype, [g, nchunks] with nchunks =
// ceil(n / chunk_rows); out: [g]. n > 0, 0 < g <= 4096. route (0 one, 1
// small, 2 match) and chunk_rows (a multiple of 1024) are
// kernels/segment_reduce.py's plan for g; vec: values and ids 16-byte
// aligned; max_blocks > 0 caps the first launch's grid (the sums do not
// depend on it).
extern "C" int repro_segment_sum(const void* values, const void* ids,
                                 int64_t n, int g, int dtype, int route,
                                 int vec, int64_t chunk_rows, int64_t nchunks,
                                 int64_t max_blocks, void* partial, void* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || g <= 0 || g > 4096 || chunk_rows <= 0 ||
      chunk_rows % kStep != 0 || nchunks != (n + chunk_rows - 1) / chunk_rows ||
      route < kOne || route > kMatch || (route == kOne && g != 1) ||
      (route == kSmall && g > 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((reinterpret_cast<uintptr_t>(values) |
               reinterpret_cast<uintptr_t>(ids)) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return dtype == 1 ? launch<float>(values, ids, n, g, route, vec, chunk_rows,
                                    nchunks, max_blocks, partial, out, s)
                    : launch<uint32_t>(values, ids, n, g, route, vec,
                                       chunk_rows, nchunks, max_blocks,
                                       partial, out, s);
}

extern "C" const char* repro_segment_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
