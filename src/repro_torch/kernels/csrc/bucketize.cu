// Hopper kernels for `bucketize` (searchsorted): per query, the count of sorted
// boundaries <= q (right) or < q (left), as int32.
//
// Replaces three Pallas TPU kernels:
//   * bucketize_kernel (src/repro/kernels/bucketize.py): boundaries resident
//     in VMEM (up to 2^21 entries), a branch-free log2(B) bisection per lane,
//     1024-query tiles.
//   * bucketize_count_kernel (bucketize.py): for boundary lists beyond VMEM,
//     a (query tile x 2048-boundary tile) grid of comparisons summed into the
//     output, with sentinel-padded boundaries.
//   * bucketize_packed_kernel (src/repro/kernels/unpack.py): bucketize over
//     bit-packed int32 queries, the codes extracted in registers so the
//     unpacked queries never reach device memory.
// Both routes below are templated on the query source: DenseQueries (one
// 16-byte load for four queries) or PackedQueries (four consecutive codes
// extracted from the at most five lanes that cover them, csrc/packed.cuh),
// so the packed and the unpacked routes compare through one code path.
//
// What bounds it on the H100: bytes. The least work is one read of each query
// (4 bytes, or b/8 packed) and each boundary and one write of each count, 4
// bytes apiece, at 3.35 TB/s.
// The bisection does O(Q log B) further reads, but they hit shared memory or
// the 50 MB L2 (queries and counts stream past it with evict-first loads and
// stores), never device memory again.
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
//   * tiled route (bucketize_count_kernel, any B; bucketize_packed_kernel
//     above the shared-memory route): the TPU's O(Q*B) tiled count has no
//     VMEM ceiling to work around here; the count of a query is monotone in
//     the query, and the callers on the main path (the join probe and the
//     semi-join, resident and streamed; the streamed semi-join's packed RLE
//     run values, sorted up to n and padded with the column's offset) probe
//     with queries sorted by the table's order. A persistent grid of 256-thread blocks
//     takes contiguous runs of 2048-query tiles, two groups of four queries
//     a thread (one 16-byte load a group when aligned; the next tile's loads
//     go out before this tile's searches), so a tile's barriers and bound
//     searches are paid once for 2048 queries. Each block stages every 2^s-th
//     boundary in shared memory once: at most `max_splitters` (4096 by
//     default: 16 KB), and at most 256 for each tile the block takes, so a
//     launch of few tiles a block (the streamed semi-join's 256 tiles)
//     does not spend its time staging splitters it barely uses. Per
//     tile, the block reduces the queries' min and max (NaN above every
//     number) and two warps count them: a bisection over the staged
//     splitters, then 64 probes a round through L2 inside the splitter's
//     block of 2^s boundaries (two rounds at 2^23 boundaries). Every count of
//     the tile lies in [lo, hi]:
//       - window: when hi - lo <= 2048 (sorted queries: about 250 boundaries
//         a tile in Q3's join probe, about 4 in Q17's semi-join), the block
//         stages boundaries[lo, hi) with coalesced loads and runs bisect4
//         there, adding lo;
//       - splitter: otherwise (random queries), each thread bisects its four
//         queries over the staged splitters (bisect4), then finishes the last
//         s levels through L2, the four searches interleaved.
//     Either way a count is exact, so the grid does not change the output.
//   * packed queries always take four consecutive queries a thread (the
//     counts are a fresh, 16-byte aligned tensor; the lane loads are scalar,
//     so the words may sit at any offset). On the streamed semi-join a tile
//     of padding only has lo == hi and searches nothing, and the one tile
//     that straddles n takes the splitter route.
//   * float32 compares as torch.searchsorted does, so a NaN query counts
//     every boundary (NaN sorts above every number, as in jnp.searchsorted).
// Each launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError(). Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bisect.cuh"
#include "packed.cuh"

namespace {

using repro::bisect;
using repro::bisect4;
using repro::bisect_steps;
using repro::counted;
using repro::Packed;

constexpr int kSmemThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kSmemThreads * kPerThread;  // queries a block step
constexpr int kWarps = kSmemThreads / 32;
constexpr int kWindow = 2048;  // boundaries a tile's window may stage
constexpr int kGroups = 2;  // tiled route: groups of four queries a thread
constexpr int kCountTile = kGroups * kTile;  // tiled route: queries a tile
constexpr int kSplittersPerTile = 256;  // splitters staged for a block's tile

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

// The query sources of both routes. load4 gives this thread's four queries
// of the tile at `base`: with kVec queries base + 4t .. base + 4t + 3 (one
// 16-byte load for dense queries), else base + t + 256j. Past n they repeat
// a query in range; store4 leaves those out.
template <typename T>
struct DenseQueries {
  using Value = T;
  const T* q;
  int64_t n;

  template <bool kVec>
  __device__ __forceinline__ void load4(int64_t base, T (&v)[4]) const {
    if constexpr (kVec) {
      const int64_t i = base + kPerThread * threadIdx.x;
      if (i + kPerThread <= n) {
        const int4 w = __ldcs(reinterpret_cast<const int4*>(q + i));
        v[0] = from_bits<T>(w.x);
        v[1] = from_bits<T>(w.y);
        v[2] = from_bits<T>(w.z);
        v[3] = from_bits<T>(w.w);
      } else {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) v[j] = q[i + j < n ? i + j : n - 1];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int64_t p = base + threadIdx.x + j * kSmemThreads;
        v[j] = q[p < n ? p : n - 1];
      }
    }
  }
};

// Packed int32 queries (bucketize_packed_kernel, csrc/packed.cuh): a
// thread's four consecutive codes come from the at most five lanes that
// cover them (extract4: scalar lane loads, so a words view at any offset
// reads alike), the codes never written to device memory.
struct PackedQueries {
  using Value = int32_t;
  Packed p;
  int64_t n;

  template <bool kVec>
  __device__ __forceinline__ void load4(int64_t base, int32_t (&v)[4]) const {
    static_assert(kVec, "packed queries take the four-consecutive layout");
    const int64_t i = base + kPerThread * threadIdx.x;
    if (i + kPerThread <= n) {
      repro::extract4(p, i, v);
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        v[j] = repro::extract(p, i + j < n ? i + j : n - 1);
    }
  }
};

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

template <bool kRight, bool kVec, typename Src>
__global__ void __launch_bounds__(kSmemThreads)
    bucketize_smem_kernel(const typename Src::Value* __restrict__ boundaries,
                          int64_t nb, Src src, int32_t* __restrict__ out) {
  using T = typename Src::Value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);
  const int64_t nq = src.n;
  const int64_t tiles = (nq + kTile - 1) / kTile;
  int64_t tile = blockIdx.x;
  T q[kPerThread];
  int32_t lo[kPerThread];
  // the first tile's queries are in flight while the boundaries are staged
  if (tile < tiles) src.template load4<kVec>(tile * kTile, q);
  const int nbi = static_cast<int>(nb);
  const bool odd = (nbi & 255) == 0;  // see window_split
  for (int i = threadIdx.x; i < nbi; i += kSmemThreads)
    sb[i] = __ldg(boundaries + i);
  __syncthreads();
  for (; tile < tiles; tile += gridDim.x) {
    if (tile != blockIdx.x) src.template load4<kVec>(tile * kTile, q);
    bisect4<T, kRight>(sb, nbi, odd, q, lo);
    store4<kVec>(out, nq, tile * kTile, lo);
  }
}

// a < b for the tile's min and max, with NaN above every number (a NaN query
// counts every boundary, as the largest query would)
template <typename T>
__device__ __forceinline__ bool nan_high_less(T a, T b) {
  if constexpr (std::is_same<T, float>::value) {
    return !isnan(a) && (isnan(b) || a < b);
  } else {
    return a < b;
  }
}

// The count for q over all nb boundaries, by one warp (every lane gets it):
// the splitters (split[i] = b[i << shift], nsplit of them, in shared memory)
// give the block of 2^shift boundaries that holds the count, then rounds of
// 64 probes through L2 (two a lane, ballots counted) shrink the uncertain
// window 64-fold until one round reads it whole.
template <typename T, bool kRight>
__device__ __forceinline__ int64_t count_warp(const T* __restrict__ b,
                                              int64_t nb, const T* split,
                                              int nsplit, int split_steps,
                                              int shift, T q, int lane) {
  const int k = bisect<T, kRight, false>(split, nsplit, split_steps, q);
  if (k == 0) return 0;
  // b[(k - 1) << shift] is counted and b[k << shift] (if any) is not
  int64_t base = (static_cast<int64_t>(k - 1) << shift) + 1;
  const int64_t stop = static_cast<int64_t>(k) << shift;
  int64_t len = (stop < nb ? stop : nb) - base;
  while (len > 64) {
    const int64_t step = (len + 63) / 64;
    int m = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t p = base + (2 * lane + i + 1) * step - 1;
      const bool ok = p < base + len && counted<T, kRight>(__ldg(b + p), q);
      m += __popc(__ballot_sync(0xffffffffu, ok));
    }
    base += m * step;
    len = len - m * step < step ? len - m * step : step;
  }
  int m = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t p = base + lane + 32 * i;
    const bool ok = p < base + len && counted<T, kRight>(__ldg(b + p), q);
    m += __popc(__ballot_sync(0xffffffffu, ok));
  }
  return base + m;
}

// The splitter route for four queries: the count of each over the staged
// splitters (bisect4), then its last `shift` levels through L2, the four
// searches interleaved.
template <typename T, bool kRight>
__device__ __forceinline__ void splitter_count4(
    const T* __restrict__ b, int64_t nb, const T* split, int nsplit,
    bool split_odd, int shift, const T (&q)[kPerThread],
    int32_t (&c)[kPerThread]) {
  int32_t k[kPerThread];
  bisect4<T, kRight>(split, nsplit, split_odd, q, k);
  int64_t base[kPerThread], len[kPerThread];
  int32_t rel[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    // as in count_warp: b[(k - 1) << shift] counted, b[k << shift] not
    base[j] = k[j] ? (static_cast<int64_t>(k[j] - 1) << shift) + 1 : 0;
    const int64_t stop = static_cast<int64_t>(k[j]) << shift;
    len[j] = k[j] ? (stop < nb ? stop : nb) - base[j] : 0;
    rel[j] = 0;
  }
  for (int lev = shift - 1; lev >= 0; --lev) {
    T v[kPerThread];
    bool in[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int32_t cand = rel[j] + (1 << lev);
      in[j] = cand <= len[j];
      v[j] = in[j] ? __ldg(b + base[j] + cand - 1) : T(0);
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (in[j] && counted<T, kRight>(v[j], q[j])) rel[j] += 1 << lev;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    c[j] = static_cast<int32_t>(base[j] + rel[j]);
}

template <bool kRight, bool kVec, typename Src>
__global__ void __launch_bounds__(kSmemThreads)
    bucketize_tiled_kernel(const typename Src::Value* __restrict__ boundaries,
                           int64_t nb, int shift, int nsplit, int split_steps,
                           Src src, int32_t* __restrict__ out) {
  using T = typename Src::Value;
  const int64_t nq = src.n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* lohi = reinterpret_cast<int64_t*>(smem_raw);  // [2]
  T* red = reinterpret_cast<T*>(smem_raw + 16);          // [2][kWarps]
  T* split = red + 2 * kWarps;                           // [nsplit]
  T* win = split + nsplit;                               // [kWindow]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tiles = (nq + kCountTile - 1) / kCountTile;
  const int64_t per = (tiles + gridDim.x - 1) / gridDim.x;
  int64_t tile = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t last = tile + per < tiles ? tile + per : tiles;
  // group gr of a tile: its queries kTile * gr .. kTile * (gr + 1) - 1
  T q[kGroups][kPerThread];
  if (tile < last) {
#pragma unroll
    for (int gr = 0; gr < kGroups; ++gr)
      src.template load4<kVec>(tile * kCountTile + gr * kTile, q[gr]);
  }
  for (int i = threadIdx.x; i < nsplit; i += kSmemThreads)
    split[i] = __ldg(boundaries + (static_cast<int64_t>(i) << shift));
  const bool split_odd = (nsplit & 255) == 0;  // see window_split
  __syncthreads();
  for (; tile < last; ++tile) {
    T mn = q[0][0], mx = q[0][0];
#pragma unroll
    for (int gr = 0; gr < kGroups; ++gr) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (nan_high_less(q[gr][j], mn)) mn = q[gr][j];
        if (nan_high_less(mx, q[gr][j])) mx = q[gr][j];
      }
    }
    // the next tile's queries are in flight during this tile's searches
    const bool more = tile + 1 < last;
    T qn[kGroups][kPerThread];
    if (more) {
#pragma unroll
      for (int gr = 0; gr < kGroups; ++gr)
        src.template load4<kVec>((tile + 1) * kCountTile + gr * kTile,
                                 qn[gr]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T a = __shfl_xor_sync(0xffffffffu, mn, off);
      const T z = __shfl_xor_sync(0xffffffffu, mx, off);
      if (nan_high_less(a, mn)) mn = a;
      if (nan_high_less(mx, z)) mx = z;
    }
    if (lane == 0) {
      red[warp] = mn;
      red[kWarps + warp] = mx;
    }
    __syncthreads();
    if (warp < 2) {  // warp 0 counts the tile's min, warp 1 its max
      T v = red[warp * kWarps + (lane & (kWarps - 1))];
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1) {
        const T a = __shfl_xor_sync(0xffffffffu, v, off);
        if (warp == 0 ? nan_high_less(a, v) : nan_high_less(v, a)) v = a;
      }
      const int64_t c = count_warp<T, kRight>(boundaries, nb, split, nsplit,
                                              split_steps, shift, v, lane);
      if (lane == 0) lohi[warp] = c;
    }
    __syncthreads();
    const int64_t lo = lohi[0], hi = lohi[1];
    int32_t c[kGroups][kPerThread];
    if (hi - lo <= kWindow) {
      const int nw = static_cast<int>(hi - lo);
      for (int i = threadIdx.x; i < nw; i += kSmemThreads)
        win[i] = __ldg(boundaries + lo + i);
      __syncthreads();
#pragma unroll
      for (int gr = 0; gr < kGroups; ++gr) {
        if (nw > 0) {
          bisect4<T, kRight>(win, nw, (nw & 255) == 0, q[gr], c[gr]);
        } else {
#pragma unroll
          for (int j = 0; j < kPerThread; ++j) c[gr][j] = 0;
        }
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          c[gr][j] += static_cast<int32_t>(lo);
      }
    } else {
#pragma unroll
      for (int gr = 0; gr < kGroups; ++gr)
        splitter_count4<T, kRight>(boundaries, nb, split, nsplit, split_odd,
                                   shift, q[gr], c[gr]);
    }
#pragma unroll
    for (int gr = 0; gr < kGroups; ++gr)
      store4<kVec>(out, nq, tile * kCountTile + gr * kTile, c[gr]);
    if (more) {
#pragma unroll
      for (int gr = 0; gr < kGroups; ++gr)
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) q[gr][j] = qn[gr][j];
    }
  }
}

template <auto kKernel, typename Src>
int launch_smem(const typename Src::Value* bp, int64_t nb, Src src,
                int32_t* op, int persistent, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nb) * sizeof(typename Src::Value);
  int64_t tiles = (src.n + kTile - 1) / kTile;
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
  kKernel<<<grid, kSmemThreads, smem, stream>>>(bp, nb, src, op);
  return static_cast<int>(cudaGetLastError());
}

// The tiled route's grid and splitters: a persistent grid of at most the
// resident blocks; every 2^s-th boundary staged a block, s the least for
// which they number at most max_splitters and at most kSplittersPerTile for
// each tile the block takes (a block of the 256 tiles of a 524,288-query
// launch takes one: it stages 191 of 97,533 boundaries, not 3,048).
template <auto kKernel, typename Src>
int launch_tiled(const typename Src::Value* bp, int64_t nb, Src src,
                 int32_t* op, int64_t max_blocks, int max_splitters,
                 cudaStream_t stream) {
  const int64_t tiles = (src.n + kCountTile - 1) / kCountTile;
  unsigned grid = 0;
  int shift = 0, nsplit = 0;
  size_t smem = 0;
  int64_t cap = max_splitters;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {  // fewer splitters where a block takes few tiles
      const int64_t per = (tiles + grid - 1) / grid;
      if (per * kSplittersPerTile >= cap) break;
      cap = per * kSplittersPerTile;
    }
    shift = 0;
    while (((nb - 1) >> shift) + 1 > cap) ++shift;
    nsplit = static_cast<int>(((nb - 1) >> shift) + 1);
    smem = 16 + sizeof(typename Src::Value) *
                    (2 * kWarps + static_cast<size_t>(nsplit) + kWindow);
    cudaError_t err =
        repro::smem_grid<kKernel>(kSmemThreads, smem, tiles, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_blocks > 0 && grid > max_blocks)
      grid = static_cast<unsigned>(max_blocks);
  }
  kKernel<<<grid, kSmemThreads, smem, stream>>>(bp, nb, shift, nsplit,
                                                bisect_steps(nsplit), src, op);
  return static_cast<int>(cudaGetLastError());
}

// The shared-memory route of a query source: 1 <= nb, the boundaries in at
// most 232,448 bytes.
template <bool kVec, typename Src>
int smem_route(const typename Src::Value* bp, int64_t nb, Src src,
               int32_t* op, bool right, int persistent, cudaStream_t s) {
  if (nb < 1 ||
      nb * static_cast<int64_t>(sizeof(typename Src::Value)) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  return right ? launch_smem<bucketize_smem_kernel<true, kVec, Src>>(
                     bp, nb, src, op, persistent, s)
               : launch_smem<bucketize_smem_kernel<false, kVec, Src>>(
                     bp, nb, src, op, persistent, s);
}

// The tiled route of a query source, any nb >= 1.
template <bool kVec, typename Src>
int tiled_route(const typename Src::Value* bp, int64_t nb, Src src,
                int32_t* op, bool right, int64_t max_blocks,
                int max_splitters, cudaStream_t s) {
  return right ? launch_tiled<bucketize_tiled_kernel<true, kVec, Src>>(
                     bp, nb, src, op, max_blocks, max_splitters, s)
               : launch_tiled<bucketize_tiled_kernel<false, kVec, Src>>(
                     bp, nb, src, op, max_blocks, max_splitters, s);
}

bool misaligned(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) != 0;
}

template <typename T>
int launch(const void* b, int64_t nb, const void* q, int64_t nq, void* out,
           int flags, cudaStream_t stream) {
  const bool right = flags & 2, vec = flags & 8;
  const int persistent = (flags >> 4) & 1;
  const T* bp = static_cast<const T*>(b);
  const DenseQueries<T> src{static_cast<const T*>(q), nq};
  int32_t* op = static_cast<int32_t*>(out);
  if (vec && misaligned(q, out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return vec ? smem_route<true>(bp, nb, src, op, right, persistent, stream)
             : smem_route<false>(bp, nb, src, op, right, persistent, stream);
}

template <typename T>
int launch_count(const void* b, int64_t nb, const void* q, int64_t nq,
                 void* out, int flags, int64_t max_blocks, int max_splitters,
                 cudaStream_t s) {
  const bool right = flags & 2, vec = flags & 8;
  const T* bp = static_cast<const T*>(b);
  const DenseQueries<T> src{static_cast<const T*>(q), nq};
  int32_t* op = static_cast<int32_t*>(out);
  if (vec && misaligned(q, out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return vec ? tiled_route<true>(bp, nb, src, op, right, max_blocks,
                                 max_splitters, s)
             : tiled_route<false>(bp, nb, src, op, right, max_blocks,
                                  max_splitters, s);
}

}  // namespace

// flags, one bit each: 1 float32 (else int32); 2 right: count(b <= q) (else
// count(b < q)); the boundaries are staged in shared memory (1 <= nb,
// nb * 4 <= 232,448 bytes); as kernels/bucketize.py's launch_plan sets them,
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

// The tiled route, any nb >= 1. flags as repro_bucketize's 1, 2 and 8;
// max_blocks > 0 caps the persistent grid; max_splitters (>= 1) bounds the
// boundaries staged a block (every 2^s-th, s the least that fits). Neither
// changes a count.
extern "C" int repro_bucketize_count(const void* boundaries, int64_t nb,
                                     const void* queries, int64_t nq,
                                     void* out, int flags, int64_t max_blocks,
                                     int max_splitters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq <= 0) return 0;
  if (nb < 1 || max_splitters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return (flags & 1)
             ? launch_count<float>(boundaries, nb, queries, nq, out, flags,
                                   max_blocks, max_splitters, s)
             : launch_count<int32_t>(boundaries, nb, queries, nq, out, flags,
                                     max_blocks, max_splitters, s);
}

// bucketize_packed_kernel: int32 boundaries [nb] (sorted, nb >= 1) against
// the nvals packed queries of `words` (nwords uint32 lanes of bits-bit codes
// plus offset, any 4-byte alignment); out: int32 counts [nvals], 16-byte
// aligned. flags: 2 right (as repro_bucketize); 32 tiled: the tiled route
// (max_blocks, max_splitters as repro_bucketize_count's), else the
// shared-memory route (nb * 4 <= 232,448 bytes; 16 persistent as
// repro_bucketize's). Each thread takes four consecutive queries.
extern "C" int repro_bucketize_packed(const void* boundaries, int64_t nb,
                                      const void* words, int64_t nwords,
                                      int bits, int32_t offset, int64_t nvals,
                                      void* out, int flags, int64_t max_blocks,
                                      int max_splitters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits < 1 || bits > 32 || nb < 1 || max_splitters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nvals <= 0) return 0;
  if (misaligned(out, out)) return static_cast<int>(cudaErrorMisalignedAddress);
  const PackedQueries src{repro::make_packed(words, nwords, bits, offset),
                          nvals};
  const int32_t* bp = static_cast<const int32_t*>(boundaries);
  int32_t* op = static_cast<int32_t*>(out);
  const bool right = flags & 2;
  if (flags & 32)
    return tiled_route<true>(bp, nb, src, op, right, max_blocks,
                             max_splitters, s);
  return smem_route<true>(bp, nb, src, op, right, (flags >> 4) & 1, s);
}

extern "C" const char* repro_bucketize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
