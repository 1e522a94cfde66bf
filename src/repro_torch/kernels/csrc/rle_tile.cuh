// The tile walk shared by the two RLE decoders (rle_decode.cu, unpack.cu):
// expand runs held as capacity buffers (starts / ends [cap], a value source,
// a device count n) into a dense [nrows] array of 32-bit words. For each row,
// run = min(count of ends < row, cap - 1); the row gets the run's value if
// starts[run] <= row <= ends[run] and run < n, else `fill`. `ends` is
// non-decreasing (under the sentinel invariant of core/compress.py strictly
// increasing, its padded tail equal to nrows).
//
// The run id is monotone in the row, so every row of a tile [r0, rl] has its
// run in [base, top] = [min(lo0, cap-1), min(lo1, cap-1)], lo0 and lo1 the
// counts of ends < r0 and < rl; and run(row) = base + the count of
// ends[base, top) < row, the clamp included. A warp owns a tile of kTile
// rows and computes lo0 and lo1 once for it; no row searches all of `ends`.
// The tile then takes one of three routes, uniform across the warp:
//   * one run (base == top; the long runs of the main path): the run's start,
//     end and value sit in registers; each lane writes its rows as the value
//     or `fill`, 16 bytes a store. A pure write stream.
//   * window (2 <= top - base + 1 <= kStage): the window's starts, ends and
//     values are staged once in the warp's part of shared memory (a packed
//     value is extracted once a run, not once a row), the bounds relative
//     to r0 so rows compare in 32 bits. Each end of runs base .. top - 1
//     adds one to a per-row counter at row end + 1, and a row's run is base
//     plus the inclusive prefix sum of the counters up to it (a lane sums
//     its four rows, a shuffle scan the lanes): no row searches. With
//     strictly increasing ends a window never holds more runs than the tile
//     has rows, so kStage = kTile serves every such tile.
//   * large window (more than kStage runs, possible only where ends repeat):
//     each row bisects ends[base, top) through L2, in the kernel.
// lo0 and lo1 come from a warp search over [lb, cap), lb being the previous
// tile's lo1 (rows only grow along a warp's tiles): one round probes
// ends[lb + 2^j - 1] on lane j, later rounds 32 evenly spaced ends, and a
// round ends with a ballot. Before searching, a tile tests ends[lb] >= rl
// (held in a register while the previous tile was that run): then the whole
// tile lies in run lb, and the tile costs no load at all.
//
// Each warp walks a contiguous range of tiles, so a long run is searched
// once per warp that meets it. The grid is as large as the card keeps
// resident (capped by max_blocks when positive); a row's value is a function
// of the row alone, so the output does not depend on the grid.
// tests/torch_twins.py's rle_tiles_emulated repeats the walk in numpy.
//
// What bounds it on the H100: bytes, 4 a row written, plus one read of the
// runs a tile meets (12 bytes a run). The launch goes on the caller's stream,
// allocates nothing, and returns cudaGetLastError(). Offsets are 64-bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace repro {
namespace rle {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;   // rows a warp tile: two rounds of 32 lanes x 4
constexpr int kStage = kTile;  // runs a warp stages
constexpr int kMinBlocks = 4;  // resident a SM: 64 registers, no spills
constexpr unsigned kFull = 0xffffffffu;

// Narrow [a, b], which holds the count of ends[j] < x (j in [a, b), ends
// sorted) plus a, by the ballot of this round's probes. Lane `lane` probed
// index p_lane; `gallop` rounds probe a + 2^lane - 1, the others
// a + (lane + 1) * step - 1. The accepted probes are a prefix of the lanes.
__device__ __forceinline__ void narrow(int64_t& a, int64_t& b, bool gallop,
                                       int64_t step, unsigned ballot) {
  const int m = __popc(ballot);
  int64_t na, nb;
  if (gallop) {
    na = m == 0 ? a : a + (int64_t(1) << (m - 1));
    nb = a + (int64_t(1) << m) - 1;  // the first refused probe, or past b
  } else {
    na = a + m * step;
    nb = na + step - 1;
  }
  a = na;
  b = nb < b ? nb : b;
}

__device__ __forceinline__ int64_t probe_at(int64_t a, bool gallop,
                                            int64_t step, int lane) {
  return gallop ? a + (int64_t(1) << lane) - 1
                : a + static_cast<int64_t>(lane + 1) * step - 1;
}

// The counts of ends < x0 and of ends < x1 over a sorted `ends`, given that
// every ends[j] with j < lb is below both: a gallop round from lb, then
// rounds of 32 evenly spaced probes, both searches' loads in flight
// together. Every lane returns the same counts.
__device__ __forceinline__ void warp_counts(const int32_t* __restrict__ ends,
                                            int64_t lb, int64_t cap,
                                            int64_t x0, int64_t x1, int lane,
                                            int64_t* c0, int64_t* c1) {
  int64_t a0 = lb, b0 = cap, a1 = lb, b1 = cap;
  bool gallop = true;
  while (b0 > a0 || b1 > a1) {
    const bool last0 = !gallop && b0 - a0 <= 32;
    const bool last1 = !gallop && b1 - a1 <= 32;
    const int64_t s0 = last0 ? 1 : (b0 - a0 + 31) / 32;
    const int64_t s1 = last1 ? 1 : (b1 - a1 + 31) / 32;
    const int64_t p0 = last0 ? a0 + lane : probe_at(a0, gallop, s0, lane);
    const int64_t p1 = last1 ? a1 + lane : probe_at(a1, gallop, s1, lane);
    const bool ok0 = b0 > a0 && p0 < b0 &&
                     static_cast<int64_t>(__ldg(ends + p0)) < x0;
    const bool ok1 = b1 > a1 && p1 < b1 &&
                     static_cast<int64_t>(__ldg(ends + p1)) < x1;
    const unsigned v0 = __ballot_sync(kFull, ok0);
    const unsigned v1 = __ballot_sync(kFull, ok1);
    if (last0) { a0 += __popc(v0); b0 = a0; }
    else if (b0 > a0) narrow(a0, b0, gallop, s0, v0);
    if (last1) { a1 += __popc(v1); b1 = a1; }
    else if (b1 > a1) narrow(a1, b1, gallop, s1, v1);
    gallop = false;
  }
  *c0 = a0;
  *c1 = a1;
}

// The count of e[0, m) < row for sorted e, through L2.
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ e,
                                               int64_t m, int64_t row) {
  int64_t lo = 0;
  while (m > 0) {
    const int64_t half = m >> 1;
    if (static_cast<int64_t>(__ldg(e + lo + half)) < row) {
      lo += half + 1;
      m -= half + 1;
    } else {
      m = half;
    }
  }
  return lo;
}

// A run bound relative to the tile's first row r0, clamped to [-1, kTile]:
// rows r0 .. r0 + kTile - 1 compare with it as with the bound itself.
__device__ __forceinline__ int32_t rel(int32_t bound, int64_t r0) {
  const int64_t d = static_cast<int64_t>(bound) - r0;
  return static_cast<int32_t>(d < -1 ? -1 : (d > kTile ? kTile : d));
}

// Four words at rows a .. a+3: one 16-byte store when all four are rows,
// scalar stores for the ragged tail. `out` is 16-byte aligned.
__device__ __forceinline__ void store4(uint32_t* __restrict__ out, int64_t a,
                                       int64_t nrows, const uint32_t (&w)[4]) {
  if (a + 3 < nrows) {
    *reinterpret_cast<uint4*>(out + a) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (a + j < nrows) out[a + j] = w[j];
  }
}

// Src: a functor giving run j's value as a 32-bit word (a load, or an
// extract from packed words).
template <typename Src>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rle_tiles_kernel(Src src, const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ ends,
                     const int32_t* __restrict__ n_runs, int64_t cap,
                     int64_t nrows, uint32_t fill,
                     uint32_t* __restrict__ out) {
  __shared__ int32_t st_start[kWarps][kStage];
  __shared__ int32_t st_end[kWarps][kStage];
  __shared__ uint32_t st_val[kWarps][kStage];
  __shared__ __align__(16) int32_t st_cnt[kWarps][kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* s_start = st_start[warp];
  int32_t* s_end = st_end[warp];
  uint32_t* s_val = st_val[warp];
  int32_t* s_cnt = st_cnt[warp];
  const int64_t n = __ldg(n_runs);
  const int64_t tiles = (nrows + kTile - 1) / kTile;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t per = (tiles + warps - 1) / warps;
  int64_t tile = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * per;
  const int64_t last = tile + per < tiles ? tile + per : tiles;
  int64_t lb = 0;    // count of ends below every row still to come
  int64_t cur = -1;  // the run held in registers (cs, ce, cv), -1 none
  int64_t cs = 0, ce = 0;
  uint32_t cv = 0;
  for (; tile < last; ++tile) {
    const int64_t r0 = tile * kTile;
    const int64_t rl = (r0 + kTile < nrows ? r0 + kTile : nrows) - 1;
    int64_t lo0 = cap, lo1 = cap;
    if (lb < cap) {
      const int64_t eb = cur == lb ? ce : static_cast<int64_t>(__ldg(ends + lb));
      if (eb >= rl) {
        lo0 = lo1 = lb;
      } else {
        warp_counts(ends, lb, cap, r0, rl, lane, &lo0, &lo1);
      }
    }
    lb = lo1;
    const int64_t base = lo0 < cap - 1 ? lo0 : cap - 1;
    const int64_t top = lo1 < cap - 1 ? lo1 : cap - 1;
    if (base == top) {  // one run
      if (cur != base) {
        cur = base;
        cs = __ldg(starts + base);
        ce = __ldg(ends + base);
        cv = src(base);
      }
      const bool valid = cur < n;
#pragma unroll
      for (int i = 0; i < kTile / 128; ++i) {
        const int64_t a = r0 + i * 128 + lane * 4;
        if (a > rl) break;
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t row = a + j;
          w[j] = valid && row >= cs && row <= ce ? cv : fill;
        }
        store4(out, a, nrows, w);
      }
    } else if (top - base < kStage) {  // window
      const int wn = static_cast<int>(top - base + 1);
      const int m = wn - 1;  // ends counted: those of runs base .. top - 1
      // run base + k is below n exactly when k < kn
      const int64_t kn64 = n - base;
      const int kn = kn64 < 0 ? 0 : (kn64 > wn ? wn : static_cast<int>(kn64));
      __syncwarp();  // the previous window's readers are done
      *reinterpret_cast<int4*>(s_cnt + lane * 4) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(s_cnt + 128 + lane * 4) = make_int4(0, 0, 0, 0);
      for (int j = lane; j < wn; j += 32) {  // bounds relative to r0
        s_start[j] = rel(__ldg(starts + base + j), r0);
        s_end[j] = rel(__ldg(ends + base + j), r0);
        s_val[j] = src(base + j);
      }
      __syncwarp();
      // ends[base + j] lies in [r0, rl) for j < m: count it at row end + 1
      for (int j = lane; j < m; j += 32) {
        const int pos = s_end[j] + 1;
        if (pos >= 0 && pos < kTile) atomicAdd(s_cnt + pos, 1);
      }
      __syncwarp();
      // k of a row = the inclusive prefix sum of the counts: a lane sums
      // its four rows, the warp scans the lanes' sums
      int carry = 0;
#pragma unroll
      for (int i = 0; i < kTile / 128; ++i) {
        const int q = i * 128 + lane * 4;  // the lane's first row, in the tile
        const int4 c = *reinterpret_cast<const int4*>(s_cnt + q);
        const int k[4] = {c.x, c.x + c.y, c.x + c.y + c.z,
                          c.x + c.y + c.z + c.w};
        int incl = k[3];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += t;
        }
        const int before = carry + incl - k[3];
        carry += __shfl_sync(kFull, incl, 31);
        if (r0 + q > rl) continue;
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = before + k[j];
          w[j] = kk < kn && q + j >= s_start[kk] && q + j <= s_end[kk]
                     ? s_val[kk] : fill;
        }
        store4(out, r0 + q, nrows, w);
      }
    } else {  // large window: repeated ends
#pragma unroll
      for (int i = 0; i < kTile / 128; ++i) {
        const int64_t a = r0 + i * 128 + lane * 4;
        if (a > rl) break;
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t row = a + j;
          const int64_t run = base + lower_bound(ends + base, top - base, row);
          w[j] = run < n && row >= __ldg(starts + run) &&
                         row <= __ldg(ends + run)
                     ? src(run) : fill;
        }
        store4(out, a, nrows, w);
      }
    }
  }
}

// Launch the walk on `stream`: a grid of as many blocks as the card keeps
// resident (fewer for a short column), capped by max_blocks when positive.
template <typename Src>
int launch_tiles(Src src, const int32_t* starts, const int32_t* ends,
                 const int32_t* n_runs, int64_t cap, int64_t nrows,
                 uint32_t fill, uint32_t* out, int64_t max_blocks,
                 cudaStream_t stream) {
  if (nrows == 0 || cap == 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (nrows + kTile - 1) / kTile;
  const int64_t blocks = (tiles + kWarps - 1) / kWarps;
  unsigned grid = 0;
  const cudaError_t err =
      smem_grid<rle_tiles_kernel<Src>>(kThreads, 0, blocks, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_blocks > 0 && grid > max_blocks)
    grid = static_cast<unsigned>(max_blocks);
  rle_tiles_kernel<Src><<<grid, kThreads, 0, stream>>>(
      src, starts, ends, n_runs, cap, nrows, fill, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rle
}  // namespace repro
