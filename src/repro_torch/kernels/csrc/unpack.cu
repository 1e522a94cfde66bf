// Hopper kernels for bit-packed columns (DESIGN.md §11; the stream layout and
// extract() are csrc/packed.cuh's).
//
// Replaces two of the three Pallas TPU kernels of src/repro/kernels/unpack.py,
// each of which keeps the whole word stream resident in VMEM (up to 2M words)
// and streams 2048-value output tiles through the grid:
//   * unpack_kernel: shift + mask expansion to int32;
//   * rle_decode_packed_kernel: rle_decode whose run value is extracted from
//     the packed words at the run id.
// The third, bucketize_packed_kernel, is a query source of bucketize.cu's two
// routes (PackedQueries), so it compares exactly as the unpacked routes do.
//
// What bounds them on the H100: bytes. unpack reads each packed word once
// (N*b/8 bytes) and writes one int32 per value: at b = 24 it is 7 bytes a
// value. rle_decode_packed is bound by its output, 4 bytes a row.
//
// Design:
//   * unpack: 128 consecutive values at width b fill exactly 4b lanes, which
//     start at lane 4b*g of group g, so a group is 16-byte aligned whenever
//     the words are. A warp takes one group at a time, in a grid-stride loop
//     over a persistent grid (as many blocks as the card keeps resident,
//     launch.cuh's smem_grid; the occupancy it reads counts the static
//     staging below). Lanes 0..b-1 load the group's 4b lanes with one
//     evict-first 16-byte load each, two groups in flight a warp, and store
//     them in the warp's staging row of shared memory; each lane then
//     extracts its four consecutive values from the at most five lanes that
//     cover them (codes4) and writes them with one 16-byte store. The ragged
//     last group (fewer than 128 values), and every group of words or an
//     output that is not 16-byte aligned, take the scalar path: extract()
//     a value, four values a lane. A value is a function of its index alone,
//     so the grid does not change the output.
//   * rle_decode_packed: rle_tile.cuh's tile walk (shared with rle_decode.cu),
//     whose run value is extract() at the run id: once a tile for a tile
//     inside one run (then a pure 16-byte write stream), once a run when a
//     tile stages the window of runs it meets in shared memory. n is read on
//     the device, so the caller never synchronises to learn it. The runs are
//     few (128 at 4 bits on the main path) against 2^23 rows.
// Each launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError(). Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "packed.cuh"
#include "rle_tile.cuh"

namespace {

using repro::extract;
using repro::make_packed;
using repro::Packed;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 128;  // values a warp expands a step, four a lane
constexpr int kInFlight = 2;  // groups whose loads a warp issues together

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    unpack_kernel(Packed p, int64_t nvals, int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t stage[kWarps][kGroup];  // 4b <= 128 lanes
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t groups = (nvals + kGroup - 1) / kGroup;
  int64_t g = first;
  if constexpr (kVec) {
    uint32_t* row = stage[warp];
    const int b = p.bits;
    const int64_t full = nvals / kGroup;
    const int4* src = reinterpret_cast<const int4*>(p.words);
    // this lane's values 4 lane .. 4 lane + 3 of a group: bits
    // [4 lane b, 4 lane b + 4b), in the `need` lanes from w0 (the last is at
    // most lane 4b - 1 of the group)
    const int bit0 = 4 * lane * b;
    const int w0 = bit0 >> 5, s0 = bit0 & 31;
    const int need = (s0 + 4 * b + 31) >> 5;
    for (; g < full; g += kInFlight * warps) {
      int4 r[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int64_t gu = g + u * warps;
        if (gu < full && lane < b) r[u] = __ldcs(src + gu * b + lane);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int64_t gu = g + u * warps;
        if (gu < full) {  // uniform across the warp
          __syncwarp();  // the previous group's reads of the row are done
          if (lane < b) reinterpret_cast<int4*>(row)[lane] = r[u];
          __syncwarp();
          uint32_t x[5];
#pragma unroll
          for (int k = 0; k < 5; ++k) x[k] = k < need ? row[w0 + k] : 0u;
          int32_t v[4];
          repro::codes4(p, x, static_cast<unsigned>(s0), v);
          reinterpret_cast<int4*>(out + gu * kGroup)[lane] =
              make_int4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    g = full + first;  // the ragged last group, if any
  }
  for (; g < groups; g += warps) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = g * kGroup + lane + 32 * j;
      if (i < nvals) out[i] = extract(p, i);
    }
  }
}

struct PackedValues {  // run j's value: extract(p, j)
  Packed p;
  __device__ __forceinline__ uint32_t operator()(int64_t j) const {
    return static_cast<uint32_t>(extract(p, j));
  }
};

template <auto kKernel>
int launch_unpack(const Packed& p, int64_t nvals, int32_t* out,
                  int64_t max_blocks, cudaStream_t stream) {
  const int64_t groups = (nvals + kGroup - 1) / kGroup;
  unsigned grid = 0;
  cudaError_t err = repro::smem_grid<kKernel>(
      kThreads, 0, (groups + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_blocks > 0 && grid > max_blocks)
    grid = static_cast<unsigned>(max_blocks);
  kKernel<<<grid, kThreads, 0, stream>>>(p, nvals, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words: uint32 lanes [nwords]; out: int32 [nvals]. Bits in 1..32.
// max_blocks > 0 caps the grid (the output does not depend on it). Words and
// out both 16-byte aligned take the group route, else the scalar one.
extern "C" int repro_unpack(const void* words, int64_t nwords, int bits,
                            int32_t offset, int64_t nvals, void* out,
                            int64_t max_blocks, void* stream) {
  if (bits < 1 || bits > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (nvals == 0) return 0;
  const Packed p = make_packed(words, nwords, bits, offset);
  int32_t* op = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(words) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return vec ? launch_unpack<unpack_kernel<true>>(p, nvals, op, max_blocks, s)
             : launch_unpack<unpack_kernel<false>>(p, nvals, op, max_blocks,
                                                   s);
}

// words: the cap run values packed; starts/ends: int32 [cap]; n_runs: int32
// scalar on the device; fill: int32; out: int32 [nrows], 16-byte aligned.
// max_blocks > 0 caps the grid (the output does not depend on it).
extern "C" int repro_rle_decode_packed(const void* words, int64_t nwords,
                                       int bits, int32_t offset,
                                       const void* starts, const void* ends,
                                       const void* n_runs, int64_t cap,
                                       int64_t nrows, int32_t fill, void* out,
                                       int64_t max_blocks, void* stream) {
  if (bits < 1 || bits > 32) return static_cast<int>(cudaErrorInvalidValue);
  return repro::rle::launch_tiles(
      PackedValues{make_packed(words, nwords, bits, offset)},
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(n_runs), cap, nrows,
      static_cast<uint32_t>(fill), static_cast<uint32_t*>(out), max_blocks,
      static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_unpack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
