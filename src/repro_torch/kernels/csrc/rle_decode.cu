// Hopper kernel for `rle_decode`: expand an RLE column held as capacity
// buffers (values / starts / ends [cap]) plus a device count n into a dense
// [nrows] array. Rows in gaps, and rows of runs at or past n, get `fill`.
//
// Replaces the Pallas TPU kernel rle_decode_kernel in
// src/repro/kernels/rle_decode.py: run metadata resident in VMEM, 2048-row
// output tiles, a bisection over `ends` plus a gather per row, fused so the
// run id never reaches HBM.
//
// What bounds it on the H100: bytes. The least work is one 4-byte write a row
// plus one read of the runs (12 bytes a run), at 3.35 TB/s; on the main path
// (550 runs over 59,986,052 rows) the output is all of it.
//
// Design: rle_tile.cuh's tile walk, whose run value is a 32-bit word loaded
// from `values`, so one kernel serves int32 and float32; the wrapper passes
// `fill` already cast to the value dtype, as a bit pattern. A warp bounds a
// 256-row tile's runs by two counts of ends (a warp search, skipped while the
// tile stays inside the run of the previous one); a tile inside one run is a
// pure 16-byte write stream, a tile that meets several runs stages them in
// shared memory and resolves its rows there, and only repeated ends send rows
// to a bisection through L2. n is read on the device, so the caller never
// synchronises to learn it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rle_tile.cuh"

namespace {

struct WordValues {  // run j's value: values[j]
  const uint32_t* values;
  __device__ __forceinline__ uint32_t operator()(int64_t j) const {
    return __ldg(values + j);
  }
};

}  // namespace

// values: 32-bit words [cap]; starts/ends: int32 [cap]; n_runs: int32 scalar on
// the device; fill: the fill value's 32-bit pattern; out: 32-bit words [nrows],
// 16-byte aligned. max_blocks > 0 caps the grid (the output does not depend
// on it).
extern "C" int repro_rle_decode(const void* values, const void* starts,
                                const void* ends, const void* n_runs,
                                int64_t cap, int64_t nrows, uint32_t fill,
                                void* out, int64_t max_blocks, void* stream) {
  return repro::rle::launch_tiles(
      WordValues{static_cast<const uint32_t*>(values)},
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(n_runs), cap, nrows, fill,
      static_cast<uint32_t*>(out), max_blocks,
      static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_rle_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
