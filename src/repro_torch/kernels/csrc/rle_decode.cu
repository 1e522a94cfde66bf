// Hopper kernel for `rle_decode`: expand an RLE column held as capacity
// buffers (values / starts / ends [cap]) plus a device count n into a dense
// [nrows] array. Rows in gaps, and rows of runs at or past n, get `fill`.
//
// Replaces the Pallas TPU kernel rle_decode_kernel in
// src/repro/kernels/rle_decode.py: run metadata resident in VMEM, 2048-row
// output tiles, a bisection over `ends` plus a gather, fused so the run id never
// reaches HBM.
//
// What bounds it on the H100: bytes. The least work is one read of the three
// run buffers (12 bytes a run) and one 4-byte write per row, at 3.35 TB/s; the
// output dominates. The per-row bisection re-reads `ends`, but from L2.
//
// Design: one thread per row in a grid-stride loop. Each thread runs the
// left bisection of rle_decode.py:31 (the count of ends < row, i.e. the first
// run whose end is >= row) over `ends` in global memory through the read-only
// path, clamps it to cap-1, and applies the coverage test of rle_decode.py:35
// (row >= starts[run] && row <= ends[run] && run < n). Values move as 32-bit
// words, so one kernel serves int32 and float32; the wrapper passes `fill`
// already cast to the value dtype, as a bit pattern. n is read on the device,
// so the caller never synchronises to learn it. Neighbouring rows fall in the
// same run, so the bisection paths of a warp agree and their loads coalesce.
// A run-parallel writer that reads each run once is a later optimisation.
// The launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError(). Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void rle_decode_kernel(const uint32_t* __restrict__ values,
                                  const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ ends,
                                  const int32_t* __restrict__ n_runs,
                                  int64_t cap, int steps, int64_t nrows,
                                  uint32_t fill, uint32_t* __restrict__ out) {
  const int64_t n = __ldg(n_runs);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < nrows; row += stride) {
    int64_t lo = 0;  // count of ends < row
    for (int k = steps - 1; k >= 0; --k) {
      const int64_t cand = lo + (int64_t(1) << k);
      if (cand <= cap && static_cast<int64_t>(__ldg(ends + (cand - 1))) < row)
        lo = cand;
    }
    const int64_t run = lo < cap - 1 ? lo : cap - 1;
    const int64_t s = __ldg(starts + run);
    const int64_t e = __ldg(ends + run);
    const bool covered = row >= s && row <= e && run < n;
    out[row] = covered ? __ldg(values + run) : fill;
  }
}

int bisect_steps(int64_t cap) {  // ceil(log2(cap + 1)), at least 1
  int s = 0;
  while ((int64_t(1) << s) <= cap) ++s;
  return s < 1 ? 1 : s;
}

}  // namespace

// values: 32-bit words [cap]; starts/ends: int32 [cap]; n_runs: int32 scalar on
// the device; fill: the fill value's 32-bit pattern; out: 32-bit words [nrows].
extern "C" int repro_rle_decode(const void* values, const void* starts,
                                const void* ends, const void* n_runs,
                                int64_t cap, int64_t nrows, uint32_t fill,
                                void* out, void* stream) {
  int64_t grid = (nrows + kThreads - 1) / kThreads;
  if (grid > 0x7fffffff) grid = 0x7fffffff;
  rle_decode_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(values), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(ends), static_cast<const int32_t*>(n_runs),
      cap, bisect_steps(cap), nrows, fill, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_rle_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
