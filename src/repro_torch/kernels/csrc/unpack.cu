// Hopper kernels for bit-packed columns (DESIGN.md §11): unsigned b-bit codes
// (b in 1..32) densely concatenated into uint32 lanes, value i in bits
// [i*b, i*b + b) of the stream, little-endian within a lane; the logical
// value is the code plus `offset` as an int32 wrap-add.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/unpack.py, each
// of which keeps the whole word stream resident in VMEM (up to 2M words) and
// streams 2048-value output tiles through the grid:
//   * unpack_kernel: shift + mask expansion to int32;
//   * bucketize_packed_kernel: the codes are extracted in registers and fed
//     to the bucketize bisection, so the unpacked queries never reach HBM;
//   * rle_decode_packed_kernel: rle_decode whose run value is extracted from
//     the packed words at the run id.
//
// What bounds them on the H100: bytes. The least work reads each packed word
// once (N*b/8 bytes) plus the boundaries or run bounds once, and writes one
// int32 per output; at b = 21 the 4-byte output is 60% of it. The second lane
// load of a straddling value, and the bisection probes, hit L1/L2.
//
// Design:
//   * extract(): one thread per value. The bit offset i*b is a 64-bit product
//     (the reference splits it to stay inside int32, unpack.py:52); two lane
//     loads through the read-only path, the second guarded at the stream's
//     end; __funnelshift_r joins them; the mask is all ones at b = 32; the
//     offset is added as a uint32 wrap-add and the result reinterpreted as
//     int32, which makes width-32 passthrough exact.
//   * bucketize_packed: the bisection of csrc/bisect.cuh (shared with
//     bucketize.cu, so the packed route compares exactly as the unpacked one).
//     Boundaries up to 58,112 are staged in shared memory by a persistent grid
//     (sized by smem_grid, which reads the occupancy once per kernel and
//     device and opts in beyond 48 KB only); above that the bisection reads them through L2. There is no VMEM-style
//     ceiling on the word stream: words are read through L2.
//   * rle_decode_packed: rle_decode.cu's left bisection over `ends`, clamp to
//     cap - 1, coverage test (row in [start, end] and run < n) and `fill`; the
//     value is extracted at the run id. n is read on the device, so the caller
//     never synchronises to learn it.
// Each launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError(). Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bisect.cuh"

namespace {

using repro::bisect;
using repro::bisect_steps;

constexpr int kThreads = 256;
constexpr int kSmemThreads = 1024;

struct Packed {
  const uint32_t* words;
  int64_t nwords;
  int bits;
  uint32_t mask;    // (1 << bits) - 1, all ones at bits = 32
  uint32_t offset;  // the int32 offset's bit pattern
};

__device__ __forceinline__ int32_t extract(const Packed& p, int64_t i) {
  const uint64_t bit = static_cast<uint64_t>(i) * static_cast<uint64_t>(p.bits);
  const int64_t w = static_cast<int64_t>(bit >> 5);
  const unsigned shift = static_cast<unsigned>(bit & 31);
  const uint32_t lo = __ldg(p.words + w);
  const uint32_t hi = (w + 1 < p.nwords) ? __ldg(p.words + w + 1) : 0u;
  const uint32_t code = __funnelshift_r(lo, hi, shift) & p.mask;
  return static_cast<int32_t>(code + p.offset);
}

__global__ void unpack_kernel(Packed p, int64_t nvals,
                              int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvals; i += stride) {
    out[i] = extract(p, i);
  }
}

template <bool kRight>
__global__ void __launch_bounds__(kSmemThreads)
    bucketize_packed_smem_kernel(const int32_t* __restrict__ boundaries,
                                 int64_t nb, int steps, Packed p,
                                 int64_t nvals, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int32_t* sb = reinterpret_cast<int32_t*>(smem_raw);
  for (int64_t i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = boundaries[i];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvals; i += stride) {
    out[i] = bisect<int32_t, kRight, false>(sb, nb, steps, extract(p, i));
  }
}

template <bool kRight>
__global__ void bucketize_packed_global_kernel(
    const int32_t* __restrict__ boundaries, int64_t nb, int steps, Packed p,
    int64_t nvals, int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvals; i += stride) {
    out[i] = bisect<int32_t, kRight, true>(boundaries, nb, steps,
                                           extract(p, i));
  }
}

__global__ void rle_decode_packed_kernel(Packed p,
                                         const int32_t* __restrict__ starts,
                                         const int32_t* __restrict__ ends,
                                         const int32_t* __restrict__ n_runs,
                                         int64_t cap, int steps, int64_t nrows,
                                         int32_t fill,
                                         int32_t* __restrict__ out) {
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
    out[row] = covered ? extract(p, run) : fill;
  }
}

Packed make_packed(const void* words, int64_t nwords, int bits,
                   int32_t offset) {
  Packed p;
  p.words = static_cast<const uint32_t*>(words);
  p.nwords = nwords;
  p.bits = bits;
  p.mask = bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
  p.offset = static_cast<uint32_t>(offset);
  return p;
}

unsigned flat_grid(int64_t n) {
  int64_t grid = (n + kThreads - 1) / kThreads;
  if (grid > 0x7fffffff) grid = 0x7fffffff;
  return static_cast<unsigned>(grid);
}

}  // namespace

// words: uint32 lanes [nwords]; out: int32 [nvals]. Bits in 1..32.
extern "C" int repro_unpack(const void* words, int64_t nwords, int bits,
                            int32_t offset, int64_t nvals, void* out,
                            void* stream) {
  if (bits < 1 || bits > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (nvals == 0) return 0;
  unpack_kernel<<<flat_grid(nvals), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      make_packed(words, nwords, bits, offset), nvals,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// boundaries: sorted int32 [nb]; out: int32 counts [nvals]. right: 1 ->
// count(b <= q), 0 -> count(b < q). global: 0 -> boundaries staged in shared
// memory (nb * 4 <= 232,448 bytes), 1 -> bisection through L2 (any nb).
extern "C" int repro_bucketize_packed(const void* boundaries, int64_t nb,
                                      const void* words, int64_t nwords,
                                      int bits, int32_t offset, int64_t nvals,
                                      void* out, int right, int global,
                                      void* stream) {
  if (bits < 1 || bits > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (nvals == 0 || nb == 0) return 0;
  using Kernel = void (*)(const int32_t*, int64_t, int, Packed, int64_t,
                          int32_t*);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Packed p = make_packed(words, nwords, bits, offset);
  const int steps = bisect_steps(nb);
  const int32_t* bp = static_cast<const int32_t*>(boundaries);
  int32_t* op = static_cast<int32_t*>(out);
  if (global) {
    Kernel k = right ? bucketize_packed_global_kernel<true>
                     : bucketize_packed_global_kernel<false>;
    k<<<flat_grid(nvals), kThreads, 0, s>>>(bp, nb, steps, p, nvals, op);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(nb) * sizeof(int32_t);
  const int64_t blocks = (nvals + kSmemThreads - 1) / kSmemThreads;
  unsigned grid = 0;
  cudaError_t err =
      right ? repro::smem_grid<bucketize_packed_smem_kernel<true>>(
                  kSmemThreads, smem, blocks, &grid)
            : repro::smem_grid<bucketize_packed_smem_kernel<false>>(
                  kSmemThreads, smem, blocks, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  Kernel k = right ? bucketize_packed_smem_kernel<true>
                   : bucketize_packed_smem_kernel<false>;
  k<<<grid, kSmemThreads, smem, s>>>(bp, nb, steps, p, nvals, op);
  return static_cast<int>(cudaGetLastError());
}

// words: the cap run values packed; starts/ends: int32 [cap]; n_runs: int32
// scalar on the device; fill: int32; out: int32 [nrows].
extern "C" int repro_rle_decode_packed(const void* words, int64_t nwords,
                                       int bits, int32_t offset,
                                       const void* starts, const void* ends,
                                       const void* n_runs, int64_t cap,
                                       int64_t nrows, int32_t fill, void* out,
                                       void* stream) {
  if (bits < 1 || bits > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (nrows == 0 || cap == 0) return 0;
  rle_decode_packed_kernel<<<flat_grid(nrows), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      make_packed(words, nwords, bits, offset),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(n_runs), cap, bisect_steps(cap), nrows, fill,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_unpack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
