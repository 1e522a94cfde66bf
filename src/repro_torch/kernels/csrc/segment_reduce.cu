// Hopper kernel for `segment_sum`: float32 sum of values per segment id, ids
// outside [0, G) dropped, G <= 4096.
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
// the same bits on every run, so no float atomicAdd whose order varies is used.
//   1. segsum_partial_kernel: block b takes the fixed row chunk
//      [b * rows_per_block, (b + 1) * rows_per_block). Each of its 8 warps keeps
//      a private [G] float array in shared memory (128 KiB at G = 4096). In each
//      step a warp takes 32 consecutive rows; lanes holding equal ids find each
//      other with __match_any_sync, and the lowest lane of each group adds the
//      group's values, in lane order, into the warp's array. No two lanes ever
//      write one address in a step, and the order of every add is fixed. The
//      block then sums its warps' arrays in warp order into its row of the
//      [nblocks, G] scratch that the wrapper allocates.
//   2. segsum_final_kernel: one thread per id sums its scratch column over the
//      blocks, in block order.
// The chunking depends only on N, so the result does not depend on the card's
// SM count or on scheduling. Both launches go on the caller's stream, allocate
// nothing, and the entry returns cudaGetLastError(). Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFinalThreads = 256;

__global__ void __launch_bounds__(kThreads)
    segsum_partial_kernel(const float* __restrict__ values,
                          const int32_t* __restrict__ ids, int64_t n, int g,
                          int64_t rows_per_block, float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                    // [kWarps][g]
  float* stage = smem + kWarps * g;     // [kWarps][32]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * g; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  float* wacc = acc + warp * g;
  float* wstage = stage + warp * 32;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  int64_t end = begin + rows_per_block;
  if (end > n) end = n;
  for (int64_t base = begin; base < end; base += kThreads) {
    const int64_t row = base + threadIdx.x;
    int id = -1;
    float v = 0.0f;
    if (row < end) {
      id = __ldg(ids + row);
      v = __ldg(values + row);
    }
    const bool live = id >= 0 && id < g;
    const unsigned peers = __match_any_sync(0xffffffffu, live ? id : -1);
    wstage[lane] = v;
    __syncwarp();
    if (live && __ffs(peers) - 1 == lane) {
      float s = 0.0f;
      for (unsigned m = peers; m != 0u; m &= m - 1u) s += wstage[__ffs(m) - 1];
      wacc[id] += s;
    }
    __syncwarp();
  }
  __syncthreads();
  for (int j = threadIdx.x; j < g; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += acc[w * g + j];
    partial[static_cast<int64_t>(blockIdx.x) * g + j] = s;
  }
}

__global__ void segsum_final_kernel(const float* __restrict__ partial,
                                    int64_t nblocks, int g,
                                    float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  float s = 0.0f;
  for (int64_t b = 0; b < nblocks; ++b) s += __ldg(partial + b * g + j);
  out[j] = s;
}

}  // namespace

// values: float32 [n]; ids: int32 [n]; partial: float32 scratch [nblocks, g]
// with nblocks = ceil(n / rows_per_block); out: float32 [g]. n > 0, 0 < g.
extern "C" int repro_segment_sum(const void* values, const void* ids, int64_t n,
                                 int g, int64_t rows_per_block, void* partial,
                                 int64_t nblocks, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (static_cast<size_t>(kWarps) * g + kWarps * 32) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      segsum_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  segsum_partial_kernel<<<static_cast<unsigned>(nblocks), kThreads, smem, s>>>(
      static_cast<const float*>(values), static_cast<const int32_t*>(ids), n, g,
      rows_per_block, static_cast<float*>(partial));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int grid = (g + kFinalThreads - 1) / kFinalThreads;
  segsum_final_kernel<<<grid, kFinalThreads, 0, s>>>(
      static_cast<const float*>(partial), nblocks, g, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_segment_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
