// Hopper kernel for `topk`: the k best of a 1-D int32/float32 array in
// descending order, ties to the lowest source index, k_pow2 <= 256.
//
// Replaces the Pallas TPU kernel topk_kernel in src/repro/kernels/topk.py: one
// 2048-value slab per grid step held in VMEM, a partial bitonic network that
// keeps a K-wide candidate row per slab, and a final lax.top_k over the T*K
// survivors.
//
// What bounds it on the H100: bytes. The least work is one read of the keys
// (4 bytes a row) and a write of k (value, index) pairs, at 3.35 TB/s. The
// compare-exchange network is O(TILE log^2 TILE) shared-memory steps per tile,
// which this first version does not hide behind the loads.
//
// Design, deterministic by construction (no atomics, one order of every step):
//   * one block of 1024 threads per tile of 2048 (value, index) pairs in 16 KB
//     of shared memory. Rows past n are pads: the dtype's worst value
//     (INT32_MIN or -inf) with the index past the end (the position itself on
//     the first pass, INT32_MAX on survivor passes), so a real row holding the
//     worst value still beats every pad;
//   * a full bitonic sort of the tile under the comparator of topk.py:48,
//     lexicographic (value desc, index asc): each of the 66 steps has every
//     thread compare-exchange one pair, then __syncthreads;
//   * the tile's first k_pow2 pairs are written out, in rank order.
// The survivor pass is this kernel again: the wrapper relaunches it on the
// T*k_pow2 survivors, carrying their source indices in, until one tile is left
// (five launches at 59,986,052 keys and k_pow2 = 128). The global top-k lies in
// the union of the tiles' top-k_pow2, and the comparator is a total order on
// distinct indices, so the result equals a stable descending sort's first k.
// Floats compare as numbers (-0.0 ties +0.0); NaN is not taken (the ordering
// layer ranks int32 keys). The launch goes on the caller's stream, allocates
// nothing, and returns cudaGetLastError(). Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;
constexpr int kThreads = kTile / 2;

template <typename T>
__device__ __forceinline__ T worst();

template <>
__device__ __forceinline__ int32_t worst<int32_t>() {
  return INT32_MIN;
}

template <>
__device__ __forceinline__ float worst<float>() {
  return __int_as_float(0xff800000);  // -inf
}

// is (av, ai) ranked before (bv, bi)?
template <typename T>
__device__ __forceinline__ bool better(T av, int32_t ai, T bv, int32_t bi) {
  return av > bv || (av == bv && ai < bi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_tile_kernel(const T* __restrict__ vals,
                     const int32_t* __restrict__ idx_in, int64_t n, int k_pow2,
                     T* __restrict__ out_v, int32_t* __restrict__ out_i) {
  __shared__ T sv[kTile];
  __shared__ int32_t si[kTile];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    const int64_t p = base + t;
    if (p < n) {
      sv[t] = vals[p];
      si[t] = idx_in != nullptr ? idx_in[p] : static_cast<int32_t>(p);
    } else {
      sv[t] = worst<T>();
      si[t] = idx_in != nullptr ? INT32_MAX : static_cast<int32_t>(p);
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      // the pair (a, a + j): a has bit j clear
      const int a = ((t & ~(j - 1)) << 1) | (t & (j - 1));
      const int b = a | j;
      const T av = sv[a], bv = sv[b];
      const int32_t ai = si[a], bi = si[b];
      // blocks with bit k clear sort descending (the better pair first);
      // at k = kTile every block does, so the tile ends in rank order
      const bool swap = (a & k) == 0 ? better(bv, bi, av, ai)
                                     : better(av, ai, bv, bi);
      if (swap) {
        sv[a] = bv;
        sv[b] = av;
        si[a] = bi;
        si[b] = ai;
      }
      __syncthreads();
    }
  }
  const int64_t out = static_cast<int64_t>(blockIdx.x) * k_pow2;
  for (int r = threadIdx.x; r < k_pow2; r += kThreads) {
    out_v[out + r] = sv[r];
    out_i[out + r] = si[r];
  }
}

}  // namespace

// One pass: vals [n] (int32 when is_float == 0, else float32), idx_in [n] the
// source indices of a survivor pass or null on the first pass; out_v / out_i
// [max(1, ceil(n / 2048)) * k_pow2]. 8 <= k_pow2 <= 256, a power of two.
extern "C" int repro_topk_pass(const void* vals, const void* idx_in, int64_t n,
                               int k_pow2, int is_float, void* out_v,
                               void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  const dim3 grid(static_cast<unsigned>(tiles));
  const int32_t* idx = static_cast<const int32_t*>(idx_in);
  if (is_float) {
    topk_tile_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(vals), idx, n, k_pow2,
        static_cast<float*>(out_v), static_cast<int32_t*>(out_i));
  } else {
    topk_tile_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(vals), idx, n, k_pow2,
        static_cast<int32_t*>(out_v), static_cast<int32_t*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
