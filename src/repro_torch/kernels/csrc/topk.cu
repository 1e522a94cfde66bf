// Hopper kernel for `topk`: the k best of a 1-D int32/float32 array in
// descending order, ties to the lowest source index, k_pow2 <= 256.
//
// Replaces the Pallas TPU kernel topk_kernel in src/repro/kernels/topk.py: one
// 2048-value slab per grid step held in VMEM, a partial bitonic network that
// keeps a K-wide candidate row per slab, and a final lax.top_k over the T*K
// survivors.
//
// What bounds it on the H100: bytes. The least work is one read of the keys
// (4 bytes a row) and a write of k (value, index) pairs, at 3.35 TB/s. Nearly
// every key can never enter the top k, so the design spends one comparison on
// such a key and sorts only the few that can.
//
// Design: block-select with a running threshold. Deterministic by
// construction: no atomics, one order of every step.
//   * Range pass: a grid of at most (SMs x 2) blocks of 256 threads; block b
//     walks the contiguous range [b * range, (b + 1) * range). Each step a
//     thread tests eight keys, two 16-byte pieces (a scalar head and tail
//     take a misaligned start and a ragged end). The pieces arrive through a
//     cp.async ring of four steps in shared memory, each thread copying and
//     reading only its own, so three steps (24 KB a block) are in flight
//     while a step is tested and no registers hold them. (A register double
//     buffer, one step ahead, held a third as much and spilled at the
//     register bound of four blocks an SM; a TMA bulk copy would need an
//     mbarrier per stage for the same effect.) Two blocks an SM, not more:
//     the one-block survivor pass grows with the grid (PERF.md section 6).
//   * Each block keeps its running top-k_pow2 (value, index) list, best
//     first, in shared memory; the list's last entry is the threshold. A key
//     enters the 2048-pair candidate buffer only if it beats the threshold
//     under the full comparator (value desc, index asc: topk.py:48). Buffer
//     positions come from a warp scan of each thread's survivor count and a
//     block sum of the warp totals, not from atomics.
//   * When a step's survivors would overflow the buffer, and at the end of
//     the range, the buffer is flushed. Each warp holding candidates
//     bitonic-sorts its 256 of them in registers (eight a lane; the steps
//     across lanes are __shfl_xor_sync), so a flush of c candidates sorts
//     ceil(c / 256) warps' worth, not the whole buffer. The warps' best
//     k_pow2 meet in a tree of merges, and the result is merged into the
//     list, each merge the first exchange of a 2K bitonic merge (the better
//     of a[i] and b[K-1-i], as _merge_rows_desc in topk.py:89-102) and
//     log2(k_pow2) clean-up steps. That raises the threshold; the step that
//     overflowed is tested again against it.
//   * Pads are the dtype's worst value (INT32_MIN or -inf) with index
//     INT32_MAX, so a real row holding the worst value beats every pad. A
//     block writes its sorted k_pow2 pairs; in a one-block launch (the last
//     pass) a pad takes its slot as index, so fewer than k values come back
//     padded with the indices past the end, as the stable sort pads them.
//   * Survivor pass: the same kernel with one block over the grid * k_pow2
//     pairs, their source indices passed in: two launches in all at R1's
//     59,986,052 keys (kernels/topk.py plans both).
// A block's output is the exact top-k_pow2 of its range under a total order,
// so the answer depends on neither the grid, the flush points nor timing.
// Worst case, ascending keys: every key beats the threshold and is sorted
// once, by a warp sort of 256. Floats compare as numbers (-0.0 ties +0.0); NaN is
// not taken (the ordering layer ranks int32 keys). The launch goes on the
// caller's stream, allocates nothing, and returns cudaGetLastError(). Offsets
// are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                     // pairs a lane holds in a sort
constexpr int kBuf = kThreads * kPer;       // candidate buffer: 8 warp sorts
constexpr int kChunk = kThreads * 8;        // keys a block tests per step
constexpr int kWarpSort = 32 * kPer;        // pairs one warp sorts
constexpr int kMaxK = 256;
constexpr int kBlocksPerSM = 2;
constexpr int kStages = 4;                  // steps a block has in flight
constexpr int32_t kPad = INT32_MAX;         // index of a pad
constexpr int kAll = 1 << 30;               // a stage bit no position has
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ int32_t to_bits(int32_t v) { return v; }
__device__ __forceinline__ int32_t to_bits(float v) { return __float_as_int(v); }

template <typename T>
__device__ __forceinline__ T from_bits(int32_t b);

template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(int32_t b) {
  return b;
}

template <>
__device__ __forceinline__ float from_bits<float>(int32_t b) {
  return __int_as_float(b);
}

// is (av, ai) ranked before (bv, bi)?
template <typename T>
__device__ __forceinline__ bool better(T av, int32_t ai, T bv, int32_t bi) {
  return av > bv || (av == bv && ai < bi);
}

template <typename T>
struct Shared {
  __align__(16) T buf_v[kBuf];      // candidates; the flush's merge tree
  __align__(16) int32_t buf_i[kBuf];
  __align__(16) T list_v[kMaxK];    // running top-k_pow2, best first
  __align__(16) int32_t list_i[kMaxK];
  int32_t warp_total[2][kWarps];    // double-buffered: one barrier a step
  T thr_v;                          // list_v[k_pow2 - 1]
  int32_t thr_i;
};

// The block's state, at namespace scope so that the out-of-line flush
// addresses it as shared memory. int32 and float32 states have one size.
__shared__ __align__(16) unsigned char g_state[sizeof(Shared<int32_t>)];

template <typename T>
__device__ __forceinline__ Shared<T>& state() {
  return *reinterpret_cast<Shared<T>*>(g_state);
}

// Eight keys of one thread and which of them exist. A range pass carries no
// indices: key r lies at p0 + (r & 3) + (r >> 2) * 1024 (a ragged key: slot
// 0 at p0); a survivor pass loads them.
template <typename T, bool kIdx>
struct Chunk {
  T v[8];
  int32_t x[kIdx ? 8 : 1];
  int64_t p0;
  unsigned valid;

  __device__ __forceinline__ int32_t index(int r) const {
    if constexpr (kIdx) {
      return x[r];
    } else {
      return static_cast<int32_t>(p0 + (r & 3) + (r >> 2) * (kThreads * 4));
    }
  }
};

// ---- bitonic steps over eight pairs a thread, at positions base + r -------

// pairs within the thread: (r, r | J) for r with bit J clear
template <int J, typename T>
__device__ __forceinline__ void reg_step(T (&v)[8], int32_t (&x)[8], int base,
                                         int k) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if ((r & J) == 0) {
      constexpr int kOff = J;
      const int p = r + kOff;
      const bool desc = ((base + r) & k) == 0;
      const bool swap = desc ? better(v[p], x[p], v[r], x[r])
                             : better(v[r], x[r], v[p], x[p]);
      if (swap) {
        const T tv = v[r];
        const int32_t tx = x[r];
        v[r] = v[p];
        x[r] = x[p];
        v[p] = tv;
        x[p] = tx;
      }
    }
  }
}

// the one taking part in a pair keeps the better pair if it is the lower
// position of a descending block or the upper of an ascending one
__device__ __forceinline__ bool keeps_better(int base, int j, int k) {
  return ((base & j) == 0) == ((base & k) == 0);
}

// pairs across lanes of one warp: 8 <= j < 256
template <typename T>
__device__ __forceinline__ void shfl_step(T (&v)[8], int32_t (&x)[8], int base,
                                          int j, int k) {
  const int lane_mask = j >> 3;
  const bool keep = keeps_better(base, j, k);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const T ov = __shfl_xor_sync(kFull, v[r], lane_mask);
    const int32_t ox = __shfl_xor_sync(kFull, x[r], lane_mask);
    if (better(v[r], x[r], ov, ox) != keep) {
      v[r] = ov;
      x[r] = ox;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* sv, int32_t* si, int base,
                                       const T (&v)[8], const int32_t (&x)[8]) {
  int4* pv = reinterpret_cast<int4*>(sv + base);
  int4* pi = reinterpret_cast<int4*>(si + base);
  pv[0] = make_int4(to_bits(v[0]), to_bits(v[1]), to_bits(v[2]), to_bits(v[3]));
  pv[1] = make_int4(to_bits(v[4]), to_bits(v[5]), to_bits(v[6]), to_bits(v[7]));
  pi[0] = make_int4(x[0], x[1], x[2], x[3]);
  pi[1] = make_int4(x[4], x[5], x[6], x[7]);
}

template <typename T>
__device__ __forceinline__ void load8(const T* sv, const int32_t* si, int base,
                                      T (&v)[8], int32_t (&x)[8]) {
  const int4* pv = reinterpret_cast<const int4*>(sv + base);
  const int4* pi = reinterpret_cast<const int4*>(si + base);
  const int4 a = pv[0], b = pv[1], c = pi[0], d = pi[1];
  v[0] = from_bits<T>(a.x);
  v[1] = from_bits<T>(a.y);
  v[2] = from_bits<T>(a.z);
  v[3] = from_bits<T>(a.w);
  v[4] = from_bits<T>(b.x);
  v[5] = from_bits<T>(b.y);
  v[6] = from_bits<T>(b.z);
  v[7] = from_bits<T>(b.w);
  x[0] = c.x;
  x[1] = c.y;
  x[2] = c.z;
  x[3] = c.w;
  x[4] = d.x;
  x[5] = d.y;
  x[6] = d.z;
  x[7] = d.w;
}

// Bitonic sort of the 256 pairs one warp holds, best first, eight a lane at
// base = 8 * lane: every step within a lane or across lanes by shuffles.
template <typename T>
__device__ __forceinline__ void warp_sort(T (&v)[8], int32_t (&x)[8],
                                          int base) {
#pragma unroll
  for (int k = 2; k <= kWarpSort; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 8) {
        shfl_step(v, x, base, j, k);
      } else if (j == 4) {
        reg_step<4>(v, x, base, k);
      } else if (j == 2) {
        reg_step<2>(v, x, base, k);
      } else {
        reg_step<1>(v, x, base, k);
      }
    }
  }
}

// buffer pairs [at, at + 8), pads past `count`
template <typename T>
__device__ __forceinline__ void load_buffer(const Shared<T>& sh, int at,
                                            int count, T (&v)[8],
                                            int32_t (&x)[8]) {
  load8(sh.buf_v, sh.buf_i, at, v, x);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (at + r >= count) {
      v[r] = worst<T>();
      x[r] = kPad;
    }
  }
}

// The warp holds a sorted list at 8 * lane + r; b is a sorted k_pow2-pair
// list in shared memory. Keep the better of a[i] and b[K-1-i] (the first
// exchange of a 2K bitonic merge, _merge_rows_desc in topk.py:89-102): a
// bitonic sequence holding the best k_pow2 of both, which log2(k_pow2)
// clean-up steps sort into the warp's first k_pow2 / 8 lanes.
template <typename T>
__device__ __forceinline__ void merge_top(T (&v)[8], int32_t (&x)[8],
                                          const T* b_v, const int32_t* b_x,
                                          int k_pow2) {
  const int base = kPer * (threadIdx.x & 31);
  if (base < k_pow2) {
    T bv[8];
    int32_t bx[8];
    load8(b_v, b_x, k_pow2 - kPer - base, bv, bx);  // b[K-1-base-r] = bv[7-r]
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (!better(v[r], x[r], bv[7 - r], bx[7 - r])) {
        v[r] = bv[7 - r];
        x[r] = bx[7 - r];
      }
    }
  }
  for (int j = k_pow2 >> 1; j >= 8; j >>= 1) shfl_step(v, x, base, j, kAll);
  reg_step<4>(v, x, base, kAll);
  reg_step<2>(v, x, base, kAll);
  reg_step<1>(v, x, base, kAll);
}

// Merge the buffer's `count` candidates into the list and raise the
// threshold. Each warp holding candidates sorts its 256 of them; their best
// k_pow2 meet in a tree of merges (warp w takes w + s's list through shared
// memory, s = 1, 2, 4), and warp 0 merges the result into the list. Every
// thread calls; starts with a barrier, so every thread's last appends to the
// buffer are in place before a warp reads another's, and ends with one, after
// which the buffer is free. Out of line, so the registers of the sort do not
// crowd the scan loop's: a flush is rare but for ascending keys.
template <typename T>
__device__ __noinline__ void flush(int count, int k_pow2) {
  Shared<T>& sh = state<T>();
  const int warp = threadIdx.x >> 5;
  const int base = kPer * (threadIdx.x & 31);
  const int warps = (count + kWarpSort - 1) / kWarpSort;
  T v[8];
  int32_t x[8];
  __syncthreads();
  if (warp < warps) {
    load_buffer(sh, kWarpSort * warp + base, count, v, x);
    warp_sort(v, x, base);
  }
  for (int s = 1; s < warps; s <<= 1) {
    __syncthreads();  // the buffer's region of this level has been read
    if (warp < warps && (warp & (2 * s - 1)) == s && base < k_pow2)
      store8(sh.buf_v + kWarpSort * warp, sh.buf_i + kWarpSort * warp, base, v,
             x);
    __syncthreads();
    if ((warp & (2 * s - 1)) == 0 && warp + s < warps)
      merge_top(v, x, sh.buf_v + kWarpSort * (warp + s),
                sh.buf_i + kWarpSort * (warp + s), k_pow2);
  }
  if (warp == 0) {
    merge_top(v, x, sh.list_v, sh.list_i, k_pow2);
    __syncwarp();  // every lane has read the list before it is rewritten
    if (base < k_pow2) store8(sh.list_v, sh.list_i, base, v, x);
    if (base + kPer == k_pow2) {
      sh.thr_v = v[7];
      sh.thr_i = x[7];
    }
  }
  __syncthreads();
}

// Test one step's keys against the threshold and append the survivors; a
// step that would overflow the buffer flushes it and is tested again.
template <typename T, bool kIdx>
__device__ __forceinline__ void offer(const Chunk<T, kIdx>& c, int& count,
                                      int& parity, int k_pow2) {
  Shared<T>& sh = state<T>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  while (true) {
    const T tv = sh.thr_v;
    const int32_t ti = sh.thr_i;
    unsigned mask = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (((c.valid >> r) & 1u) && better(c.v[r], c.index(r), tv, ti))
        mask |= 1u << r;
    }
    const int mine = __popc(mask);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) sh.warp_total[parity][warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = sh.warp_total[parity][w];
      before += w < warp ? n : 0;
      total += n;
    }
    parity ^= 1;
    if (total == 0) return;
    if (count + total > kBuf) {
      flush<T>(count, k_pow2);
      count = 0;
      continue;
    }
    int pos = count + before + incl - mine;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if ((mask >> r) & 1u) {
        sh.buf_v[pos] = c.v[r];
        sh.buf_i[pos] = c.index(r);
        ++pos;
      }
    }
    count += total;
    return;
  }
}

// ---- the load ring: cp.async copies of the next steps' keys ---------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// the oldest step's copies have landed (at most kStages - 1 still in flight)
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Ring of kStages steps in dynamic shared memory: values [kStages][kChunk],
// then (survivor pass) indices [kStages][kChunk]. Thread t copies and later
// reads only its own 16-byte pieces, at t * 4 and 1024 + t * 4 of a step, so
// no barrier guards the ring.
template <bool kIdx>
constexpr size_t ring_bytes() {
  return static_cast<size_t>(kStages) * kChunk * 4 * (kIdx ? 2 : 1);
}

// Start the copies of the step at `base` (keys past `end` are not copied)
// into ring slot `slot`; one commit group a step, empty or not.
template <typename T, bool kIdx>
__device__ __forceinline__ void issue_step(const T* __restrict__ vals,
                                           const int32_t* __restrict__ idx_in,
                                           int64_t base, int64_t end, int slot,
                                           unsigned char* ring) {
  T* rv = reinterpret_cast<T*>(ring) + slot * kChunk;
  int32_t* ri = reinterpret_cast<int32_t*>(ring) + (kStages + slot) * kChunk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int off = h * (kThreads * 4) + 4 * threadIdx.x;
    if (base + off < end) {  // the body is a whole number of 4-key vectors
      cp_async16(rv + off, vals + base + off);
      if constexpr (kIdx) cp_async16(ri + off, idx_in + base + off);
    }
  }
  cp_async_commit();
}

// This thread's eight keys of the step at `base`, from ring slot `slot`.
template <typename T, bool kIdx>
__device__ __forceinline__ void read_step(int64_t base, int64_t end, int slot,
                                          const unsigned char* ring,
                                          Chunk<T, kIdx>& c) {
  const int32_t* rv = reinterpret_cast<const int32_t*>(ring) + slot * kChunk;
  const int32_t* ri =
      reinterpret_cast<const int32_t*>(ring) + (kStages + slot) * kChunk;
  c.valid = 0;
  c.p0 = base + 4 * threadIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int off = h * (kThreads * 4) + 4 * threadIdx.x;
    if (base + off < end) {
      const int4 w = *reinterpret_cast<const int4*>(rv + off);
      c.v[4 * h + 0] = from_bits<T>(w.x);
      c.v[4 * h + 1] = from_bits<T>(w.y);
      c.v[4 * h + 2] = from_bits<T>(w.z);
      c.v[4 * h + 3] = from_bits<T>(w.w);
      if constexpr (kIdx) {
        const int4 i = *reinterpret_cast<const int4*>(ri + off);
        c.x[4 * h + 0] = i.x;
        c.x[4 * h + 1] = i.y;
        c.x[4 * h + 2] = i.z;
        c.x[4 * h + 3] = i.w;
      }
      c.valid |= 0xfu << (4 * h);
    }
  }
}

template <typename T, bool kIdx>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    topk_select_kernel(const T* __restrict__ vals,
                       const int32_t* __restrict__ idx_in, int64_t n,
                       int64_t range, int k_pow2, T* __restrict__ out_v,
                       int32_t* __restrict__ out_i) {
  Shared<T>& sh = state<T>();
  const int t = threadIdx.x;
  for (int r = t; r < kMaxK; r += kThreads) {
    sh.list_v[r] = worst<T>();
    sh.list_i[r] = kPad;
  }
  if (t == 0) {
    sh.thr_v = worst<T>();
    sh.thr_i = kPad;
  }
  __syncthreads();
  int count = 0, parity = 0;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * range;
  const int64_t e = s + range < n ? s + range : n;
  if (s < e) {
    // scalar head up to the first 16-byte boundary, vector body, scalar tail
    const int misalign = static_cast<int>(
        (reinterpret_cast<uintptr_t>(vals + s) & 15) / sizeof(T));
    int64_t head = (4 - misalign) & 3;
    if (head > e - s) head = e - s;
    const int64_t a = s + head;
    const int64_t body_end = a + ((e - a) & ~int64_t(3));
    const int64_t tail = e - body_end;
    if (head + tail > 0) {
      Chunk<T, kIdx> c;
      c.valid = 0;
      int64_t p = -1;
      if (t < head) p = s + t;
      if (t >= 4 && t - 4 < tail) p = body_end + (t - 4);
      c.p0 = p;
      if (p >= 0) {
        c.v[0] = vals[p];
        if constexpr (kIdx) c.x[0] = idx_in[p];
        c.valid = 1;
      }
      offer(c, count, parity, k_pow2);
    }
    if (a < body_end) {
      extern __shared__ __align__(16) unsigned char ring[];
      const int64_t steps = (body_end - a + kChunk - 1) / kChunk;
      for (int i = 0; i < kStages - 1; ++i)
        issue_step<T, kIdx>(vals, idx_in, a + i * int64_t(kChunk), body_end, i,
                            ring);
      int slot = 0, ahead = kStages - 1;
      for (int64_t i = 0; i < steps; ++i) {
        issue_step<T, kIdx>(vals, idx_in, a + (i + kStages - 1) * kChunk,
                            body_end, ahead, ring);
        cp_async_wait_oldest();
        Chunk<T, kIdx> c;
        read_step(a + i * kChunk, body_end, slot, ring, c);
        offer(c, count, parity, k_pow2);
        slot = slot + 1 == kStages ? 0 : slot + 1;
        ahead = ahead + 1 == kStages ? 0 : ahead + 1;
      }
    }
  }
  if (count > 0) flush<T>(count, k_pow2);
  const int64_t out = static_cast<int64_t>(blockIdx.x) * k_pow2;
  for (int r = t; r < k_pow2; r += kThreads) {
    const int32_t i = sh.list_i[r];
    out_v[out + r] = sh.list_v[r];
    // the last pass: pads past the real rows take their slot as index
    out_i[out + r] = (gridDim.x == 1 && i == kPad) ? r : i;
  }
}

template <typename T, bool kIdx>
int launch(const void* vals, const int32_t* idx, int64_t n, int64_t range,
           int grid, int k_pow2, void* out_v, void* out_i, cudaStream_t s) {
  constexpr auto kKernel = topk_select_kernel<T, kIdx>;
  repro::KernelCache<kKernel>* cache = nullptr;
  int dev = 0;
  cudaError_t err = repro::kernel_facts<kKernel>(kThreads, &cache, &dev);
  if (err == cudaSuccess)
    err = repro::opt_in<kKernel>(*cache, dev, ring_bytes<kIdx>(),
                                 sizeof(Shared<int32_t>));
  if (err != cudaSuccess) return static_cast<int>(err);
  kKernel<<<grid, kThreads, ring_bytes<kIdx>(), s>>>(
      static_cast<const T*>(vals), idx, n, range, k_pow2,
      static_cast<T*>(out_v), static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* vals, const int32_t* idx, int64_t n, int64_t range,
           int grid, int k_pow2, void* out_v, void* out_i, cudaStream_t s) {
  return idx != nullptr
             ? launch<T, true>(vals, idx, n, range, grid, k_pow2, out_v, out_i, s)
             : launch<T, false>(vals, idx, n, range, grid, k_pow2, out_v, out_i,
                                s);
}

}  // namespace

// One launch: vals [n] (int32 when is_float == 0, else float32), idx_in [n]
// the source indices of a survivor pass or null on the range pass; block b
// walks [b * range, (b + 1) * range) and writes out_v / out_i
// [b * k_pow2, (b + 1) * k_pow2). grid * range >= n; 8 <= k_pow2 <= 256, a
// power of two; idx_in, when given, lies at the same offset from a 16-byte
// boundary as vals.
extern "C" int repro_topk_pass(const void* vals, const void* idx_in, int64_t n,
                               int64_t range, int grid, int k_pow2,
                               int is_float, void* out_v, void* out_i,
                               void* stream) {
  const bool kp_ok = k_pow2 >= 8 && k_pow2 <= kMaxK &&
                     (k_pow2 & (k_pow2 - 1)) == 0;
  const uintptr_t va = reinterpret_cast<uintptr_t>(vals) & 15;
  const bool idx_ok =
      idx_in == nullptr || (reinterpret_cast<uintptr_t>(idx_in) & 15) == va;
  if (!kp_ok || !idx_ok || grid < 1 || range < 0 || n < 0 ||
      static_cast<int64_t>(grid) * range < n || (va & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idx = static_cast<const int32_t*>(idx_in);
  return is_float
             ? launch<float>(vals, idx, n, range, grid, k_pow2, out_v, out_i, s)
             : launch<int32_t>(vals, idx, n, range, grid, k_pow2, out_v, out_i,
                               s);
}

extern "C" const char* repro_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
