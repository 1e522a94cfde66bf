// Bit-packed streams (DESIGN.md §11), shared by bucketize.cu (packed queries
// of bucketize_packed_kernel) and unpack.cu (unpack_kernel and
// rle_decode_packed_kernel): unsigned b-bit codes (b in 1..32) densely
// concatenated into uint32 lanes, value i in bits [i*b, i*b + b) of the
// stream, little-endian within a lane; the logical value is the code plus
// `offset` as an int32 wrap-add, which makes width-32 passthrough exact.
//
// The bit offset i*b is a 64-bit product (the reference splits it to stay
// inside int32, src/repro/kernels/unpack.py:52). A code is
// __funnelshift_r(lane w, lane w + 1, shift) & mask, the second lane read as
// 0 past the stream's end; the mask is all ones at b = 32. Where the second
// lane is not needed (shift + b <= 32), its bits land at or above bit b and
// the mask clears them, so a value never depends on a lane it does not
// occupy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

struct Packed {
  const uint32_t* words;
  int64_t nwords;
  int bits;
  uint32_t mask;    // (1 << bits) - 1, all ones at bits = 32
  uint32_t offset;  // the int32 offset's bit pattern
};

inline Packed make_packed(const void* words, int64_t nwords, int bits,
                          int32_t offset) {
  Packed p;
  p.words = static_cast<const uint32_t*>(words);
  p.nwords = nwords;
  p.bits = bits;
  p.mask = bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
  p.offset = static_cast<uint32_t>(offset);
  return p;
}

// The logical value of `code` bits taken from the 64-bit window lo:hi.
__device__ __forceinline__ int32_t code_value(const Packed& p, uint32_t lo,
                                              uint32_t hi, unsigned shift) {
  return static_cast<int32_t>((__funnelshift_r(lo, hi, shift) & p.mask) +
                              p.offset);
}

// Value i (i < the stream's value count): two lane loads through the
// read-only path, the second guarded at the stream's end.
__device__ __forceinline__ int32_t extract(const Packed& p, int64_t i) {
  const uint64_t bit = static_cast<uint64_t>(i) * static_cast<uint64_t>(p.bits);
  const int64_t w = static_cast<int64_t>(bit >> 5);
  const uint32_t lo = __ldg(p.words + w);
  const uint32_t hi = (w + 1 < p.nwords) ? __ldg(p.words + w + 1) : 0u;
  return code_value(p, lo, hi, static_cast<unsigned>(bit & 31));
}

// x[k] of five consecutive lanes, k in 0..4, by selects (no local memory).
__device__ __forceinline__ uint32_t pick5(const uint32_t (&x)[5], unsigned k) {
  return k == 0 ? x[0] : k == 1 ? x[1] : k == 2 ? x[2] : k == 3 ? x[3] : x[4];
}

// The four values at bit offsets s0 + j*b (j = 0..3, s0 < 32) of the five
// consecutive lanes x: 4b + s0 <= 159 bits, so value j starts in lane
// (s0 + j*b) >> 5 <= 3 and ends in the next one at most.
__device__ __forceinline__ void codes4(const Packed& p, const uint32_t (&x)[5],
                                       unsigned s0, int32_t (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned o = s0 + static_cast<unsigned>(j * p.bits);
    v[j] = code_value(p, pick5(x, o >> 5), pick5(x, (o >> 5) + 1), o & 31);
  }
}

// Values i .. i + 3 (all < the stream's value count) from the at most five
// lanes that cover them: one read-only load a lane, lanes past the stream's
// end and past the last one the four values need read as 0.
__device__ __forceinline__ void extract4(const Packed& p, int64_t i,
                                         int32_t (&v)[4]) {
  const uint64_t bit = static_cast<uint64_t>(i) * static_cast<uint64_t>(p.bits);
  const int64_t w = static_cast<int64_t>(bit >> 5);
  const unsigned s0 = static_cast<unsigned>(bit & 31);
  const int need = static_cast<int>((s0 + 4u * p.bits + 31u) >> 5);
  uint32_t x[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    x[k] = (k < need && w + k < p.nwords) ? __ldg(p.words + w + k) : 0u;
  codes4(p, x, s0, v);
}

}  // namespace repro
