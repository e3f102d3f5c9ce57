// Bit-granular helpers of the stream joins that build each output word
// from the bits covering it: K11 (concat.cu, stream_concat_rows) and K12
// (stitch.cu, stitch_segments). Words are MSB first. Shift counts stay in
// [0, 31]: a shift by 32 is undefined in CUDA.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace jt {

// A word with its top `len` bits set (len clamped to [0, 32]).
template <class I>
__device__ __forceinline__ unsigned top_mask(I len) {
  if (len <= 0) return 0u;
  return len >= 32 ? 0xffffffffu : ~(0xffffffffu >> len);
}

// The top `len` bits (1..32) of the 32 bits of a stream that start at its
// bit q, the rest zero. word(k) fetches the stream's word k; words at k >=
// nw read as 0. I is the integer type of the bit positions.
template <class Word, class I>
__device__ __forceinline__ unsigned take_bits(Word word, I nw, I q, I len) {
  const I k = q >> 5;
  const int r = (int)(q & 31);
  unsigned x = k < nw ? word(k) : 0u;
  if (r) {
    const unsigned lo = k + 1 < nw ? word(k + 1) : 0u;
    x = (x << r) | (lo >> (32 - r));
  }
  return x & top_mask(len);
}

// First index in a[0, n) (non-decreasing) whose value exceeds x; n if none.
template <class T>
__device__ __forceinline__ int upper_bound(const T* a, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Store v[0, cnt) (cnt in 1..4) at out[d, d + cnt): one 16-byte store when
// all four words go out and the address is 16-byte aligned.
__device__ __forceinline__ void store_words(unsigned* out, long long d,
                                            int cnt, const unsigned (&v)[4]) {
  unsigned* p = out + d;
  if (cnt == 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    for (int i = 0; i < cnt; ++i) p[i] = v[i];
  }
}

// The block's threads zero out[lo, hi), with 16-byte stores on the
// aligned body.
__device__ inline void zero_words(unsigned* out, long long lo, long long hi) {
  if (lo >= hi) return;
  const long long head =
      ((16 - (reinterpret_cast<uintptr_t>(out + lo) & 15)) & 15) >> 2;
  const long long a = min(hi, lo + head);
  const long long nvec = (hi - a) >> 2;
  for (long long i = lo + threadIdx.x; i < a; i += blockDim.x) out[i] = 0u;
  uint4* body = reinterpret_cast<uint4*>(out + a);
  for (long long i = threadIdx.x; i < nvec; i += blockDim.x) {
    body[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (long long i = a + 4 * nvec + threadIdx.x; i < hi; i += blockDim.x) {
    out[i] = 0u;
  }
}

// A thread stores its words in groups of four that share a 16-byte line
// of the output. The first group start at or before word lo, for an
// output whose base sits `phase` words into its line (line_phase).
__device__ __forceinline__ long long first_group(long long lo, int phase) {
  return ((lo + phase) & ~3LL) - phase;
}

__device__ __forceinline__ int line_phase(const unsigned* out) {
  return (int)((reinterpret_cast<uintptr_t>(out) >> 2) & 3);
}

}  // namespace jt
