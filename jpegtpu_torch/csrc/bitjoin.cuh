// Bit-granular helpers of the stream joins that build each output word
// from the bits covering it: K10 and K11 (concat.cu,
// stream_concat_chunked and stream_concat_rows) and K12 (stitch.cu,
// stitch_segments), and the block scan of segment bit counts that K10 and
// K11 run. Words are MSB first. Shift counts stay in [0, 31]: a shift by
// 32 is undefined in CUDA.
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

// The sum of x over the block's threads before this one (blockDim.x a
// multiple of 32); *total, if given, gets the sum over all of them.
// warp_tot holds 32 values of shared memory.
__device__ inline long long block_exclusive_sum(long long x,
                                               long long* warp_tot,
                                               long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  long long inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nwarps ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const long long before = warp ? warp_tot[warp - 1] : 0;
  if (total) *total = warp_tot[nwarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return before + inc - x;
}

// The block's inclusive scan of the P values in inc[0, P), in place: each
// thread sums a run of ceil(P / blockDim.x) values, one block scan of the
// run sums, then each thread writes its run's running sums.
__device__ inline void scan_in_place(long long* inc, int P,
                                     long long* warp_tot) {
  __syncthreads();
  const int run = (P + blockDim.x - 1) / blockDim.x;
  const int r0 = min(P, (int)threadIdx.x * run), r1 = min(P, r0 + run);
  long long sum = 0;
  for (int i = r0; i < r1; ++i) sum += inc[i];
  long long acc = block_exclusive_sum(sum, warp_tot, nullptr);
  for (int i = r0; i < r1; ++i) {
    acc += inc[i];
    inc[i] = acc;
  }
  __syncthreads();
}

// Inclusive scan of one image's P segment bit counts into inc[0, P) (K11).
__device__ inline void scan_counts(const int* __restrict__ bits, int P,
                                   long long* inc, long long* warp_tot) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) inc[i] = bits[i];
  scan_in_place(inc, P, warp_tot);
}

// Four consecutive words of a stream whose 128 bits all lie in one
// segment (seg_words words at src, MSB first), the first starting at the
// segment's bit q: five loads and four funnel shifts.
__device__ __forceinline__ void segment_words4(
    unsigned (&v)[4], const unsigned* __restrict__ src, int seg_words,
    long long q) {
  const long long k = q >> 5;
  const int r = (int)(q & 31);
  unsigned x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) x[i] = k + i < seg_words ? src[k + i] : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = r ? (x[i] << r) | (x[i + 1] >> (32 - r)) : x[i];
  }
}

// Word d of an image's stream: the bits of its segments (segment s holds
// bits [inc[s - 1], inc[s]) of the image; its words at src + s * seg_words)
// that fall in [32 d, 32 d + 32), then the pad up to `padded`, then zeros.
// s is the first segment whose end passes bit 32 d, or P; it is left at
// the segment where the word ended, for word d + 1.
__device__ __forceinline__ unsigned rows_word(
    long long d, int& s, const long long* inc, int P,
    const unsigned* __restrict__ src, int seg_words, long long padded,
    int pad_ones) {
  long long pos = 32 * d;
  const long long wend = pos + 32;
  unsigned v = 0u;
  while (pos < wend) {
    while (s < P && inc[s] <= pos) ++s;  // skips empty segments
    if (s == P) {  // past the image's bits: its pad, then zeros
      if (pad_ones && pos < padded) {
        v |= jt::top_mask(min(padded, wend) - pos) >> (pos - 32 * d);
      }
      break;
    }
    const long long off = s ? inc[s - 1] : 0;  // <= pos
    const long long stop = min(inc[s], wend);
    const unsigned* seg = src + (size_t)s * seg_words;
    v |= jt::take_bits([seg](long long k) { return seg[k]; },
                       (long long)seg_words, pos - off, stop - pos)
         >> (pos - 32 * d);
    pos = stop;
  }
  return v;
}

}  // namespace jt
