// K12: restart segments stitched into one buffer, byte-aligned and padded.
//
// Replaces jpegtpu/entropy/pallas_concat.py: _stitch_rows (_stitch_kernel,
// via stitch_segments_pallas), together with the K8 row merge
// (merge_sublanes_pallas) that jpegtpu runs before it.
//
// Input: per-stream words [C, n] (a gray block's K4 stream or a color
// MCU's K5 stream, words past its bits zero), bit counts [n], and each
// stream's absolute bit offset [n] int64: byte-aligned segment base plus
// the exclusive prefix of its segment's bits (plain torch in
// entropy/stitch.py, as jpegtpu computes its cumsums in XLA). Output: one
// zeroed word buffer; each stream's bits land at its offset, and the last
// stream of each segment ORs in the 1s that pad the segment to a byte.
//
// Bound: bytes. Each valid stream word is read once and written once
// (~1 MB out per 12 MPix Q50 image), plus the bit counts and offsets; the
// zero-fill before it is the wrapper's. The TPU kernel pads every segment
// to 128-slot rows and deposits whole rows with lane rolls, which at
// restart_interval = 1 costs (cap + 1) * 512 B of scratch per segment
// (gigabytes at 12 MPix). Here one thread per stream funnel-shifts only
// its valid words to its offset: a word wholly inside the stream is a
// plain store, a word it may share with a neighbouring stream (its first
// and last) an atomicOr into the zeroed buffer. Several short streams,
// and several segments, may share one word; atomicOr covers that. Offsets
// are int64 (an 8K frame at cap 53 nears 2^30 bits). Shift counts stay in
// [0, 31]: a shift by 32 is undefined in CUDA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stitch_segments_kernel(const unsigned* __restrict__ words,
                       const int* __restrict__ bits,
                       const long long* __restrict__ offs, int n, int cap,
                       int seg_len, int pad_ones, unsigned* __restrict__ out,
                       long long out_words) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  // A stream past cap words overflowed (the encode retries at a larger
  // cap); clamping keeps every store inside the buffer meanwhile, as the
  // offsets were computed with the same clamp.
  const long long b = min(bits[i], cap * 32);
  const long long off = offs[i];
  const long long end = off + b;
  if (b > 0) {
    const int r = (int)(off & 31);
    const long long first = off >> 5;
    const long long last = (end - 1) >> 5;
    const int nw = (int)((b + 31) >> 5);
    unsigned prev = 0u;
    for (long long d = first; d <= last && d < out_words; ++d) {
      const int k = (int)(d - first);
      const unsigned cur = k < nw ? words[(size_t)k * n + i] : 0u;
      const unsigned v = r ? (cur >> r) | (prev << (32 - r)) : cur;
      prev = cur;
      if (d * 32 >= off && d * 32 + 32 <= end) {
        out[d] = v;
      } else {
        atomicOr(&out[d], v);
      }
    }
  }
  // The segment's last stream pads from its end (the segment's) to the
  // byte boundary; the pad never leaves the word holding bit `end`.
  const bool seg_last = i % seg_len == seg_len - 1 || i == n - 1;
  const int padlen = (int)(-end & 7);
  if (pad_ones && seg_last && padlen && (end >> 5) < out_words) {
    const int sh = 32 - (int)(end & 31) - padlen;
    atomicOr(&out[end >> 5], ((1u << padlen) - 1u) << sh);
  }
}

}  // namespace

extern "C" int jt_stitch_segments(const unsigned* words, const int* bits,
                                  const long long* offs, int n, int cap,
                                  int seg_len, int pad_ones, unsigned* out,
                                  long long out_words, cudaStream_t stream) {
  if (n > 0) {
    stitch_segments_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(words, bits, offs, n, cap, seg_len,
                                       pad_ones, out, out_words);
  }
  return (int)cudaGetLastError();
}
