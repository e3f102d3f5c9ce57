// K10 (stream_concat_chunked) as a warp per segment: the design that
// jpegtpu_torch/csrc/concat.cu weighed against its gather, where each
// thread block builds an equal share of the stream's words from the
// segments that cover them. Not part of the package:
// tools/torch_kernel_ab.py builds it, holds its stream and total equal to
// concat.cu's and times the two (and another checkout's K10) in turns.
// Same arguments and semantics as jt_stream_concat_chunked for a scan
// that fits shared memory: segments [nseg, seg_words], bit counts [nseg]
// -> the stream [out_words], zeros past the total, and the total.
//
// - Every thread block scans all nseg bit counts in shared memory, as
//   concat.cu's K10 does.
// - Warp w of the grid places segments w, w + W, ... (W warps in all): it
//   stores every word whose first bit lies in its segment, in 4-word
//   groups a lane, with plain stores. That rule gives each word one owner
//   and no word two: a word shared with the next segments (its last) is
//   built by its owner, which walks across their ends, empty segments and
//   segments shorter than a word included.
// - The zeros past the total are split among the thread blocks as in
//   concat.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "../jpegtpu_torch/csrc/bitjoin.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long share_start(long long n, long long i,
                                                 long long parts) {
  const long long each = ((n + parts - 1) / parts + 3) & ~3LL;
  return min(n, i * each);
}

__global__ void __launch_bounds__(kThreads)
warp_per_segment_kernel(const unsigned* __restrict__ segs,
                        const int* __restrict__ seg_bits, int nseg,
                        int seg_words, unsigned* __restrict__ out,
                        long long out_words,
                        long long* __restrict__ total_out) {
  extern __shared__ long long inc[];
  __shared__ long long warp_tot[32];
  jt::scan_counts(seg_bits, nseg, inc, warp_tot);
  const long long total = inc[nseg - 1];
  if (blockIdx.x == 0 && threadIdx.x == 0) *total_out = total;
  const long long valid = min((total + 31) >> 5, out_words);
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int phase = jt::line_phase(out);
  for (int s = blockIdx.x * warps + (threadIdx.x >> 5); s < nseg;
       s += gridDim.x * warps) {
    const long long off = s ? inc[s - 1] : 0, end = inc[s];
    // the words whose first bit lies in [off, end)
    const long long lo = (off + 31) >> 5, hi = min((end + 31) >> 5, valid);
    const unsigned* src = segs + (size_t)s * seg_words;
    for (long long g = jt::first_group(lo, phase) + 4LL * lane; g < hi;
         g += 128) {
      const long long d0 = max(g, lo), d1 = min(g + 4, hi);
      unsigned v[4] = {0u, 0u, 0u, 0u};
      if (d1 - d0 == 4 && 32 * d0 + 128 <= end) {
        jt::segment_words4(v, src, seg_words, 32 * d0 - off);
      } else {
        int t = s;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (d0 + w < d1) {
            v[w] = jt::rows_word(d0 + w, t, inc, nseg, segs, seg_words,
                                 total, 0);
          }
        }
      }
      jt::store_words(out, d0, (int)(d1 - d0), v);
    }
  }
  const long long nz = out_words - valid;
  jt::zero_words(out, valid + share_start(nz, blockIdx.x, gridDim.x),
                 valid + share_start(nz, blockIdx.x + 1, gridDim.x));
}

}  // namespace

extern "C" int jt_concat_warp_per_segment(const unsigned* segs,
                                          const int* seg_bits, int nseg,
                                          int seg_words, int blocks,
                                          unsigned* out, long long out_words,
                                          long long* total,
                                          cudaStream_t stream) {
  if (nseg <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nseg * sizeof(long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        warp_per_segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  warp_per_segment_kernel<<<blocks, kThreads, smem, stream>>>(
      segs, seg_bits, nseg, seg_words, out, out_words, total);
  return (int)cudaGetLastError();
}

// Thread blocks one SM holds for nseg segments, or -1 on an error.
extern "C" int jt_concat_warp_per_segment_per_sm(int nseg) {
  const size_t smem = (size_t)nseg * sizeof(long long);
  int n = 0;
  if ((smem > 48 * 1024 &&
       cudaFuncSetAttribute(warp_per_segment_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem) != cudaSuccess) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, warp_per_segment_kernel, kThreads, smem) != cudaSuccess) {
    return -1;
  }
  return n;
}
