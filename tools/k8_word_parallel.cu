// K8 (merge_rows) word-parallel, with no segment in shared memory: the
// design that jpegtpu_torch/csrc/concat.cu weighed against the one it
// ships. Not part of the package: tools/torch_kernel_ab.py builds it,
// holds its segments and bit counts equal to concat.cu's and times the
// two (and another checkout's K8) in turns. Same arguments and semantics
// as jt_merge_rows. Also two floors a kernel that writes a buffer of K8's
// size meets on the card: a store-only kernel (jt_fill_zero4), and one
// that reads each segment's bit counts before it stores the segment
// (jt_count_fill).
//
// A thread block scans 128 block counts (128 / ws segments; warp shuffles
// and, past ws 32, one step across the segment's warps), then its 128-512
// threads build the 16-byte groups of its segments, each word written
// once: a group past its segment's total is zeros straight from
// registers; a group below it is gathered from the words of the lanes
// that cover it, found from the lane holding its first bit (binary search
// of the scan), 8 words a round, all loaded before any is used. No
// atomics and no shared memory per segment, so its occupancy does not
// fall with the cap. It lost to the staged design everywhere but the
// top rung (PERF.md, PR 11): on Q50 rows, whose blocks hold a few dozen
// bits, each group walks several lanes, a chain of dependent
// shared-memory reads before its loads, and the zeros its thread stores
// after that group wait behind it.

#include <cstdint>
#include <cuda_runtime.h>

#include "../jpegtpu_torch/csrc/bitjoin.cuh"

namespace {

// K8: a thread block scans kMergeLanes block counts, kMergeLanes / ws
// segments of ws blocks, and stores their words in 16-byte groups,
// about kMergeGroups groups a thread (merge_threads).
constexpr int kMergeLanes = 128;
constexpr int kMergeGroups = 3;
constexpr int kGather = 8;  // words a K8 thread loads before it uses one
constexpr int kMergeMaxThreads = 512;

// K8's threads a block for segments of seg_words words at width ws: a
// power of two from kMergeLanes to kMergeMaxThreads, about kMergeGroups
// 16-byte groups of the block's words each.
inline int merge_threads(int ws, int seg_words) {
  const long long groups = (long long)(kMergeLanes / ws) * seg_words / 4;
  int t = kMergeLanes;
  while (t < kMergeMaxThreads && (long long)t * kMergeGroups < groups) {
    t <<= 1;
  }
  return t;
}

// The segment-local inclusive scan of the block's kMergeLanes counts (b:
// this thread's, 0 past kMergeLanes), ws lanes a segment: warp shuffles,
// then for ws > 32 the totals of the segment's earlier warps. Every
// thread of the block calls it; thread t < kMergeLanes writes inc[t].
__device__ __forceinline__ void merge_scan(int b, int ws, int* inc,
                                           int* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int width = ws < 32 ? ws : 32;
  int x = b;
  for (int o = 1; o < width; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o, width);
    if ((lane & (width - 1)) >= o) x += y;
  }
  if (ws > 32) {
    if (lane == 31 && t < kMergeLanes) warp_tot[warp] = x;
    __syncthreads();
    if (t < kMergeLanes) {
      for (int w = warp & ~(ws / 32 - 1); w < warp; ++w) x += warp_tot[w];
    }
  }
  if (t < kMergeLanes) inc[t] = x;
  __syncthreads();
}

// The 16-byte group of segment words [d0, d0 + 4): the segment's bits
// [32 d0, min(32 d0 + 128, total)), lane l holding bits [inc[l - 1],
// inc[l]) in its words src[l + k * nb], k < cap (zero past its bits, as
// K4 and K5 store them). From the lane holding bit 32 d0 (binary search
// of the scan), the words that hold the group's bits are gathered
// kGather at a time: a round issues all its loads before it uses one,
// then ORs each word into the group at its bit offset.
__device__ __forceinline__ void gather_group(unsigned (&v)[4], int d0,
                                             const int* inc, int ws,
                                             const unsigned* __restrict__ src,
                                             size_t nb) {
  const int p0 = 32 * d0;
  const int p1 = min(p0 + 128, inc[ws - 1]);
  int l = jt::upper_bound(inc, ws, p0);
  int off = l ? inc[l - 1] : 0;
  int k = (p0 - off) >> 5;
  while (l < ws && off + 32 * k < p1) {
    unsigned w[kGather];
    int at[kGather];  // bit offset of w[i] in the group; 128: no word
#pragma unroll
    for (int i = 0; i < kGather; ++i) {
      w[i] = 0u;
      at[i] = 128;
      if (l < ws && off + 32 * k < p1) {
        w[i] = src[l + (size_t)k * nb];
        at[i] = off + 32 * k - p0;
        if (off + 32 * (k + 1) < inc[l]) {
          ++k;
        } else {  // the next lane that holds bits
          off = inc[l];
          k = 0;
          do {
            ++l;
          } while (l < ws && inc[l] == off);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kGather; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sh = at[i] - 32 * j;
        if (sh >= 0 && sh < 32) v[j] |= w[i] >> sh;
        if (sh < 0 && sh > -32) v[j] |= w[i] << -sh;
      }
    }
  }
}

// K8. Block b holds segments s0 = b * (kMergeLanes / ws) onwards; thread
// t < kMergeLanes loads lane t's count, and after the scan every thread
// builds 16-byte groups of the block's words, which are adjacent in segs:
// a group past its segment's total is zeros, a group below it is
// gathered from the words of the lanes that cover it (gather_group).
__global__ void __launch_bounds__(kMergeMaxThreads)
merge_rows_words_kernel(const unsigned* __restrict__ words,
                  const int* __restrict__ bits, int nb, int cap, int nbh,
                  int nbw, int ws, unsigned* __restrict__ segs,
                  int* __restrict__ seg_bits) {
  __shared__ int inc[kMergeLanes];
  __shared__ int warp_tot[kMergeLanes / 32];
  const int t = threadIdx.x;
  const int per_block = kMergeLanes / ws;
  const int per_row = (nbw + ws - 1) / ws;
  const int nseg = nbh * per_row;
  const int s0 = blockIdx.x * per_block;
  int b = 0;
  if (t < kMergeLanes) {
    const int s = s0 + t / ws;
    const int col = (s % per_row) * ws + t % ws;
    // A block past cap words overflowed (the encode retries at a larger
    // cap); clamping keeps its bits inside the segment meanwhile.
    if (s < nseg && col < nbw) {
      b = min(bits[(size_t)(s / per_row) * nbw + col], cap * 32);
    }
  }
  merge_scan(b, ws, inc, warp_tot);
  if (t < kMergeLanes && t % ws == ws - 1 && s0 + t / ws < nseg) {
    seg_bits[s0 + t / ws] = inc[t];
  }
  const int seg_words = ws * (cap + 1);
  const int live = min(per_block, nseg - s0);
  uint4* out = reinterpret_cast<uint4*>(segs + (size_t)s0 * seg_words);
  const int groups = live * (seg_words / 4);
  for (int g = t; g < groups; g += blockDim.x) {
    const int p = 4 * g / seg_words;
    const int d0 = 4 * g - p * seg_words;
    const int* pinc = inc + p * ws;
    unsigned v[4] = {0u, 0u, 0u, 0u};
    if (32 * d0 < pinc[ws - 1]) {
      const int s = s0 + p;
      gather_group(v, d0, pinc, ws,
                   words + (size_t)(s / per_row) * nbw + (s % per_row) * ws,
                   nb);
    }
    out[g] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void fill_zero4_kernel(uint4* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    out[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The floor of a kernel that must read a segment's bit counts before it
// stores it: K8's launch shape (max(ws, 32) threads, one segment, two at
// ws 16), each thread loads one count, the block sums each segment's
// (shuffles, one barrier), writes seg_bits and stores the segments as
// zeros with 16-byte stores. Its segments are not K8's; only its time is.
__global__ void __launch_bounds__(128)
count_fill_kernel(const int* __restrict__ bits, int cap, int nbh, int nbw,
                  int ws, unsigned* __restrict__ segs,
                  int* __restrict__ seg_bits) {
  __shared__ int warp_tot[4];
  const int t = threadIdx.x, lane = t & 31;
  const int lanes = ws < 32 ? 32 : ws, per_block = lanes / ws;
  const int per_row = (nbw + ws - 1) / ws;
  const int nseg = nbh * per_row;
  const int s0 = blockIdx.x * per_block;
  const int live = min(per_block, nseg - s0);
  const int s = s0 + t / ws, col = (s % per_row) * ws + t % ws;
  int x = (s < nseg && col < nbw)
              ? min(bits[(size_t)(s / per_row) * nbw + col], cap * 32)
              : 0;
  const int width = ws < 32 ? ws : 32;
  for (int o = width / 2; o; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o, width);
  }
  if (lane == 0) warp_tot[t >> 5] = x;
  __syncthreads();
  if (t % ws == 0 && t / ws < live) {
    int total = 0;
    for (int w = t >> 5; w < (t + ws + 31) >> 5; ++w) total += warp_tot[w];
    seg_bits[s0 + t / ws] = ws < 32 ? x : total;
  }
  const int seg_groups = ws * (cap + 1) / 4;
  uint4* out = reinterpret_cast<uint4*>(segs) + (size_t)s0 * seg_groups;
  for (int g = t; g < live * seg_groups; g += blockDim.x) {
    out[g] = make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace

extern "C" int jt_count_fill(const int* bits, int cap, int nbh, int nbw,
                             int ws, unsigned* segs, int* seg_bits,
                             cudaStream_t stream) {
  const int nseg = nbh * ((nbw + ws - 1) / ws);
  const int lanes = ws < 32 ? 32 : ws;
  if (nseg > 0) {
    count_fill_kernel<<<(nseg + lanes / ws - 1) / (lanes / ws), lanes, 0,
                        stream>>>(bits, cap, nbh, nbw, ws, segs, seg_bits);
  }
  return (int)cudaGetLastError();
}

// Thread blocks of this K8 one SM holds at width ws and cap, or -1 on an
// error; launches nothing.
extern "C" int jt_merge_rows_words_per_sm(int ws, int cap) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, merge_rows_words_kernel, merge_threads(ws, ws * (cap + 1)),
          0) != cudaSuccess) {
    return -1;
  }
  return n;
}

extern "C" int jt_merge_rows_words(const unsigned* words, const int* bits,
                                   int nb, int cap, int nbh, int nbw, int ws,
                                   unsigned* segs, int* seg_bits,
                                   cudaStream_t stream) {
  const int nseg = nbh * ((nbw + ws - 1) / ws);
  const int per_block = kMergeLanes / ws;
  if (nseg > 0) {
    merge_rows_words_kernel<<<(nseg + per_block - 1) / per_block,
                              merge_threads(ws, ws * (cap + 1)), 0,
                              stream>>>(words, bits, nb, cap, nbh, nbw, ws,
                                        segs, seg_bits);
  }
  return (int)cudaGetLastError();
}

// Zeros out[0, n_words) (n_words a multiple of 4, out 16-byte aligned)
// with 16-byte stores and nothing else: `blocks` blocks of 256 threads.
extern "C" int jt_fill_zero4(unsigned* out, long long n_words, int blocks,
                             cudaStream_t stream) {
  if (n_words % 4 || (reinterpret_cast<uintptr_t>(out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  fill_zero4_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<uint4*>(out),
                                                n_words / 4);
  return (int)cudaGetLastError();
}
