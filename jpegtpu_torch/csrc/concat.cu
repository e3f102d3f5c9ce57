// K8 + K9 + K10 + K11: per-block bit streams -> one scan-order stream, or
// one stream per image of a batch.
//
// Kernel A (merge_rows) replaces jpegtpu/entropy/pallas_concat.py:
// merge_sublanes_pallas (_merge_kernel / _merge_kernel_skew, every ws).
// Kernel B (stream_concat) replaces pallas_concat.py: stream_concat_pallas
// (_stream_kernel) and, when asked, the tail padding after it
// (treepack._apply_tail_padding). Kernel D (stream_concat_chunked)
// replaces pallas_concat.py: stream_concat_chunked (_stream_chunked_kernel)
// and the OR-combine of its chunks in concat_raw_chunked, with the same
// tail padding when asked. Kernel C
// (stream_concat_rows) replaces pallas_concat.py: _stream_concat_rows
// (_stream_rows_kernel, via concat_segments_pallas) and the tail padding
// after it (treepack.apply_tail_padding_segments).
//
// A row segment is up to ws consecutive blocks of one block row (ws a power
// of two, 16..128): segment (br, c) holds blocks br * nbw + c * ws + l,
// l < ws, the last segment of a row ragged when nbw % ws != 0 (pad lanes
// contribute nothing, which replaces valid_mask). Segments are in scan
// order (br, c), each ws * (cap + 1) words. The single-image scan uses
// ws = 128; a batch of images stacked vertically uses the narrowest width
// that holds a row of <= 64 blocks, so no segment is mostly empty.
//
// Bound: bytes, every kernel (each stream word is read once and written
// once per kernel; ~7 MB at 12 MPix, cap 8, ~2 us each at 3.35 TB/s), so
// the design keeps every global access coalesced and does the bit-granular
// work in shared memory or in registers:
// - A: one thread block of max(ws, 32) threads stages one segment (two at
//   ws 16) in dynamic shared memory, a thread a block, and writes each
//   word of it once, by a 16-byte store. Thread t loads block t's count
//   and, with it, the block's first word (which holds bits unless the
//   block is empty) while the block zeroes its segment in shared memory;
//   once the count is in, the block's next words (4, or 8 for MCU
//   streams) are in flight while the block scans the counts with warp
//   shuffles (and, past ws 32, one step across the warps: one or two
//   barriers in all). Each block then deposits its words at its offset:
//   plain stores for the words it alone covers, atomicOr on its first
//   and last word, which it may share. After one barrier the segment goes
//   out: its valid words from shared memory, the zeros past them (85% of
//   a Q50 segment) straight from registers. The TPU's one-hot MXU
//   deposit and lane skew do not exist here. Above 48 KB (4:2:0 MCU
//   streams from rung 16) the launch opts in to the device's larger
//   limit, and a cap past that limit is refused (jt_merge_rows_max_cap).
//   What bounds it at one frame is not its bytes but the chain a block
//   waits through before it can store: the counts, then the words.
//   tools/k8_word_parallel.cu keeps a word-parallel design with no
//   segment in shared memory (PERF.md compares them).
// - B and D: one launch writes every stream word once with plain stores
//   (16 bytes where aligned), the tail padding and the total: no
//   zero-fill, no prefix sums, atomics or padding ops around it. B runs
//   where jpegtpu's stream buffer is VMEM-resident (its concat_mode) and
//   on every staged entropy scan, D everywhere else; the two share one
//   body (join_stream) and differ in their launch shape. Each thread
//   block scans every segment's bit count into shared memory (16-byte
//   loads; int64 inclusive ends, the total the last), takes an equal
//   share of the words that hold bits or the pad and builds each 4-word
//   group of it from the segment that covers its first bit (binary
//   search; five loads and funnel shifts when one segment holds all 128
//   bits, else C's word-by-word walk across segment ends, empty segments
//   and segments shorter than a word, which also sets the pad's 1s from
//   the total to the byte), and stores an equal share of the zeros past
//   them with 16-byte stores. Block 0 writes the total, rounded up to the
//   byte when the stream is padded. The zeros are most of the stream (5
//   of the 6.1 MB of a 3024 x 4032 gray scan, 83% / 89% of the 8K
//   streams), and the design before B placed each segment with a thread
//   block of its own into a buffer zeroed by a launch of its own, ORed its
//   edge words in with atomics, after a cumsum and a subtraction, and
//   left the pad to some twenty elementwise launches.
//   B's streams are small (1,512 segments of a 3024 x 4032 gray scan,
//   378 of the 4:2:0 MCU stream), so the scan each block repeats is
//   cheap and B takes one thread block of 512 an SM (kK9Threads), D one of
//   1024 (tools/torch_kernel_ab.py's sweep).
// - D (K10): B's body at 8K, one thread block of 1024 an SM (its scan: 8
//   bytes a segment, 35 KB for the 8K frame's 4,320). The TPU's chunks
//   are worst-case-sized VMEM blocks that an XLA epilogue ORs together;
//   they have no counterpart here. At 8K the zeros are 83% / 89% of the
//   16.6 MB (gray) / 24.9 MB (4:2:0) stream.
//   tools/k10_warp_per_segment.cu places a segment a warp instead
//   (PERF.md compares the two).
// - B and D: a stream of more segments than shared memory holds takes
//   C's second launch, which writes the scan to global scratch first.
// - C: every slab word is written once, by a plain coalesced store (16
//   bytes where the slab is aligned): no zero-fill, no global atomics, no
//   prefix sums outside the launch. The slabs are 134-201 MB at the
//   batch's 1024 x 512 x 512 and the segments' valid words a tenth of
//   that, so the slab writes bound it. One block per (image, tile of
//   slab words), image-major; the tile grows with the image's segment
//   count P (rows_tile_words in entropy/concat.py), so each block's
//   words outweigh the scan it repeats, and shrinks while the grid
//   would leave SMs idle (a 2-image batch). The block scans its image's P
//   bit counts in shared memory (int64 inclusive ends), which gives each
//   segment's offset and the image's total; block (image, 0) writes the
//   total, rounded up to the byte. A tile past the image's total (most
//   of a slab: its words are C a block, its bits ~1.5 words a block)
//   learns the total from a warp sum and stores zeros with no scan and
//   no barrier. For each of its words d, a thread finds the segment
//   holding bit 32 d by binary search and funnel-shifts that segment's
//   words, and those of the following segments, until 32 bits are
//   covered (empty segments and segments shorter than a word share
//   words); the bits from the total to the byte get the pad's 1s in the
//   same store, and words past it are 0. The segments' valid words are
//   read about once, the bit counts from L2. What keeps it above its
//   bound is that word building: a chain of dependent shared-memory and
//   global reads per word in the tiles that hold an image's bits, not
//   the slab's bytes. The TPU's lane-roll deposits are VMEM tiling and
//   have no counterpart. An image of more segments than the opt-in
//   shared memory holds (some 29,000, a batch of 200 MPix images) takes
//   a second launch first, which writes the scans to global scratch.
// Shift counts are kept in [0, 31]: a shift by 32 is undefined in CUDA.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitjoin.cuh"

namespace {

// K8: a thread block stages merge_lanes(ws) = max(ws, 32) blocks, one
// segment (two at ws 16), a thread each. A block's words pass through
// registers kSpec at a time: kMergeSpecLong where blocks may hold
// kMergeLongCap words or more (the MCU streams), else kMergeSpecShort;
// the first kMergeEager of them are loaded with its bit count, before it
// is known (the first word of a block holds bits unless it is empty).
constexpr int kMergeSpecShort = 4;
constexpr int kMergeSpecLong = 8;
constexpr int kMergeLongCap = 32;
constexpr int kMergeEager = 1;
constexpr int kMergeMaxLanes = 128;  // the widest segment
constexpr int kStreamThreads = 256;
constexpr int kChunkThreads = 1024;  // K10: one thread block an SM
// K9: one thread block an SM (tools/torch_kernel_ab.py's sweep of 128-1024
// threads at 1-12 blocks an SM: the fastest or within 3% on every stream)
constexpr int kK9Threads = 512;

__host__ __device__ inline int merge_lanes(int ws) {
  return ws < 32 ? 32 : ws;
}

// K8's dynamic shared memory: the block's segments, merge_lanes(ws) * (cap
// + 1) words.
inline size_t merge_smem(int ws, int cap) {
  return (size_t)merge_lanes(ws) * (cap + 1) * sizeof(unsigned);
}

// The segment-local inclusive scan of the block's counts (b: this lane's),
// ws lanes a segment: warp shuffles, then for ws > 32 (one segment a
// block) the totals of the earlier warps. Thread t writes inc[t]. Its
// barriers also publish what the block wrote to shared memory before.
__device__ __forceinline__ int merge_scan(int b, int ws, int* inc,
                                          int* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int width = ws < 32 ? ws : 32;
  int x = b;
  for (int o = 1; o < width; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o, width);
    if ((lane & (width - 1)) >= o) x += y;
  }
  if (ws > 32) {
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    for (int w = 0; w < warp; ++w) x += warp_tot[w];
  }
  inc[t] = x;
  __syncthreads();
  return x;
}

// K8. Block b holds segments s0 = b * (lanes / ws) onwards, staged in
// shared memory, which it zeroes while lane t loads block t's count and
// its first kMergeEager words; once the count is in, the lane loads its
// next words (up to kSpec), in flight while the block scans the counts.
// Each lane then deposits its words at its offset (plain stores for the
// words it alone covers, atomicOr on its first and last word, which it
// may share with its neighbours; kSpec words a round), and after one
// barrier every word of the segments goes out once, in 16-byte groups:
// the valid ones from shared memory, the zeros past them from registers.
// Storing those zeros before the deposit, as soon as the scan gives each
// segment's total, was slower on the gray rows and the batches and faster
// only on the single 4:2:0 frame (tools/torch_kernel_ab.py): there they
// compete with the word loads.
template <int kSpec>
__global__ void __launch_bounds__(kMergeMaxLanes)
merge_rows_kernel(const unsigned* __restrict__ words,
                  const int* __restrict__ bits, int nb, int cap, int nbh,
                  int nbw, int ws, unsigned* __restrict__ segs,
                  int* __restrict__ seg_bits) {
  extern __shared__ uint4 stage4[];
  unsigned* stage = reinterpret_cast<unsigned*>(stage4);
  __shared__ int inc[kMergeMaxLanes];
  __shared__ int warp_tot[kMergeMaxLanes / 32];
  const int t = threadIdx.x;
  const int per_block = merge_lanes(ws) / ws;
  const int per_row = (nbw + ws - 1) / ws;
  const int nseg = nbh * per_row;
  const int s0 = blockIdx.x * per_block;
  const int live = min(per_block, nseg - s0);
  const int seg_words = ws * (cap + 1), seg_groups = seg_words / 4;
  const int s = s0 + t / ws;
  const int col = (s % per_row) * ws + t % ws;
  const size_t blk = (size_t)(s / per_row) * nbw + col;
  const bool real = s < nseg && col < nbw;
  int b = real ? bits[blk] : 0;
  unsigned w[kSpec];
#pragma unroll
  for (int i = 0; i < kSpec; ++i) {
    w[i] = i < kMergeEager && real && i < cap ? words[(size_t)i * nb + blk]
                                              : 0u;
  }
  for (int i = t; i < live * seg_groups; i += blockDim.x) {
    stage4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // A block past cap words overflowed (the encode retries at a larger
  // cap); clamping keeps its bits inside the segment meanwhile.
  b = min(b, cap * 32);
  const int nw = (b + 31) >> 5;
#pragma unroll
  for (int i = 0; i < kSpec; ++i) {
    if (i >= nw) {
      w[i] = 0u;
    } else if (i >= kMergeEager) {
      w[i] = words[(size_t)i * nb + blk];
    }
  }
  const int x = merge_scan(b, ws, inc, warp_tot);
  if (t % ws == ws - 1 && t / ws < live) seg_bits[s] = x;
  if (b > 0) {
    const int excl = x - b, f = excl >> 5, r = excl & 31;
    const int n_out = ((excl + b - 1) >> 5) - f + 1;  // words it touches
    unsigned* mine = stage + (t / ws) * seg_words + f;
    unsigned prev = 0u;
    for (int c = 0; c < n_out; c += kSpec) {
      if (c) {
#pragma unroll
        for (int i = 0; i < kSpec; ++i) {
          w[i] = c + i < nw ? words[(size_t)(c + i) * nb + blk] : 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < kSpec; ++i) {
        const int j = c + i;
        if (j < n_out) {
          const unsigned v = r ? (w[i] >> r) | (prev << (32 - r)) : w[i];
          if (j == 0 || j == n_out - 1) {
            atomicOr(&mine[j], v);
          } else {
            mine[j] = v;
          }
        }
        prev = w[i];
      }
    }
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(segs + (size_t)s0 * seg_words);
  for (int p = 0; p < live; ++p) {
    const int valid = (inc[p * ws + ws - 1] + 31) >> 5;
    for (int g = t; g < seg_groups; g += blockDim.x) {
      out[p * seg_groups + g] = 4 * g < valid ? stage4[p * seg_groups + g]
                                              : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Word boundaries of share i of n words cut into `parts` shares of whole
// 4-word groups.
__device__ __forceinline__ long long share_start(long long n, long long i,
                                                 long long parts) {
  const long long each = ((n + parts - 1) / parts + 3) & ~3LL;
  return min(n, i * each);
}

// Loads the nseg bit counts into inc[0, nseg) as int64, in 16-byte loads
// where the counts are aligned.
__device__ inline void load_counts(const int* __restrict__ bits, int nseg,
                                   long long* inc) {
  const int nvec = (reinterpret_cast<uintptr_t>(bits) & 15) ? 0 : nseg >> 2;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int4 c = reinterpret_cast<const int4*>(bits)[i];
    inc[4 * i] = c.x;
    inc[4 * i + 1] = c.y;
    inc[4 * i + 2] = c.z;
    inc[4 * i + 3] = c.w;
  }
  for (int i = 4 * nvec + threadIdx.x; i < nseg; i += blockDim.x) {
    inc[i] = bits[i];
  }
}

// B and D. Every block scans all nseg bit counts (in shared memory, or
// reads the scan from inc_global) and writes its share of the stream's
// words: first of those that hold bits or the pad, then of the zeros past
// them. pad < 0: the total as it is, no pad; 0: the total rounded up to
// the byte, the pad bits 0; 1: the same, the pad bits 1 (T.81 F.1.2.3).
template <bool kScanInSmem>
__device__ __forceinline__ void join_stream(
    const unsigned* __restrict__ segs, const int* __restrict__ seg_bits,
    const long long* __restrict__ inc_global, int nseg, int seg_words,
    int pad, unsigned* __restrict__ out, long long out_words,
    long long* __restrict__ total_out, long long* inc_smem,
    long long* warp_tot) {
  const long long* inc = inc_global;
  if (kScanInSmem) {
    load_counts(seg_bits, nseg, inc_smem);
    jt::scan_in_place(inc_smem, nseg, warp_tot);
    inc = inc_smem;
  }
  const long long total = inc[nseg - 1];
  const long long padded = pad < 0 ? total : (total + 7) & ~7LL;
  if (blockIdx.x == 0 && threadIdx.x == 0) *total_out = padded;
  // the pad shares the word of bit `total`, so valid words end with it
  const long long valid = min((padded + 31) >> 5, out_words);
  const long long lo = share_start(valid, blockIdx.x, gridDim.x);
  const long long hi = share_start(valid, blockIdx.x + 1, gridDim.x);
  for (long long g = jt::first_group(lo, jt::line_phase(out)) +
                     4LL * threadIdx.x;
       g < hi; g += 4LL * blockDim.x) {
    const long long d0 = max(g, lo), d1 = min(g + 4, hi);
    unsigned v[4] = {0u, 0u, 0u, 0u};
    int s = jt::upper_bound(inc, nseg, 32 * d0);
    const long long off = s ? inc[s - 1] : 0;
    if (d1 - d0 == 4 && s < nseg && 32 * d0 + 128 <= inc[s]) {
      jt::segment_words4(v, segs + (size_t)s * seg_words, seg_words,
                         32 * d0 - off);
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (d0 + w < d1) {
          v[w] = jt::rows_word(d0 + w, s, inc, nseg, segs, seg_words,
                               padded, pad > 0);
        }
      }
    }
    jt::store_words(out, d0, (int)(d1 - d0), v);
  }
  const long long nz = out_words - valid;
  jt::zero_words(out, valid + share_start(nz, blockIdx.x, gridDim.x),
                 valid + share_start(nz, blockIdx.x + 1, gridDim.x));
}

// K9: join_stream in blocks of kK9Threads (the bound's second argument
// keeps ptxas from spilling to reach more blocks an SM than K9 runs).
template <bool kScanInSmem>
__global__ void __launch_bounds__(kK9Threads, 1)
stream_concat_kernel(const unsigned* __restrict__ segs,
                     const int* __restrict__ seg_bits,
                     const long long* __restrict__ inc_global, int nseg,
                     int seg_words, int pad, unsigned* __restrict__ out,
                     long long out_words, long long* __restrict__ total_out) {
  extern __shared__ long long inc_smem[];
  __shared__ long long warp_tot[32];
  join_stream<kScanInSmem>(segs, seg_bits, inc_global, nseg, seg_words, pad,
                           out, out_words, total_out, inc_smem, warp_tot);
}

// K10: join_stream in blocks of 1024, one an SM.
template <bool kScanInSmem>
__global__ void __launch_bounds__(kChunkThreads)
stream_concat_chunked_kernel(const unsigned* __restrict__ segs,
                             const int* __restrict__ seg_bits,
                             const long long* __restrict__ inc_global,
                             int nseg, int seg_words, int pad,
                             unsigned* __restrict__ out, long long out_words,
                             long long* __restrict__ total_out) {
  extern __shared__ long long inc_smem[];
  __shared__ long long warp_tot[32];
  join_stream<kScanInSmem>(segs, seg_bits, inc_global, nseg, seg_words, pad,
                           out, out_words, total_out, inc_smem, warp_tot);
}

// One block per (image, tile of tile_words slab words), image-major. The
// image's scan is in shared memory (kScanInSmem) or, for an image of more
// segments than shared memory holds, in inc_global from rows_scan_kernel.
template <bool kScanInSmem>
__global__ void __launch_bounds__(kStreamThreads)
stream_concat_rows_kernel(const unsigned* __restrict__ segs,
                          const int* __restrict__ seg_bits,
                          const long long* __restrict__ inc_global,
                          int seg_words, int segs_per_image,
                          long long tile_words, long long tiles, int pad_ones,
                          unsigned* __restrict__ out, long long slab_words,
                          long long* __restrict__ totals) {
  extern __shared__ long long inc_smem[];
  __shared__ long long warp_tot[32];
  const long long img = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const int P = segs_per_image;
  const size_t s0 = (size_t)img * P;
  // The image's total, summed by each warp on its own: most tiles lie past
  // it and store zeros with no barrier and no scan.
  long long total = 0;
  if (kScanInSmem) {
    for (int i = threadIdx.x & 31; i < P; i += 32) total += seg_bits[s0 + i];
    for (int o = 16; o; o >>= 1) {
      total += __shfl_xor_sync(0xffffffffu, total, o);
    }
  } else {
    total = inc_global[s0 + P - 1];
  }
  const long long padded = (total + 7) & ~7LL;
  if (tile == 0 && threadIdx.x == 0) totals[img] = padded;
  unsigned* slab = out + (size_t)img * slab_words;
  const long long lo = tile * tile_words;
  const long long hi = min(lo + tile_words, slab_words);
  if (32 * lo >= padded) {
    jt::zero_words(slab, lo, hi);
    return;
  }
  const long long* inc;
  if (kScanInSmem) {
    jt::scan_counts(seg_bits + s0, P, inc_smem, warp_tot);
    inc = inc_smem;
  } else {
    inc = inc_global + s0;
  }
  const unsigned* src = segs + s0 * seg_words;
  for (long long g = jt::first_group(lo, jt::line_phase(slab)) +
                     4LL * threadIdx.x;
       g < hi; g += 4LL * blockDim.x) {
    const long long d0 = max(g, lo), d1 = min(g + 4, hi);
    unsigned v[4] = {0u, 0u, 0u, 0u};
    if (32 * d0 < padded) {
      int s = jt::upper_bound(inc, P, 32 * d0);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (d0 + w < d1) {
          v[w] = jt::rows_word(d0 + w, s, inc, P, src, seg_words, padded,
                           pad_ones);
        }
      }
    }
    jt::store_words(slab, d0, (int)(d1 - d0), v);
  }
}

// K11's scan for images of more segments than shared memory holds: one
// block per image writes its inclusive scan to inc_out, in chunks of
// blockDim.x with a running carry.
__global__ void __launch_bounds__(kStreamThreads)
rows_scan_kernel(const int* __restrict__ seg_bits, int segs_per_image,
                 long long* __restrict__ inc_out) {
  __shared__ long long warp_tot[32];
  const size_t s0 = (size_t)blockIdx.x * segs_per_image;
  long long carry = 0;
  for (int c = 0; c < segs_per_image; c += blockDim.x) {
    const int i = c + threadIdx.x;
    const long long x = i < segs_per_image ? seg_bits[s0 + i] : 0;
    long long chunk = 0;
    const long long ex = jt::block_exclusive_sum(x, warp_tot, &chunk);
    if (i < segs_per_image) inc_out[s0 + i] = carry + ex + x;
    carry += chunk;
  }
}

}  // namespace

// The largest cap whose segments fit the current device's opt-in shared
// memory per block at segment width ws (beside the kernel's static
// arrays), or -1 if the device cannot be queried.
extern "C" int jt_merge_rows_max_cap(int ws) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  const int fixed = (kMergeMaxLanes + kMergeMaxLanes / 32) * (int)sizeof(int);
  return (optin - fixed) / (int)merge_smem(ws, 0) - 1;
}

using MergeKernel = void (*)(const unsigned*, const int*, int, int, int, int,
                            int, unsigned*, int*);

// K8's kernel for blocks of up to cap words.
static MergeKernel merge_rows_for(int cap) {
  return cap >= kMergeLongCap ? merge_rows_kernel<kMergeSpecLong>
                              : merge_rows_kernel<kMergeSpecShort>;
}

// Opts K8 in to its dynamic shared memory at (ws, cap) where that passes
// the 48 KB a launch gets without asking.
static cudaError_t merge_rows_optin(int ws, int cap) {
  const size_t smem = merge_smem(ws, cap);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(merge_rows_for(cap),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Thread blocks of K8 one SM holds at width ws and cap, or -1 on an
// error; launches nothing.
extern "C" int jt_merge_rows_per_sm(int ws, int cap) {
  int n = 0;
  if (merge_rows_optin(ws, cap) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, merge_rows_for(cap), merge_lanes(ws), merge_smem(ws, cap)) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}

extern "C" int jt_merge_rows(const unsigned* words, const int* bits, int nb,
                             int cap, int nbh, int nbw, int ws, unsigned* segs,
                             int* seg_bits, cudaStream_t stream) {
  const int nseg = nbh * ((nbw + ws - 1) / ws);
  const int per_block = merge_lanes(ws) / ws;
  if (nseg > 0) {
    const cudaError_t err = merge_rows_optin(ws, cap);
    if (err != cudaSuccess) return (int)err;
    merge_rows_for(cap)<<<(nseg + per_block - 1) / per_block,
                          merge_lanes(ws), merge_smem(ws, cap), stream>>>(
        words, bits, nb, cap, nbh, nbw, ws, segs, seg_bits);
  }
  return (int)cudaGetLastError();
}

// The current device's opt-in shared memory per block, in bytes, or -1 if
// the device cannot be queried.
extern "C" int jt_smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return optin;
}

using JoinKernel = void (*)(const unsigned*, const int*, const long long*,
                            int, int, int, unsigned*, long long, long long*);

// K9 (chunked: K10) with its scan in shared memory (nseg int64) or in
// global scratch.
static JoinKernel join_kernel(bool chunked, bool scratch) {
  if (chunked) {
    return scratch ? stream_concat_chunked_kernel<false>
                   : stream_concat_chunked_kernel<true>;
  }
  return scratch ? stream_concat_kernel<false> : stream_concat_kernel<true>;
}

// Thread blocks of the join one SM holds for nseg segments (scratch: the
// scan in global memory), or -1 on an error; launches nothing.
static int join_per_sm(bool chunked, int nseg, int scratch) {
  const JoinKernel kernel = join_kernel(chunked, scratch != 0);
  const size_t smem = scratch ? 0 : (size_t)nseg * sizeof(long long);
  int n = 0;
  if ((smem > 48 * 1024 &&
       cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem) != cudaSuccess) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, chunked ? kChunkThreads : kK9Threads, smem) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}

// One launch of `blocks` thread blocks when the scan fits shared memory;
// where it does not (the wrapper then passes inc_scratch, [nseg] int64),
// rows_scan_kernel writes it there first.
static int join(bool chunked, const unsigned* segs, const int* seg_bits,
                long long* inc_scratch, int nseg, int seg_words, int blocks,
                int pad, unsigned* out, long long out_words, long long* total,
                cudaStream_t stream) {
  const JoinKernel kernel = join_kernel(chunked, inc_scratch != nullptr);
  if (nseg <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = inc_scratch ? 0 : (size_t)nseg * sizeof(long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (inc_scratch) {
    rows_scan_kernel<<<1, kStreamThreads, 0, stream>>>(seg_bits, nseg,
                                                       inc_scratch);
  }
  kernel<<<blocks, chunked ? kChunkThreads : kK9Threads, smem, stream>>>(
      segs, seg_bits, inc_scratch, nseg, seg_words, pad, out, out_words,
      total);
  return (int)cudaGetLastError();
}

extern "C" int jt_stream_concat_per_sm(int nseg, int scratch) {
  return join_per_sm(false, nseg, scratch);
}

extern "C" int jt_stream_concat(const unsigned* segs, const int* seg_bits,
                                long long* inc_scratch, int nseg,
                                int seg_words, int blocks, int pad,
                                unsigned* out, long long out_words,
                                long long* total, cudaStream_t stream) {
  return join(false, segs, seg_bits, inc_scratch, nseg, seg_words, blocks,
              pad, out, out_words, total, stream);
}

extern "C" int jt_stream_concat_chunked_per_sm(int nseg, int scratch) {
  return join_per_sm(true, nseg, scratch);
}

extern "C" int jt_stream_concat_chunked(const unsigned* segs,
                                        const int* seg_bits,
                                        long long* inc_scratch, int nseg,
                                        int seg_words, int blocks, int pad,
                                        unsigned* out, long long out_words,
                                        long long* total,
                                        cudaStream_t stream) {
  return join(true, segs, seg_bits, inc_scratch, nseg, seg_words, blocks,
              pad, out, out_words, total, stream);
}

// One launch: blocks of tile_words slab words, each image's scan in shared
// memory. Where one image's P int64 sums do not fit the device's opt-in
// shared memory (the wrapper then passes inc_scratch, [nseg] int64), two:
// rows_scan_kernel writes every image's scan there first, and the joining
// blocks search it in L2.
extern "C" int jt_stream_concat_rows(const unsigned* segs,
                                     const int* seg_bits,
                                     long long* inc_scratch, int nseg,
                                     int seg_words, int segs_per_image,
                                     long long tile_words, int pad_ones,
                                     unsigned* out, long long slab_words,
                                     long long* totals, cudaStream_t stream) {
  if (nseg > 0 && segs_per_image > 0 && tile_words > 0) {
    const long long n_images = nseg / segs_per_image;
    const long long tiles =
        max(1LL, (slab_words + tile_words - 1) / tile_words);
    const unsigned blocks = (unsigned)(n_images * tiles);
    if (inc_scratch) {
      rows_scan_kernel<<<(unsigned)n_images, kStreamThreads, 0, stream>>>(
          seg_bits, segs_per_image, inc_scratch);
      stream_concat_rows_kernel<false>
          <<<blocks, kStreamThreads, 0, stream>>>(
              segs, seg_bits, inc_scratch, seg_words, segs_per_image,
              tile_words, tiles, pad_ones, out, slab_words, totals);
    } else {
      const size_t smem = (size_t)segs_per_image * sizeof(long long);
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            stream_concat_rows_kernel<true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
      }
      stream_concat_rows_kernel<true>
          <<<blocks, kStreamThreads, smem, stream>>>(
              segs, seg_bits, nullptr, seg_words, segs_per_image, tile_words,
              tiles, pad_ones, out, slab_words, totals);
    }
  }
  return (int)cudaGetLastError();
}
