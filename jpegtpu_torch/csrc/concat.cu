// K8 + K9 + K10 + K11: per-block bit streams -> one scan-order stream, or
// one stream per image of a batch.
//
// Kernel A (merge_rows) replaces jpegtpu/entropy/pallas_concat.py:
// merge_sublanes_pallas (_merge_kernel / _merge_kernel_skew, every ws).
// Kernel B (stream_concat) replaces pallas_concat.py: stream_concat_pallas
// (_stream_kernel). Kernel D (stream_concat_chunked) replaces
// pallas_concat.py: stream_concat_chunked (_stream_chunked_kernel) and the
// OR-combine of its chunks in concat_raw_chunked. Kernel C
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
// work in shared memory or with atomics:
// - A: one thread block of max(ws, 32) threads holds max(ws, 32) / ws
//   segments. A shared-memory Hillis-Steele scan of the bit counts,
//   masked at segment edges; each thread funnel-shifts its block's words by
//   offset & 31 and ORs them into its segment in shared memory with shared
//   atomicOr; the block's segments, adjacent in the output, go out in one
//   coalesced pass. The TPU's one-hot MXU deposit and lane skew do not
//   exist here. The segments live in dynamic shared memory: above 48 KB
//   (the color scan's per-MCU streams of E * cap words reach it) the launch
//   opts in to the device's larger limit first, and a block past that
//   limit is refused (jt_merge_rows_max_cap says where it lies for a ws).
// - B: one thread block per segment; each thread builds one output word
//   from two neighbouring segment words (funnel shift) and plain-stores it
//   when all its 32 bits are this segment's, atomicOr's it into the zeroed
//   output when it shares the word with a neighbouring segment (the first
//   and last word). The scan's wrapper runs B where jpegtpu's stream
//   buffer is VMEM-resident (its concat_mode), D everywhere else.
// - D: one thread block per tile of T consecutive segments. The TPU's
//   chunks are worst-case-sized VMEM blocks that an XLA epilogue ORs
//   together; here a tile's worst case (T full segments plus one word of
//   bit residue) must fit the block's dynamic shared memory (opt-in past
//   48 KB; the wrapper sizes T, and refuses a segment that alone does not
//   fit). The block zeroes the words its tile actually covers, from the
//   word floor of its first segment's offset to its last segment's end,
//   places each segment there with B's funnel shift (plain stores inside a
//   segment, shared atomicOr on the two words it shares with neighbours),
//   and writes the window out coalesced: plain stores inside, global
//   atomicOr on its first and last word, which neighbouring tiles share.
//   So global memory sees each stream word once, and one launch does what
//   the TPU does in a kernel and an epilogue.
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

constexpr int kLanes = 128;
constexpr int kMinThreads = 32;
constexpr int kStreamThreads = 256;

__host__ __device__ inline int merge_threads(int ws) {
  return ws < kMinThreads ? kMinThreads : ws;
}

__global__ void __launch_bounds__(kLanes)
merge_rows_kernel(const unsigned* __restrict__ words,
                  const int* __restrict__ bits, int nb, int cap, int nbh,
                  int nbw, int ws, unsigned* __restrict__ segs,
                  int* __restrict__ seg_bits) {
  extern __shared__ unsigned seg[];  // blockDim.x / ws segments
  __shared__ int scan[kLanes];
  const int t = threadIdx.x;
  const int per_block = blockDim.x / ws;
  const int per_row = (nbw + ws - 1) / ws;
  const int nseg = nbh * per_row;
  const int s0 = blockIdx.x * per_block;
  const int s = s0 + t / ws;
  const int l = t % ws;
  const int col = (s % per_row) * ws + l;
  const size_t blk = (size_t)(s / per_row) * nbw + col;
  // A block past cap words overflowed (the encode retries at a larger
  // cap); clamping keeps every deposit inside the segment meanwhile.
  const int b = (s < nseg && col < nbw) ? min(bits[blk], cap * 32) : 0;
  const int seg_words = ws * (cap + 1);
  for (int i = t; i < per_block * seg_words; i += blockDim.x) seg[i] = 0u;

  scan[t] = b;  // inclusive Hillis-Steele scan inside each segment
  __syncthreads();
  for (int off = 1; off < ws; off <<= 1) {
    const int v = l >= off ? scan[t - off] : 0;
    __syncthreads();
    scan[t] += v;
    __syncthreads();
  }
  const int excl = scan[t] - b;
  const int r = excl & 31;
  const int nw = (b + 31) >> 5;
  unsigned* mine = seg + (t / ws) * seg_words;
  for (int j = 0; j < nw; ++j) {
    const unsigned w = words[(size_t)j * nb + blk];
    const int idx = (excl >> 5) + j;
    atomicOr(&mine[idx], w >> r);
    if (r) atomicOr(&mine[idx + 1], w << (32 - r));
  }
  __syncthreads();
  const int live = min(per_block, nseg - s0);
  unsigned* dst = segs + (size_t)s0 * seg_words;
  for (int i = t; i < live * seg_words; i += blockDim.x) dst[i] = seg[i];
  if (l == ws - 1 && s < nseg) seg_bits[s] = scan[t];
}

// Word i of a segment (seg_words words, MSB first) placed at bit residue
// r in [0, 31]: the funnel shift of its words i - 1 and i.
__device__ inline unsigned shifted_word(const unsigned* __restrict__ src,
                                        int seg_words, long long i, int r) {
  const unsigned cur = i < seg_words ? src[i] : 0u;
  if (!r) return cur;
  const unsigned prev = (i > 0 && i <= seg_words) ? src[i - 1] : 0u;
  return (cur >> r) | (prev << (32 - r));
}

// Place one segment of sb bits (seg_words words, MSB first) at bit `off`
// of a zeroed stream of out_words words.
__device__ inline void place_segment(const unsigned* __restrict__ src,
                                     int seg_words, long long off,
                                     long long sb, unsigned* __restrict__ out,
                                     long long out_words) {
  if (sb <= 0) return;
  const long long first = off >> 5;
  const long long n = ((off + sb - 1) >> 5) - first + 1;
  const int r = (int)(off & 31);
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned v = shifted_word(src, seg_words, i, r);
    const long long d = first + i;
    if (d >= out_words) break;
    if (d * 32 >= off && d * 32 + 32 <= off + sb) {
      out[d] = v;
    } else {
      atomicOr(&out[d], v);
    }
  }
}

__global__ void __launch_bounds__(kStreamThreads)
stream_concat_kernel(const unsigned* __restrict__ segs,
                     const int* __restrict__ seg_bits,
                     const long long* __restrict__ offs, int seg_words,
                     unsigned* __restrict__ out, long long out_words) {
  const int s = blockIdx.x;
  place_segment(segs + (size_t)s * seg_words, seg_words, offs[s],
                seg_bits[s], out, out_words);
}

__global__ void __launch_bounds__(kStreamThreads)
stream_concat_chunked_kernel(const unsigned* __restrict__ segs,
                             const int* __restrict__ seg_bits,
                             const long long* __restrict__ offs, int nseg,
                             int seg_words, int tile, int window,
                             unsigned* __restrict__ out,
                             long long out_words) {
  extern __shared__ unsigned win[];  // window words, from word `base`
  const int s0 = blockIdx.x * tile;
  const int s1 = min(s0 + tile, nseg);
  const long long start = offs[s0];
  const long long end = offs[s1 - 1] + seg_bits[s1 - 1];
  if (end <= start) return;  // every segment of the tile is empty
  const long long base = start >> 5;
  // words the tile covers; <= window for segments of <= seg_words * 32
  // bits, and never more are touched
  const int n = (int)min(((end - 1) >> 5) - base + 1, (long long)window);
  for (int i = threadIdx.x; i < n; i += blockDim.x) win[i] = 0u;
  __syncthreads();
  for (int s = s0; s < s1; ++s) {
    const long long sb = seg_bits[s];
    if (sb <= 0) continue;
    const long long off = offs[s] - base * 32;  // bit offset in the window
    const int first = (int)(off >> 5);
    const int cnt = (int)(((off + sb - 1) >> 5) - first + 1);
    const int r = (int)(off & 31);
    const unsigned* src = segs + (size_t)s * seg_words;
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const int d = first + i;
      if (d >= n) break;
      const unsigned v = shifted_word(src, seg_words, i, r);
      if (i > 0 && i < cnt - 1) {
        win[d] = v;  // all 32 bits are this segment's
      } else {
        atomicOr(&win[d], v);  // shared with the neighbouring segment
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long d = base + i;
    if (d >= out_words) break;
    if (i > 0 && i < n - 1) {
      out[d] = win[i];
    } else {
      atomicOr(&out[d], win[i]);  // shared with the neighbouring tile
    }
  }
}

// The sum of x over the block's threads before this one (blockDim.x a
// multiple of 32); *total, if given, gets the sum over all of them.
// warp_tot holds 32 values of shared memory.
__device__ long long block_exclusive_sum(long long x, long long* warp_tot,
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

// K11. Inclusive scan of one image's P bit counts into inc[0, P), by the
// block: each thread sums a run of ceil(P / blockDim.x) counts, one block
// scan of the run sums, then each thread writes its run's running sums.
__device__ void scan_counts(const int* __restrict__ bits, int P,
                            long long* inc, long long* warp_tot) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) inc[i] = bits[i];
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
    scan_counts(seg_bits + s0, P, inc_smem, warp_tot);
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
          v[w] = rows_word(d0 + w, s, inc, P, src, seg_words, padded,
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
    const long long ex = block_exclusive_sum(x, warp_tot, &chunk);
    if (i < segs_per_image) inc_out[s0 + i] = carry + ex + x;
    carry += chunk;
  }
}

}  // namespace

// The largest cap whose segments fit the current device's opt-in shared
// memory per block at segment width ws (beside the kernel's static scan
// array), or -1 if the device cannot be queried.
extern "C" int jt_merge_rows_max_cap(int ws) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  const int seg_bytes = optin - (int)(kLanes * sizeof(int));
  return seg_bytes / (merge_threads(ws) * (int)sizeof(unsigned)) - 1;
}

extern "C" int jt_merge_rows(const unsigned* words, const int* bits, int nb,
                             int cap, int nbh, int nbw, int ws, unsigned* segs,
                             int* seg_bits, cudaStream_t stream) {
  const int threads = merge_threads(ws);
  const int nseg = nbh * ((nbw + ws - 1) / ws);
  const int per_block = threads / ws;
  const int nblocks = (nseg + per_block - 1) / per_block;
  if (nseg > 0) {
    const size_t smem = (size_t)(cap + 1) * threads * sizeof(unsigned);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          merge_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    merge_rows_kernel<<<nblocks, threads, smem, stream>>>(
        words, bits, nb, cap, nbh, nbw, ws, segs, seg_bits);
  }
  return (int)cudaGetLastError();
}

extern "C" int jt_stream_concat(const unsigned* segs, const int* seg_bits,
                                const long long* offs, int nseg,
                                int seg_words, unsigned* out,
                                long long out_words, cudaStream_t stream) {
  if (nseg > 0) {
    stream_concat_kernel<<<nseg, kStreamThreads, 0, stream>>>(
        segs, seg_bits, offs, seg_words, out, out_words);
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

// Tiles of `tile` segments; the wrapper checked that tile * seg_words + 1
// words fit the device's opt-in shared memory.
extern "C" int jt_stream_concat_chunked(const unsigned* segs,
                                        const int* seg_bits,
                                        const long long* offs, int nseg,
                                        int seg_words, int tile,
                                        unsigned* out, long long out_words,
                                        cudaStream_t stream) {
  if (nseg > 0 && tile > 0) {
    const int window = tile * seg_words + 1;
    const size_t smem = (size_t)window * sizeof(unsigned);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          stream_concat_chunked_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    stream_concat_chunked_kernel<<<(nseg + tile - 1) / tile, kStreamThreads,
                                   smem, stream>>>(
        segs, seg_bits, offs, nseg, seg_words, tile, window, out, out_words);
  }
  return (int)cudaGetLastError();
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
