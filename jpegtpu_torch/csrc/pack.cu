// K4: fused symbolize + Huffman pack, one thread per 8x8 block, its walk
// one step per nonzero; and K7: the pack of pre-fused elements, one thread
// per block.
//
// Replaces jpegtpu/entropy/pallas_pack.py: encode_blocks_pallas, both its
// bodies: _encode_kernel (a static Annex-K table class) and
// _encode_kernel_rt (runtime [192] tables, the 2-pass optimal codes).
// This kernel reads its [192] table from memory either way, so one body
// serves both.
//
// Optimal tables carry codes of up to 16 bits (T.81 C), all of which fit:
// one put is at most a DC code and its amplitude, 16 + 11 = 27 bits, or
// an AC code and its amplitude, 16 + 10 = 26 (ZRL and EOB 16), so a put
// touches at most two 32-bit words. A table entry is code << 6 | len <
// 2^22. The worst block is 63 nonzero AC of 26 bits plus a 27-bit DC, 1665
// bits (ZRLs and EOB replace costlier symbols: entropy/pack.py), within
// MAX_BITS_PER_BLOCK = 1695, so the top rung's 53 words hold every block.
//
// Per block: the DC difference's size category and amplitude, then each
// nonzero AC coefficient's ZRLs (one for every 16 zeros before it) and
// (run, size) Huffman code followed by its amplitude bits, and EOB when
// coefficient 63 is zero (the same bits as the TPU kernel's tile-wide
// (run > 0) | (kk < 64) rule). A DC size past the table selects DC entry
// 0, and an AC size past 10 the entry of size 0, as the TPU kernel's
// select cascades do. Bits go MSB-first into a 64-bit accumulator that
// retires 32-bit words. At most `cap` words are stored,
// words past the block's bits are stored as zero, and the bit count is
// always the full one, so bits > cap * 32 flags overflow exactly as the
// TPU kernel does.
//
// Bound: bytes, 256 bytes of levels in per block and cap + 1 words out
// (0.0168 ms for a 12 MPix gray image). A thread that walks its block's 63
// coefficients straight from memory waits on each load in turn: that walk
// is bound by latency. Here:
// - A warp owns a tile of 32 consecutive blocks, a thread each; a thread
//   block holds 4 warps' tiles. Each thread stages its block's 64 levels
//   in a shared row of 65 words (odd: a warp's 32 rows fall in distinct
//   banks) with 64 asynchronous copies in flight at once, each warp copy
//   one 128-byte line of one coefficient, and notes the block's AC
//   nonzeros in two 32-bit masks.
// - The walk reads shared memory only and takes one step per nonzero
//   (__ffs over each mask): its run is the distance to the previous one.
//   At Q50 that is a handful of steps a block, not 63.
// - Words retire into the block's own row, over levels the walk has
//   passed: a put is at most 32 bits and ZRLs cost at most a bit a zero,
//   so the bits through coefficient k number at most 32 (k + 1), and word
//   w retires no earlier than the put of coefficient w, after its level
//   was read. So shared memory is 34 KB a thread block whatever the cap
//   (up to 53, the words of the longest block). Once cap words have
//   retired, puts only count their bits.
// - The warp stores whole [cap, nb] rows of 32 blocks, zeros past each
//   block's words, so no separate zero loop runs.
// A warp per block (tools/k4_warp_per_block.cu: lane l holding
// coefficients l and l + 32, ballots for the nonzero mask, a warp scan
// for the offsets) works on all 64 coefficients of every block however
// sparse it is; PERF.md gives its times beside this kernel's. The table
// sits in shared memory (Hopper has a real gather: no select cascades)
// and the size category is 32 - clz.

// K7 (pack_blocks) replaces jpegtpu/entropy/pallas_pack.py:
// pack_blocks_pallas (_pack_kernel), the packer of jpegtpu's staged entropy
// path (entropy/device.py encode_scan_device with fused=False): symbolize
// into 5 sub-slots per element, fuse them into elements of 3 words
// (<= 96 bits), then pack each block's E = 64 elements. It is K4's
// accumulator loop with the Huffman lookup already done: each thread walks
// its block's elements in order, funnel-shifts each into a 4-word (128-bit)
// accumulator at the residue (< 32 bits) left by the last, and retires up
// to 3 full words per element into word j * nb + b ([cap, nb], so a warp's
// stores of word j are one coalesced line). Words past cap are counted but
// never stored, words past the block's bits are stored as zero, and the
// bit count is the full one, so bits > cap * 32 flags overflow as on the
// TPU. The TPU kernel keeps its frame in vregs and selects the word slot
// by compare (no dynamic register index); here the store goes straight to
// its slot.
//
// Bound: bytes. 4 x 4 bytes of elements in per element slot, cap + 1
// words out per block; no lookup, ~10 integer operations per element.
// Reads are [3, E, nb] with nb minor, so a warp's loads of one element
// word are one 128-byte line.

#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

// Packed table layout (jpegtpu_torch/tables.py): entry = code << 6 | len.
constexpr int kHuffAc = 0, kHuffDc = 176, kHuffZrl = 188, kHuffEob = 190;
constexpr int kHuffSize = 192;
constexpr int kThreads = 128;  // K7

constexpr int kTileBlocks = 32;  // K4: a warp, a thread per 8x8 block
constexpr int kEncWarps = 4;     // warps (tiles) a thread block
constexpr int kLevPitch = 65;    // staged levels [block][65]
constexpr int kMaxWords = 53;    // MAX_WORDS_PER_BLOCK: the largest cap
// the table and the staged levels, 34 KB (dynamic shared memory: as
// static arrays the kernel took 79 registers, not 48, and ran slower)
constexpr size_t kEncodeSmem =
    (kHuffSize + kEncWarps * kTileBlocks * kLevPitch) * sizeof(int);

// Bits go MSB-first into a 64-bit accumulator that retires 32-bit words
// into row[0, cap); past them puts only count their bits.
struct BitWriter {
  unsigned long long acc = 0;  // MSB-aligned pending bits
  int nacc = 0;                // pending bit count, < 32 between puts
  int widx = 0;                // words retired, at most cap
  int over = 0;                // bits put once cap words had retired
  unsigned* row;
  int cap;

  // Append the low `len` (<= 32) bits of `val`, which holds no others.
  __device__ void put(unsigned val, int len) {
    if (widx >= cap) {
      over += len;
      return;
    }
    if (len <= 0) return;
    acc |= (unsigned long long)val << (64 - nacc - len);
    nacc += len;
    if (nacc >= 32) {
      row[widx++] = (unsigned)(acc >> 32);
      acc <<= 32;
      nacc -= 32;
    }
  }
};

// JPEG size category (bit length of |v|) and amplitude bits (v, or v - 1
// for negative v, masked to size bits).
__device__ __forceinline__ int size_of(int v) { return 32 - __clz(abs(v)); }

__device__ __forceinline__ unsigned amplitude(int v, int size) {
  const unsigned mask = size >= 32 ? 0xFFFFFFFFu : (1u << size) - 1u;
  return (unsigned)(v > 0 ? v : v - 1) & mask;
}

__global__ void __launch_bounds__(kEncWarps * kTileBlocks)
encode_blocks_kernel(const int* __restrict__ levels,
                     const int* __restrict__ dc_diff,
                     const int* __restrict__ huff, int nb, int cap,
                     unsigned* __restrict__ words, int* __restrict__ bits) {
  extern __shared__ int smem[];  // kEncodeSmem bytes
  int* s_h = smem;                // [192] table
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* s_lev = s_h + kHuffSize + warp * kTileBlocks * kLevPitch;
  const int b = (blockIdx.x * kEncWarps + warp) * kTileBlocks + lane;
  const bool live = b < nb;

  // stage the block's levels: 64 asynchronous copies in flight a thread,
  // each warp copy one 128-byte line of one coefficient
  int* lv = s_lev + lane * kLevPitch;
#pragma unroll
  for (int k = 0; k < 64; ++k) {
    cp_async_4(lv + k, levels + (live ? (size_t)k * nb + b : 0),
               live ? 4 : 0);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < kHuffSize; i += kEncWarps * kTileBlocks) {
    s_h[i] = huff[i];
  }
  const int d = live ? dc_diff[b] : 0;
  cp_async_wait<0>();
  __syncthreads();
  unsigned lo = 0, hi = 0;  // the block's nonzeros, k < 32 and k >= 32
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    lo |= (unsigned)(lv[k] != 0) << k;
    hi |= (unsigned)(lv[k + 32] != 0) << k;
  }
  const unsigned zrl_code = (unsigned)s_h[kHuffZrl];
  const int zrl_len = s_h[kHuffZrl + 1];

  BitWriter w;
  w.row = reinterpret_cast<unsigned*>(lv);
  w.cap = cap;
  // DC: code and amplitude as one put (<= 16 + 11 bits). A size past the
  // table selects entry 0, as the TPU kernel's select cascade does.
  const int dsize = size_of(d);
  const int dpk = s_h[kHuffDc + (dsize <= 11 ? dsize : 0)];
  w.put(((unsigned)(dpk >> 6) << dsize) | amplitude(d, dsize),
        (dpk & 63) + dsize);
  // AC: one step per nonzero, ZRLs for the zeros before it
  int prev = 0;
  const auto step = [&](int k) {
    int run = k - prev - 1;
    prev = k;
    for (; run >= 16; run -= 16) w.put(zrl_code, zrl_len);
    const int v = lv[k];
    const int size = size_of(v);
    const int pk = s_h[kHuffAc + run * 11 + (size <= 10 ? size : 0)];
    w.put(((unsigned)(pk >> 6) << size) | amplitude(v, size),
          (pk & 63) + size);
  };
  for (unsigned m = lo & ~1u; m; m &= m - 1) step(__ffs(m) - 1);
  for (unsigned m = hi; m; m &= m - 1) step(__ffs(m) + 31);
  if (prev != 63) w.put((unsigned)s_h[kHuffEob], s_h[kHuffEob + 1]);
  if (w.nacc > 0 && w.widx < cap) {  // the partial word, zeros below it
    w.row[w.widx] = (unsigned)(w.acc >> 32);
  }
  if (!live) return;
  // whole rows, zeros past each block's words: one line a row
  const int produced = w.widx + (w.nacc > 0);
  for (int r = 0; r < cap; ++r) {
    words[(size_t)r * nb + b] = r < produced ? w.row[r] : 0u;
  }
  bits[b] = w.widx * 32 + w.nacc + w.over;
}

__global__ void __launch_bounds__(kThreads)
pack_blocks_kernel(const unsigned* __restrict__ elems,
                   const int* __restrict__ elem_bits, int n_elem, int nb,
                   int cap, unsigned* __restrict__ words,
                   int* __restrict__ bits) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= nb) return;
  const size_t plane = (size_t)n_elem * nb;  // one element word's plane
  unsigned a0 = 0u, a1 = 0u, a2 = 0u, a3 = 0u;  // MSB-aligned pending bits
  int cnt = 0;   // pending bit count, < 32 between elements
  int widx = 0;  // words retired (counted past cap too)
  for (int e = 0; e < n_elem; ++e) {
    const size_t i = (size_t)e * nb + b;
    const int len = elem_bits[i];
    if (len <= 0) continue;
    // an element's words are zero past its bits: read only those it uses
    const unsigned w0 = elems[i];
    const unsigned w1 = len > 32 ? elems[plane + i] : 0u;
    const unsigned w2 = len > 64 ? elems[2 * plane + i] : 0u;
    if (cnt) {
      const int t = 32 - cnt;
      a0 |= w0 >> cnt;
      a1 |= (w1 >> cnt) | (w0 << t);
      a2 |= (w2 >> cnt) | (w1 << t);
      a3 |= w2 << t;
    } else {
      a0 |= w0;
      a1 |= w1;
      a2 |= w2;
    }
    cnt += len;
    while (cnt >= 32) {  // at most 3 words: cnt < 32 + 96
      if (widx < cap) words[(size_t)widx * nb + b] = a0;
      ++widx;
      a0 = a1;
      a1 = a2;
      a2 = a3;
      a3 = 0u;
      cnt -= 32;
    }
  }
  int next = widx;
  if (cnt > 0) {  // flush the partial word (zeros below the residue)
    if (next < cap) words[(size_t)next * nb + b] = a0;
    ++next;
  }
  for (int j = next; j < cap; ++j) words[(size_t)j * nb + b] = 0u;
  bits[b] = widx * 32 + cnt;
}

}  // namespace

extern "C" int jt_pack_blocks(const unsigned* elems, const int* elem_bits,
                              int n_elem, int nb, int cap, unsigned* words,
                              int* bits, cudaStream_t stream) {
  if (nb > 0) {
    pack_blocks_kernel<<<(nb + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(elems, elem_bits, n_elem, nb, cap, words,
                                   bits);
  }
  return (int)cudaGetLastError();
}

extern "C" int jt_encode_blocks(const int* levels, const int* dc_diff,
                                const int* huff, int nb, int cap,
                                unsigned* words, int* bits,
                                cudaStream_t stream) {
  if (cap < 0 || cap > kMaxWords) return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    constexpr int kBlocks = kEncWarps * kTileBlocks;
    encode_blocks_kernel<<<(nb + kBlocks - 1) / kBlocks, kBlocks,
                           kEncodeSmem, stream>>>(levels, dc_diff, huff, nb,
                                                  cap, words, bits);
  }
  return (int)cudaGetLastError();
}

// Thread blocks of encode_blocks_kernel one SM holds (the runtime's
// occupancy calculator), or -1 on an error; launches nothing.
extern "C" int jt_encode_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, encode_blocks_kernel, kEncWarps * kTileBlocks,
          kEncodeSmem) != cudaSuccess) {
    return -1;
  }
  return n;
}
