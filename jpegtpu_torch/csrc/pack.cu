// K4: fused symbolize + Huffman pack, one thread per 8x8 block; and K7:
// the pack of pre-fused elements, one thread per block.
//
// Replaces jpegtpu/entropy/pallas_pack.py: encode_blocks_pallas, both its
// bodies: _encode_kernel (a static Annex-K table class) and
// _encode_kernel_rt (runtime [192] tables, the 2-pass optimal codes).
// This kernel reads its [192] table from memory either way, so one body
// serves both.
//
// Optimal tables carry codes of up to 16 bits (T.81 C), all of which fit:
// one put is at most a DC code and its amplitude, 16 + 11 = 27 bits, or
// an AC code and its amplitude, 16 + 10 = 26 (ZRL and EOB 16), and a put
// shifts by 64 - nacc - len >= 64 - 31 - 27 = 6 into the 64-bit
// accumulator. A table entry is code << 6 | len < 2^22. The worst block
// is 63 nonzero AC of 26 bits plus a 27-bit DC, 1665 bits (ZRLs and EOB
// replace costlier symbols: entropy/device.py), within
// MAX_BITS_PER_BLOCK = 1695, so the top rung's 53 words hold every block.
//
// Per block: the DC difference's size category and amplitude, then the AC
// run-length walk (ZRL for every 16 zeros before a nonzero), each
// (run, size) Huffman code followed by its amplitude bits, and EOB when
// coefficient 63 is zero (the same bits as the TPU kernel's tile-wide
// (run > 0) | (kk < 64) rule). Bits go MSB-first into a 64-bit
// accumulator that retires 32-bit words. At most `cap` words are stored,
// words past the block's bits are stored as zero, and the bit count is
// always the full one, so bits > cap * 32 flags overflow exactly as the
// TPU kernel does.
//
// Bound: a serial dependency chain per block, not bytes. 256 bytes of
// levels in per block and ~36 bytes out (Q50) would take the card ~17 us
// for a 12 MPix image, but each thread walks its 63 coefficients and its
// accumulator in order. The design keeps the walk cheap: the table sits
// in shared memory (no select cascades: Hopper has a real gather), size
// category is 32 - clz, levels are read coefficient-major so a warp's 32
// loads of one coefficient are one 128-byte line, and words are stored
// word-major ([cap, nb]) for the same reason. Latency hiding comes from
// the ~190k independent threads of a 12 MPix image, nothing more yet.

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

namespace {

// Packed table layout (jpegtpu_torch/tables.py): entry = code << 6 | len.
constexpr int kHuffAc = 0, kHuffDc = 176, kHuffZrl = 188, kHuffEob = 190;
constexpr int kHuffSize = 192;
constexpr int kThreads = 128;

struct BitWriter {
  unsigned long long acc = 0;  // MSB-aligned pending bits
  int nacc = 0;                // pending bit count, < 32 between puts
  int widx = 0;                // words retired (counted past cap too)
  unsigned* words;
  size_t stride;  // nb: words are [cap, nb]
  int cap;

  // Append the low `len` (<= 32) bits of `val`, which holds no others.
  __device__ void put(unsigned val, int len) {
    if (len <= 0) return;
    acc |= (unsigned long long)val << (64 - nacc - len);
    nacc += len;
    if (nacc >= 32) {
      if (widx < cap) words[(size_t)widx * stride] = (unsigned)(acc >> 32);
      ++widx;
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

__global__ void __launch_bounds__(kThreads)
encode_blocks_kernel(const int* __restrict__ levels,
                     const int* __restrict__ dc_diff,
                     const int* __restrict__ huff, int nb, int cap,
                     unsigned* __restrict__ words, int* __restrict__ bits) {
  __shared__ int s_h[kHuffSize];
  for (int i = threadIdx.x; i < kHuffSize; i += kThreads) s_h[i] = huff[i];
  __syncthreads();
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= nb) return;

  BitWriter w;
  w.words = words + b;
  w.stride = (size_t)nb;
  w.cap = cap;

  // DC: code and amplitude as one put (<= 16 + 11 bits). A size past the
  // table selects entry 0, as the TPU kernel's select cascade does.
  const int d = dc_diff[b];
  const int dsize = size_of(d);
  const int dpk = s_h[kHuffDc + (dsize <= 11 ? dsize : 0)];
  w.put(((unsigned)(dpk >> 6) << dsize) | amplitude(d, dsize),
        (dpk & 63) + dsize);

  const unsigned zrl_code = (unsigned)s_h[kHuffZrl];
  const int zrl_len = s_h[kHuffZrl + 1];
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = levels[(size_t)k * nb + b];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run >= 16; run -= 16) w.put(zrl_code, zrl_len);
    const int size = size_of(v);
    const int pk = s_h[kHuffAc + run * 11 + (size <= 10 ? size : 0)];
    w.put(((unsigned)(pk >> 6) << size) | amplitude(v, size), (pk & 63) + size);
    run = 0;
  }
  if (run > 0) w.put((unsigned)s_h[kHuffEob], s_h[kHuffEob + 1]);

  int next = w.widx;
  if (w.nacc > 0) {  // flush the partial word (zeros below the residue)
    if (next < cap) words[(size_t)next * nb + b] = (unsigned)(w.acc >> 32);
    ++next;
  }
  for (int j = next; j < cap; ++j) words[(size_t)j * nb + b] = 0u;
  bits[b] = w.widx * 32 + w.nacc;
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
  if (nb > 0) {
    encode_blocks_kernel<<<(nb + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(levels, dc_diff, huff, nb, cap, words,
                                     bits);
  }
  return (int)cudaGetLastError();
}
