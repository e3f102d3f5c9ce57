// K4: fused symbolize + Huffman pack, one thread per 8x8 block.
//
// Replaces jpegtpu/entropy/pallas_pack.py: encode_blocks_pallas
// (_encode_kernel with a static table class; the runtime-table
// _encode_kernel_rt reads the same [192] table layout).
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

}  // namespace

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
