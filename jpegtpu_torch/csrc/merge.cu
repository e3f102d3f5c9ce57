// K5: the color scan's MCU interleave, one thread per MCU.
//
// Replaces jpegtpu/entropy/pallas_pack.py: merge_mcu_natural_pallas
// (_merge_mcu_kernel, _realign_mats).
//
// For MCU m at (my, mx) of an nmch x nmcw MCU grid, the kernel
// concatenates MSB-first, at running bit offsets, the per-block streams
// (K4's output) of
//   - the fy x fx luma blocks at raster (fy * my + dy) * nbw_y + fx * mx + dx,
//     in (dy, dx) order (nbw_y = fx * nmcw);
//   - then Cb block m, then Cr block m;
// into E * cap words (E = fy * fx + 2) of a [E * cap, nmcu] frame, words
// past the MCU's bits zero, and its bit count. A block's bits are clamped
// to cap * 32: a block past that overflowed (the encode retries at the
// next rung) and the clamp keeps every write inside the frame meanwhile.
// The frame is in MCU raster order, ready for K8 with nbh = nmch,
// nbw = nmcw and E * cap words per "block".
//
// Bound: bytes. The valid words of every block stream are read once and
// the E * cap * nmcu frame is written once (9.1 MB at 3024 x 4032 4:2:0,
// cap 8). Each thread moves whole words through a 64-bit funnel-shift
// accumulator (K4's BitWriter), so the work per word is a few integer
// operations; the frame's stores are word-major ([E * cap, nmcu]), so
// threads of neighbouring MCUs at the same output word store to
// neighbouring addresses. The TPU kernel's lane-realign matmuls on bf16
// byte planes exist only because a TPU vector cannot gather lanes; here a
// thread reads its blocks' words by address.

// K6: the same interleave from slot-major streams, one thread per MCU.
//
// Replaces jpegtpu/entropy/pallas_pack.py: merge_streams_pallas
// (_merge_kernel), the MCU merge of jpegtpu's non-raw color batch route
// (color_pipeline._mcu_streams_fused).
//
// Input: words [E, cap, M] (plane s holds every MCU's s-th block stream,
// word j of MCU m at (s * cap + j) * M + m) and bits [E, M]. For MCU m the
// kernel concatenates streams s = 0 .. E - 1 MSB-first at running bit
// offsets into E * cap words of a [E * cap, M] frame, words past the
// MCU's bits zero, and writes its bit count; bits are clamped to cap * 32
// as in K5. The TPU kernel folds each shifted word into its frame by a
// one-hot select cascade over every frame position it could reach
// (~1.1k selects per lane at 4:2:0, cap 8), because a vector register
// has no dynamic index, and tiles M as [G, 8, 128]; here a thread
// retires each word straight to its slot through K5's funnel-shift
// accumulator.
//
// Bound: bytes. Each MCU's valid words and its E bit counts are read once
// and the E * cap * M frame is written once (146 MB at 16 x 3024 x 4032
// 4:2:0, cap 8). Threads of neighbouring MCUs read plane (s, j) and store
// frame word j at neighbouring addresses, so both are coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct WordWriter {
  unsigned long long acc = 0;  // MSB-aligned pending bits
  int nacc = 0;                // pending bit count, < 32 between puts
  int widx = 0;                // words retired
  unsigned* words;
  size_t stride;

  // Append the low `len` (1..32) bits of `val`, which holds no others.
  __device__ void put(unsigned val, int len) {
    acc |= (unsigned long long)val << (64 - nacc - len);
    nacc += len;
    if (nacc >= 32) {
      words[(size_t)widx * stride] = (unsigned)(acc >> 32);
      ++widx;
      acc <<= 32;
      nacc -= 32;
    }
  }

  // Append the first `bits` bits (clamped to cap * 32) of the MSB-first
  // stream whose word j is src[j * src_stride]; returns the bits taken.
  __device__ int put_stream(const unsigned* src, size_t src_stride, int bits,
                            int cap) {
    const int n = min(bits, cap * 32);
    for (int j = 0, b = n; b > 0; ++j, b -= 32) {
      const int len = min(b, 32);
      put(src[(size_t)j * src_stride] >> (32 - len), len);
    }
    return n;
  }

  // Flush the partial word (zeros below the residue) and zero the frame's
  // words up to n_words.
  __device__ void close(int n_words) {
    int next = widx;
    if (nacc > 0) words[(size_t)next++ * stride] = (unsigned)(acc >> 32);
    for (; next < n_words; ++next) words[(size_t)next * stride] = 0u;
  }
};

__global__ void __launch_bounds__(kThreads)
merge_mcu_kernel(const unsigned* __restrict__ wy, const int* __restrict__ by,
                 const unsigned* __restrict__ wc, const int* __restrict__ bc,
                 int cap, int nmch, int nmcw, int fy, int fx,
                 unsigned* __restrict__ out, int* __restrict__ out_bits) {
  const int nmcu = nmch * nmcw;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= nmcu) return;
  const int my = m / nmcw, mx = m % nmcw;
  const int ky = fy * fx;
  const size_t ny = (size_t)ky * nmcu;  // luma blocks
  const int nbw_y = fx * nmcw;

  WordWriter w;
  w.words = out + m;
  w.stride = (size_t)nmcu;
  int total = 0;
  for (int s = 0; s < ky + 2; ++s) {
    if (s < ky) {
      const size_t blk =
          (size_t)(fy * my + s / fx) * nbw_y + fx * mx + s % fx;
      total += w.put_stream(wy + blk, ny, by[blk], cap);
    } else {
      const size_t blk = (size_t)(s - ky) * nmcu + m;
      total += w.put_stream(wc + blk, 2 * (size_t)nmcu, bc[blk], cap);
    }
  }
  w.close((ky + 2) * cap);
  out_bits[m] = total;
}

__global__ void __launch_bounds__(kThreads)
merge_streams_kernel(const unsigned* __restrict__ words,
                     const int* __restrict__ bits, int e, int cap, int m_all,
                     unsigned* __restrict__ out, int* __restrict__ out_bits) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= m_all) return;
  const size_t M = (size_t)m_all;
  WordWriter w;
  w.words = out + m;
  w.stride = M;
  int total = 0;
  for (int s = 0; s < e; ++s)
    total += w.put_stream(words + (size_t)s * cap * M + m, M,
                          bits[(size_t)s * M + m], cap);
  w.close(e * cap);
  out_bits[m] = total;
}

}  // namespace

extern "C" int jt_merge_mcu(const unsigned* wy, const int* by,
                            const unsigned* wc, const int* bc, int cap,
                            int nmch, int nmcw, int fy, int fx, unsigned* out,
                            int* out_bits, cudaStream_t stream) {
  const int nmcu = nmch * nmcw;
  if (nmcu > 0) {
    merge_mcu_kernel<<<(nmcu + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(wy, by, wc, bc, cap, nmch, nmcw, fy, fx, out,
                                 out_bits);
  }
  return (int)cudaGetLastError();
}

extern "C" int jt_merge_streams(const unsigned* words, const int* bits, int e,
                                int cap, int m, unsigned* out, int* out_bits,
                                cudaStream_t stream) {
  if (m > 0) {
    merge_streams_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(words, bits, e, cap, m, out, out_bits);
  }
  return (int)cudaGetLastError();
}
