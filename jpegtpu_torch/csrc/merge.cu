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
    size_t blk, stride;
    const unsigned* src;
    int b;
    if (s < ky) {
      blk = (size_t)(fy * my + s / fx) * nbw_y + fx * mx + s % fx;
      src = wy;
      stride = ny;
      b = by[blk];
    } else {
      blk = (size_t)(s - ky) * nmcu + m;
      src = wc;
      stride = 2 * (size_t)nmcu;
      b = bc[blk];
    }
    b = min(b, cap * 32);
    total += b;
    for (int j = 0; b > 0; ++j, b -= 32) {
      const int len = min(b, 32);
      w.put(src[(size_t)j * stride + blk] >> (32 - len), len);
    }
  }
  int next = w.widx;
  if (w.nacc > 0) {  // flush the partial word (zeros below the residue)
    out[(size_t)next * nmcu + m] = (unsigned)(w.acc >> 32);
    ++next;
  }
  const int cap_out = (ky + 2) * cap;
  for (int j = next; j < cap_out; ++j) out[(size_t)j * nmcu + m] = 0u;
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
