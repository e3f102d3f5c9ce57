// K5 (merge_mcu) with the first 8 words of each block staged in shared
// memory and the frame's zeros stored while those copies are in flight:
// the design that jpegtpu_torch/csrc/merge.cu weighed against its own,
// which stages up to 16 words a block and stores the zeros after its
// walk. Not part of the package: tools/torch_kernel_ab.py builds it,
// holds its frame and bit counts equal to merge.cu's and times the two
// (and another checkout's K5) in turns. Same arguments and semantics as
// jt_merge_mcu.
//
// - A thread an MCU, 128 MCUs a thread block. Each thread loads its E bit
//   counts (E independent loads), then issues one asynchronous copy
//   (cp.async) for each of the first 8 words of its blocks that hold
//   bits, all at once, into its own column of shared memory ([E * 8][128]
//   words: 24 KB at 4:2:0, at every cap).
// - While they are in flight it stores the frame's zeros past the MCU's
//   bits; then it walks its E streams from shared memory through a
//   64-bit funnel-shift accumulator (words past the 8th of a block read
//   in the walk) and stores each frame word as it completes.
//
// Also here: the frame's store pattern alone, zeros written word-major by
// a thread an MCU (scalar stores) or a thread four MCUs (16-byte stores),
// the floors of any K5 that writes the [E * cap, nmcu] frame.

#include <cstdint>
#include <cuda_runtime.h>

#include "../jpegtpu_torch/csrc/cp_async.cuh"

namespace {

constexpr int kThreads = 128;

constexpr int kStaged = 8;

template <int FY, int FX>
__global__ void __launch_bounds__(kThreads)
merge_mcu_staged_kernel(const unsigned* __restrict__ wy,
                        const int* __restrict__ by,
                        const unsigned* __restrict__ wc,
                        const int* __restrict__ bc, int cap, int nmch,
                        int nmcw, unsigned* __restrict__ out,
                        int* __restrict__ out_bits) {
  constexpr int KY = FY * FX, E = KY + 2;
  __shared__ unsigned stage[E * kStaged][kThreads];
  const int nmcu = nmch * nmcw;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= nmcu) return;  // each thread reads only its own column
  const int my = m / nmcw, mx = m - my * nmcw;
  const int nbw_y = FX * nmcw;
  const size_t ny = (size_t)KY * nmcu, nc = 2 * (size_t)nmcu;
  int blk[E], n[E];
#pragma unroll
  for (int s = 0; s < E; ++s) {
    blk[s] = s < KY ? (FY * my + s / FX) * nbw_y + FX * mx + s % FX
                    : (s - KY) * nmcu + m;
  }
#pragma unroll
  for (int s = 0; s < E; ++s) {
    n[s] = min(__ldg(s < KY ? by + blk[s] : bc + blk[s]), cap * 32);
  }
  const int staged = min(cap, kStaged);
  int total = 0;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const unsigned* src = s < KY ? wy + blk[s] : wc + blk[s];
    const size_t stride = s < KY ? ny : nc;
    for (int k = 0; k < staged && 32 * k < n[s]; ++k) {
      cp_async_4(&stage[s * kStaged + k][threadIdx.x],
                 src + (size_t)k * stride, 4);
    }
    total += n[s];
  }
  cp_async_commit();
  // the zeros past the MCU's bits go out while its words are in flight
  for (int j = (total + 31) >> 5; j < E * cap; ++j) {
    out[(size_t)j * nmcu + m] = 0u;
  }
  cp_async_wait<0>();
  unsigned long long acc = 0;  // MSB-aligned pending bits
  int nacc = 0, widx = 0;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const unsigned* src = s < KY ? wy + blk[s] : wc + blk[s];
    const size_t stride = s < KY ? ny : nc;
    for (int k = 0, b = n[s]; b > 0; ++k, b -= 32) {
      const int len = min(b, 32);
      const unsigned x = k < kStaged ? stage[s * kStaged + k][threadIdx.x]
                                     : __ldg(src + (size_t)k * stride);
      acc |= (unsigned long long)(x >> (32 - len)) << (64 - nacc - len);
      nacc += len;
      if (nacc >= 32) {
        out[(size_t)widx++ * nmcu + m] = (unsigned)(acc >> 32);
        acc <<= 32;
        nacc -= 32;
      }
    }
  }
  if (nacc > 0) out[(size_t)widx * nmcu + m] = (unsigned)(acc >> 32);
  out_bits[m] = total;
}

__global__ void __launch_bounds__(kThreads)
frame_zero_kernel(unsigned* __restrict__ out, int words, int nmcu) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= nmcu) return;
  for (int j = 0; j < words; ++j) out[(size_t)j * nmcu + m] = 0u;
}

__global__ void __launch_bounds__(kThreads)
frame_zero4_kernel(unsigned* __restrict__ out, int words, int nmcu) {
  const int m = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (m >= nmcu) return;
  for (int j = 0; j < words; ++j) {
    *reinterpret_cast<uint4*>(out + (size_t)j * nmcu + m) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int FY, int FX>
int launch_staged(const unsigned* wy, const int* by, const unsigned* wc,
                  const int* bc, int cap, int nmch, int nmcw, unsigned* out,
                  int* out_bits, cudaStream_t stream) {
  const int nmcu = nmch * nmcw;
  merge_mcu_staged_kernel<FY, FX>
      <<<(nmcu + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          wy, by, wc, bc, cap, nmch, nmcw, out, out_bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jt_merge_mcu_staged(const unsigned* wy, const int* by,
                                   const unsigned* wc, const int* bc, int cap,
                                   int nmch, int nmcw, int fy, int fx,
                                   unsigned* out, int* out_bits,
                                   cudaStream_t stream) {
  if (nmch * nmcw <= 0) return (int)cudaGetLastError();
  if (fy == 2 && fx == 2) {
    return launch_staged<2, 2>(wy, by, wc, bc, cap, nmch, nmcw, out,
                               out_bits, stream);
  }
  if (fy == 1 && fx == 2) {
    return launch_staged<1, 2>(wy, by, wc, bc, cap, nmch, nmcw, out,
                               out_bits, stream);
  }
  if (fy == 1 && fx == 1) {
    return launch_staged<1, 1>(wy, by, wc, bc, cap, nmch, nmcw, out,
                               out_bits, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Thread blocks of this K5 one SM holds at 4:2:0 (at every cap).
extern "C" int jt_merge_mcu_staged_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, merge_mcu_staged_kernel<2, 2>, kThreads, 0) != cudaSuccess) {
    return -1;
  }
  return n;
}

// Zeros into a [words, nmcu] frame, word-major: vec4 0 by a thread an MCU,
// 1 by a thread four MCUs (nmcu a multiple of 4).
extern "C" int jt_frame_zero(unsigned* out, int words, int nmcu, int vec4,
                             cudaStream_t stream) {
  if (vec4) {
    if (nmcu % 4) return (int)cudaErrorInvalidValue;
    const int threads = nmcu / 4;
    frame_zero4_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(out, words, nmcu);
  } else {
    frame_zero_kernel<<<(nmcu + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(out, words, nmcu);
  }
  return (int)cudaGetLastError();
}
