// K5: the color scan's MCU interleave, one thread an MCU, its block words
// staged in shared memory by asynchronous copies.
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
// Bound: bytes. The valid words of every block stream and the E bit counts
// of every MCU are read once, and the E * cap * nmcu frame is written once
// (9.1 MB at 3024 x 4032 4:2:0, cap 8; 201 MB at the 1024 x 512 x 512
// batch), most of it zeros: a Q50 MCU holds ~7 of its 48 words. The frame
// alone, stored by this kernel's pattern with no loads, takes 0.0083 ms
// at 3024 x 4032 and 0.0705 ms at the batch on an H100 (PERF.md), so
// those stores, and not the bit arithmetic, set K5's pace.
// The design before this one walked an MCU's E streams in one thread,
// each load waiting on the one before it: ~14 dependent round trips a
// thread, 11 warps an SM at 12 MPix. Here each thread still builds its
// MCU's words through a 64-bit funnel-shift accumulator (WordWriter), one
// thread an MCU and 128 MCUs a thread block, so every frame store of a
// warp is one 128-byte line and neighbouring threads read neighbouring
// MCUs' words; but its loads no longer wait on each other:
//   1. the E bit counts, E independent loads, clamped to cap * 32;
//   2. one asynchronous copy (cp.async) into shared memory for each of
//      the first min(cap, kStaged) words of each block that hold bits,
//      all issued together, into the thread's own column ([E * 8][128]
//      words at cap 8, 24 KB at 4:2:0: 9 thread blocks an SM; 48 KB and
//      4 from cap 16 on);
//   3. the walk over its E streams from shared memory (a block's words
//      past kStaged, past cap 16 only, are copied 16 at a time into its
//      rows as the walk reaches them), each frame word stored as it
//      completes, then the zeros past the MCU's bits.
// tools/k5_word_parallel.cu builds every output word in its own thread
// instead, and tools/k5_staged.cu stores the zeros while the copies are
// in flight: both were slower (PERF.md). The TPU kernel's lane-realign
// matmuls on bf16 byte planes exist only because a TPU vector cannot
// gather lanes; here a thread reads its blocks' words by address.

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
// retires each word straight to its slot through a funnel-shift
// accumulator (WordWriter), one thread an MCU.
//
// Bound: bytes. Each MCU's valid words and its E bit counts are read once
// and the E * cap * M frame is written once (146 MB at 16 x 3024 x 4032
// 4:2:0, cap 8). Threads of neighbouring MCUs read plane (s, j) and store
// frame word j at neighbouring addresses, so both are coalesced.

#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 128;
// K5: the words of a block it stages in shared memory, at most (its stage
// at 4:2:0, 6 * 16 words of 128 threads, is 48 KB: no opt-in)
constexpr int kStaged = 16;

__host__ __device__ constexpr size_t stage_bytes(int e, int cap) {
  return (size_t)e * (cap < kStaged ? cap : kStaged) * kThreads *
         sizeof(unsigned);
}

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

  // Store the partial word (zeros below the residue), if any.
  __device__ void flush() {
    if (nacc > 0) words[(size_t)widx++ * stride] = (unsigned)(acc >> 32);
    nacc = 0;
  }

  // Flush the partial word and zero the frame's words up to n_words.
  __device__ void close(int n_words) {
    flush();
    for (int next = widx; next < n_words; ++next) {
      words[(size_t)next * stride] = 0u;
    }
  }
};

// One thread an MCU, kThreads MCUs a thread block. The first `staged`
// words of each block that hold bits (staged = min(cap, kStaged)) are
// copied asynchronously into the thread's own column of stage ([E *
// staged][kThreads] words; no barrier: no thread reads another's column).
// kDirect (cap > kStaged): a block's later words, on pathological content
// only, are copied kStaged at a time into its rows as the walk reaches
// them.
template <int FY, int FX, bool kDirect>
__global__ void __launch_bounds__(kThreads)
merge_mcu_kernel(const unsigned* __restrict__ wy, const int* __restrict__ by,
                 const unsigned* __restrict__ wc, const int* __restrict__ bc,
                 int cap, int nmch, int nmcw, unsigned* __restrict__ out,
                 int* __restrict__ out_bits) {
  constexpr int KY = FY * FX, E = KY + 2;
  extern __shared__ unsigned stage[];
  const int nmcu = nmch * nmcw;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= nmcu) return;
  const int my = m / nmcw, mx = m - my * nmcw;
  const int nbw_y = FX * nmcw;
  const size_t ny = (size_t)KY * nmcu, nc = 2 * (size_t)nmcu;
  const int staged = min(cap, kStaged);
  unsigned* col = stage + threadIdx.x;
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
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const unsigned* src = s < KY ? wy + blk[s] : wc + blk[s];
    const size_t stride = s < KY ? ny : nc;
    for (int k = 0; k < staged && 32 * k < n[s]; ++k) {
      cp_async_4(col + (s * staged + k) * kThreads, src + (size_t)k * stride,
                 4);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  WordWriter w;
  w.words = out + m;
  w.stride = (size_t)nmcu;
  int total = 0;
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const unsigned* src = s < KY ? wy + blk[s] : wc + blk[s];
    const size_t stride = s < KY ? ny : nc;
    for (int k = 0, b = n[s]; b > 0; ++k, b -= 32) {
      if (kDirect && k >= kStaged && k % kStaged == 0) {
        // the block's next kStaged words, into the rows it has walked
        for (int i = 0; i < kStaged && 32 * (k + i) < n[s]; ++i) {
          cp_async_4(col + (s * kStaged + i) * kThreads,
                     src + (size_t)(k + i) * stride, 4);
        }
        cp_async_commit();
        cp_async_wait<0>();
      }
      const int len = min(b, 32);
      const int row = kDirect ? k % kStaged : k;
      w.put(col[(s * staged + row) * kThreads] >> (32 - len), len);
    }
    total += n[s];
  }
  w.close(E * cap);
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

template <int FY, int FX>
static int launch_merge_mcu(const unsigned* wy, const int* by,
                            const unsigned* wc, const int* bc, int cap,
                            int nmch, int nmcw, unsigned* out, int* out_bits,
                            cudaStream_t stream) {
  const int nmcu = nmch * nmcw;
  const size_t smem = stage_bytes(FY * FX + 2, cap);
  const int blocks = (nmcu + kThreads - 1) / kThreads;
  if (cap > kStaged) {
    merge_mcu_kernel<FY, FX, true><<<blocks, kThreads, smem, stream>>>(
        wy, by, wc, bc, cap, nmch, nmcw, out, out_bits);
  } else {
    merge_mcu_kernel<FY, FX, false><<<blocks, kThreads, smem, stream>>>(
        wy, by, wc, bc, cap, nmch, nmcw, out, out_bits);
  }
  return (int)cudaGetLastError();
}

// fy x fx of 4:2:0, 4:2:2 or 4:4:4, else cudaErrorInvalidValue.
extern "C" int jt_merge_mcu(const unsigned* wy, const int* by,
                            const unsigned* wc, const int* bc, int cap,
                            int nmch, int nmcw, int fy, int fx, unsigned* out,
                            int* out_bits, cudaStream_t stream) {
  if (nmch * nmcw <= 0 || cap < 1) return (int)cudaGetLastError();
  if (fy == 2 && fx == 2) {
    return launch_merge_mcu<2, 2>(wy, by, wc, bc, cap, nmch, nmcw, out,
                                  out_bits, stream);
  }
  if (fy == 1 && fx == 2) {
    return launch_merge_mcu<1, 2>(wy, by, wc, bc, cap, nmch, nmcw, out,
                                  out_bits, stream);
  }
  if (fy == 1 && fx == 1) {
    return launch_merge_mcu<1, 1>(wy, by, wc, bc, cap, nmch, nmcw, out,
                                  out_bits, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Thread blocks of K5 one SM holds at 4:2:0 and this cap, or -1 on an
// error.
extern "C" int jt_merge_mcu_per_sm(int cap) {
  int n = 0;
  const cudaError_t err =
      cap > kStaged
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, merge_mcu_kernel<2, 2, true>, kThreads,
                stage_bytes(6, cap))
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, merge_mcu_kernel<2, 2, false>, kThreads,
                stage_bytes(6, cap));
  return err == cudaSuccess ? n : -1;
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
