// K5 (merge_mcu) with its output words built independently, T threads an
// MCU: the design that jpegtpu_torch/csrc/merge.cu weighed against the
// one it ships. Not part of the package: tools/torch_kernel_ab.py builds
// it, holds its frame and bit counts equal to merge.cu's and times the
// two (and another checkout's K5) in turns. Same arguments and semantics
// as jt_merge_mcu, plus T (groups).
//
// A thread block of 128 threads covers 128 consecutive MCUs (threads
// across MCUs, so every frame store and every chroma load is coalesced)
// and grid row g of T takes the MCU's words j = g, g + T, g + 2T, ...: the
// MCU's few words that hold bits fall to different threads. Each thread
// loads the E bit counts, clamps them and forms the E running ends in
// registers; for each of its words below the MCU's total it finds the
// slot holding bit 32 j by E compares, builds the word from that slot's
// words k and k + 1 (one funnel shift) and, while the word's 32 bits run
// past the slot's end, ORs in the next slots' leading bits. Words past
// the total are stored as zeros with no load. A word's loads depend only
// on the ends in registers, never on another word.

#include <cstdint>
#include <cuda_runtime.h>

#include "../jpegtpu_torch/csrc/bitjoin.cuh"

namespace {

constexpr int kThreads = 128;

// Word k of slot s (s < E) of MCU (my, mx), m = my * nmcw + mx: luma
// block (FY * my + s / FX, FX * mx + s % FX) of words wy [cap, ny], or
// chroma block (s - FY * FX) * nmcu + m of words wc [cap, 2 * nmcu].
template <int FY, int FX>
struct McuSlots {
  static constexpr int kY = FY * FX;
  static constexpr int kE = kY + 2;
  const unsigned* __restrict__ wy;
  const unsigned* __restrict__ wc;
  size_t ny, nc;  // word strides: luma blocks, chroma blocks
  int luma0;      // raster index of the MCU's first luma block
  int nbw_y;      // luma blocks a row
  int chroma0;    // m

  __device__ __forceinline__ int block(int s, int nmcu) const {
    return s < kY ? luma0 + (s / FX) * nbw_y + s % FX
                  : (s - kY) * nmcu + chroma0;
  }
  __device__ __forceinline__ unsigned word(int s, int k, int nmcu) const {
    const int b = block(s, nmcu);
    return s < kY ? __ldg(wy + (size_t)k * ny + b)
                  : __ldg(wc + (size_t)k * nc + b);
  }
};

// The MCU's slot bounds around s: [start, end) of slot s in its stream,
// from the inclusive running ends (registers only: s is not a constant).
template <int E>
__device__ __forceinline__ void slot_bounds(const int (&ends)[E], int s,
                                            int& start, int& end) {
  start = 0;
  end = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (k == s - 1) start = ends[k];
    if (k == s) end = ends[k];
  }
}

// Word j (32 j < the MCU's total) of the MCU's stream: the slot holding
// bit 32 j, found by E compares, then its bits and those of the slots
// after it, until 32 bits are covered or the slots end.
template <int FY, int FX>
__device__ __forceinline__ unsigned mcu_word(
    const McuSlots<FY, FX>& slots, const int (&ends)[FY * FX + 2], int j,
    int nmcu) {
  constexpr int E = FY * FX + 2;
  int p = 32 * j;
  const int wend = p + 32;
  int s = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) s += ends[k] <= p;
  unsigned v = 0u;
  for (; s < E && p < wend; ++s) {
    int start, end;
    slot_bounds(ends, s, start, end);
    if (end <= p) continue;  // an empty slot
    const int stop = min(end, wend);
    const int q = p - start, k = q >> 5, r = q & 31, len = stop - p;
    // r + len > 32 only for r > 0, and then word k + 1 lies in the slot
    unsigned x = slots.word(s, k, nmcu) << r;
    if (r + len > 32) x |= slots.word(s, k + 1, nmcu) >> (32 - r);
    v |= (x & jt::top_mask(len)) >> (p - 32 * j);
    p = stop;
  }
  return v;
}

// Grid (ceil(nmcu / 128), T): thread (m, g) writes words g, g + T, ... of
// MCU m, and grid row 0 its bit count.
template <int FY, int FX>
__global__ void __launch_bounds__(kThreads)
merge_mcu_words_kernel(const unsigned* __restrict__ wy,
                       const int* __restrict__ by,
                       const unsigned* __restrict__ wc,
                       const int* __restrict__ bc, int cap, int nmch,
                       int nmcw, unsigned* __restrict__ out,
                       int* __restrict__ out_bits) {
  constexpr int E = FY * FX + 2;
  const int nmcu = nmch * nmcw;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= nmcu) return;
  const int my = m / nmcw, mx = m - my * nmcw;
  McuSlots<FY, FX> slots;
  slots.wy = wy;
  slots.wc = wc;
  slots.ny = (size_t)(FY * FX) * nmcu;
  slots.nc = 2 * (size_t)nmcu;
  slots.nbw_y = FX * nmcw;
  slots.luma0 = FY * my * slots.nbw_y + FX * mx;
  slots.chroma0 = m;
  const int limit = cap * 32;
  int ends[E];
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int b = slots.block(s, nmcu);
    ends[s] = min(__ldg(s < FY * FX ? by + b : bc + b), limit);
  }
#pragma unroll
  for (int s = 1; s < E; ++s) ends[s] += ends[s - 1];
  const int total = ends[E - 1];
  if (blockIdx.y == 0) out_bits[m] = total;
  const int nwords = E * cap;
  for (int j = blockIdx.y; j < nwords; j += gridDim.y) {
    out[(size_t)j * nmcu + m] =
        32 * j < total ? mcu_word(slots, ends, j, nmcu) : 0u;
  }
}

}  // namespace

// groups: T, the threads an MCU (grid rows); fy x fx of 4:2:0, 4:2:2 or
// 4:4:4, else cudaErrorInvalidValue.
extern "C" int jt_merge_mcu_words(const unsigned* wy, const int* by,
                                  const unsigned* wc, const int* bc, int cap,
                                  int nmch, int nmcw, int fy, int fx,
                                  int groups, unsigned* out, int* out_bits,
                                  cudaStream_t stream) {
  const int nmcu = nmch * nmcw;
  if (groups < 1 || groups > 65535) return (int)cudaErrorInvalidValue;
  if (nmcu <= 0) return (int)cudaGetLastError();
  const dim3 grid((nmcu + kThreads - 1) / kThreads, groups);
  if (fy == 2 && fx == 2) {
    merge_mcu_words_kernel<2, 2><<<grid, kThreads, 0, stream>>>(
        wy, by, wc, bc, cap, nmch, nmcw, out, out_bits);
  } else if (fy == 1 && fx == 2) {
    merge_mcu_words_kernel<1, 2><<<grid, kThreads, 0, stream>>>(
        wy, by, wc, bc, cap, nmch, nmcw, out, out_bits);
  } else if (fy == 1 && fx == 1) {
    merge_mcu_words_kernel<1, 1><<<grid, kThreads, 0, stream>>>(
        wy, by, wc, bc, cap, nmch, nmcw, out, out_bits);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

