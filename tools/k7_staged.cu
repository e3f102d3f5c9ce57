// K7 (pack_blocks) with its elements staged in shared memory: the design
// that jpegtpu_torch/csrc/pack.cu weighed against its walk from
// registers. Not part of the package: tools/torch_kernel_ab.py builds it,
// holds its words, bit counts and overflow flag equal to pack.cu's and
// times the two (and another checkout's K7) in turns. Same arguments,
// layouts and semantics as jt_pack_blocks.
//
// The design, as in K4:
// - A warp owns a tile of 32 consecutive blocks, a thread each, 4 tiles a
//   thread block. Each thread stages its block's counts, 64 elements at a
//   time, in its own shared row with 64 asynchronous copies in flight at
//   once (a warp copy is one 128-byte line of one element), notes the
//   non-empty elements in two 32-bit masks and keeps the counts as bytes
//   (a mask of the elements past 32 bits, built in the same loop from
//   the same counts, came out wrong on the card; the long elements are
//   found from the bytes).
// - Then the words of the non-empty elements, whose addresses are now
//   known, are all copied at once: the first word into the element's own
//   slot of the row (over its count), the later words of the first
//   kLongSlots elements past 32 bits into slots of their own. A longer
//   element reaches past the next elements' slots (up to 96 bits), so no
//   word of the output retires into the row; an element past those slots
//   (none at Q50, a block of more than kLongSlots such elements is
//   synthetic) reads its later words from memory during the walk.
// - The walk reads shared memory only and takes one step per non-empty
//   element (__ffs over the masks).
// - The first kOutSlots words retire into slots of the row; the tile
//   stores them as whole [cap, nb] rows of 32 blocks, zeros past each
//   block's words. A word past them (a dense block at a large cap) goes
//   straight to its row.
// - Each thread block ORs its blocks' overflow into a word that the last
//   thread block to finish turns into the flag and resets, so the wrapper
//   runs no compare and no reduction after the launch.
// 107 words a thread, 54.8 KB a thread block (4 an SM) whatever E or cap.

#include <cstdint>
#include <cuda_runtime.h>

#include "../jpegtpu_torch/csrc/cp_async.cuh"

namespace {

// K7: a thread's row of shared memory, in words: its elements' bit counts
// and then their first words [kChunk] (+1: an odd row length puts a
// warp's 32 rows in distinct banks), the counts as bytes [16], the later
// words of long elements [2 * kLongSlots], the first output words.
constexpr int kPackWarps = 4;  // tiles a thread block
constexpr int kChunk = 64;     // elements staged at once
constexpr int kLenWords = kChunk / 4;
constexpr int kLongSlots = 8;
constexpr int kOutSlots = 8;
constexpr int kPackRow = (kChunk + 1) + (kLenWords + 1) + 2 * kLongSlots +
                         kOutSlots + 1;  // 107
constexpr size_t kPackSmem = kPackWarps * 32 * kPackRow * sizeof(unsigned);

// Appends one element (w0..w2 MSB-aligned, len <= 96 bits) to the
// accumulator a[0..3] holding cnt < 32 pending bits.
__device__ __forceinline__ void append_element(unsigned (&a)[4], int cnt,
                                               unsigned w0, unsigned w1,
                                               unsigned w2) {
  if (cnt) {
    const int t = 32 - cnt;
    a[0] |= w0 >> cnt;
    a[1] |= (w1 >> cnt) | (w0 << t);
    a[2] |= (w2 >> cnt) | (w1 << t);
    a[3] |= w2 << t;
  } else {
    a[0] |= w0;
    a[1] |= w1;
    a[2] |= w2;
  }
}

__global__ void __launch_bounds__(kPackWarps * 32)
pack_blocks_kernel(const unsigned* __restrict__ elems,
                   const int* __restrict__ elem_bits, int n_elem, int nb,
                   int cap, unsigned* __restrict__ words,
                   int* __restrict__ bits, unsigned char* __restrict__ flag,
                   unsigned* __restrict__ sync) {
  extern __shared__ unsigned prow[];  // kPackSmem bytes
  unsigned* row = prow + threadIdx.x * kPackRow;
  unsigned* lens = row + kChunk + 1;  // counts as bytes
  const unsigned char* len8 = reinterpret_cast<const unsigned char*>(lens);
  unsigned* longw = lens + kLenWords + 1;
  unsigned* outw = longw + 2 * kLongSlots;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < nb;
  const size_t plane = (size_t)n_elem * nb;  // one element word's plane
  unsigned a[4] = {0u, 0u, 0u, 0u};  // MSB-aligned pending bits
  int cnt = 0;   // pending bit count, < 32 between elements
  int widx = 0;  // words retired (counted past cap too)
  const auto retire = [&](unsigned v) {
    if (widx < kOutSlots) {
      outw[widx] = v;
    } else if (widx < cap) {
      words[(size_t)widx * nb + b] = v;
    }
  };
  for (int c0 = 0; c0 < n_elem; c0 += kChunk) {
    const int n = min(kChunk, n_elem - c0);
    // this thread's element c0 (k = 0); element c0 + k lies k * nb further
    const size_t base = (size_t)c0 * nb + (live ? b : 0);
    const int* cp = elem_bits + base;
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k, cp += nb) {  // the counts, 0 past n
      const bool in = live && k < n;
      cp_async_4(row + k, in ? cp : elem_bits, in ? 4 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    unsigned ne[2] = {0u, 0u};  // the non-empty elements
#pragma unroll
    for (int q = 0; q < kLenWords; ++q) {
      unsigned packed = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * q + j;
        const int len = max((int)row[k], 0);
        ne[k >> 5] |= (unsigned)(len > 0) << (k & 31);
        packed |= (unsigned)len << (8 * j);
      }
      lens[q] = packed;
    }
    // the first word of every non-empty element, over its count
    const unsigned* ep = elems + base;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll 8
      for (int k = 32 * h; k < 32 * h + 32; ++k, ep += nb) {
        cp_async_4(row + k, ep, (ne[h] >> (k & 31)) & 1u ? 4 : 0);
      }
    }
    // the later words of the first kLongSlots elements past 32 bits
    int slot = 0;
    for (int h = 0; h < 2; ++h) {
      for (unsigned m = ne[h]; m && slot < kLongSlots; m &= m - 1) {
        const int k = 32 * h + __ffs(m) - 1;
        const int len = len8[k];
        if (len > 32) {
          const unsigned* lp = elems + base + (size_t)k * nb;
          cp_async_4(longw + 2 * slot, lp + plane, 4);
          cp_async_4(longw + 2 * slot + 1, lp + 2 * plane,
                     len > 64 ? 4 : 0);
          ++slot;
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    slot = 0;
    for (int h = 0; h < 2; ++h) {
      for (unsigned m = ne[h]; m; m &= m - 1) {
        const int k = 32 * h + __ffs(m) - 1;
        const int len = len8[k];
        unsigned w1 = 0u, w2 = 0u;
        if (len > 32) {
          if (slot < kLongSlots) {
            w1 = longw[2 * slot];
            w2 = longw[2 * slot + 1];
          } else {
            const unsigned* ep = elems + base + (size_t)k * nb;
            w1 = ep[plane];
            w2 = len > 64 ? ep[2 * plane] : 0u;
          }
          ++slot;
        }
        append_element(a, cnt, row[k], w1, w2);
        cnt += len;
        while (cnt >= 32) {  // at most 3 words: cnt < 32 + 96
          retire(a[0]);
          ++widx;
          a[0] = a[1];
          a[1] = a[2];
          a[2] = a[3];
          a[3] = 0u;
          cnt -= 32;
        }
      }
    }
  }
  int produced = widx;
  if (cnt > 0) {  // the partial word (zeros below the residue)
    retire(a[0]);
    ++produced;
  }
  const bool over = live && widx * 32 + cnt > cap * 32;
  if (live) {
    // whole rows, zeros past each block's words: one line a row
    for (int r = 0; r < min(cap, kOutSlots); ++r) {
      words[(size_t)r * nb + b] = r < produced ? outw[r] : 0u;
    }
    for (int r = kOutSlots; r < cap; ++r) {
      if (r >= produced) words[(size_t)r * nb + b] = 0u;
    }
    bits[b] = widx * 32 + cnt;
  }
  // the overflow flag: sync[0] ORs the thread blocks' overflow, sync[1]
  // counts finished thread blocks; the last one writes the flag and
  // resets both for the next launch on this stream
  if (__syncthreads_or(over) && threadIdx.x == 0) atomicOr(&sync[0], 1u);
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&sync[1], 1u) == gridDim.x - 1) {
      __threadfence();
      *flag = atomicExch(&sync[0], 0u) != 0u;
      atomicExch(&sync[1], 0u);
    }
  }
}

}  // namespace

// sync: two words, zero before the first launch on a stream; each launch
// leaves them zero. flag: one byte, the overflow.
extern "C" int jt_pack_blocks_staged(const unsigned* elems,
                                     const int* elem_bits, int n_elem,
                                     int nb, int cap, unsigned* words,
                                     int* bits, unsigned char* flag,
                                     unsigned* sync, cudaStream_t stream) {
  if (nb > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        pack_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kPackSmem);
    if (err != cudaSuccess) return (int)err;
    constexpr int kBlocks = kPackWarps * 32;
    pack_blocks_kernel<<<(nb + kBlocks - 1) / kBlocks, kBlocks, kPackSmem,
                         stream>>>(elems, elem_bits, n_elem, nb, cap, words,
                                   bits, flag, sync);
  }
  return (int)cudaGetLastError();
}

// Thread blocks of pack_blocks_kernel one SM holds, or -1 on an error.
extern "C" int jt_pack_blocks_staged_per_sm() {
  int n = 0;
  if (cudaFuncSetAttribute(pack_blocks_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kPackSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, pack_blocks_kernel, kPackWarps * 32, kPackSmem) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}
