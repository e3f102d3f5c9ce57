// K4 (encode_blocks) as a warp per 8x8 block: the design that
// jpegtpu_torch/csrc/pack.cu weighed against its thread-per-block walk.
// Not part of the package: tools/torch_kernel_ab.py builds it, checks its
// words and bit counts equal to pack.cu's and times the two (and another
// checkout's K4) in turns. Same arguments, layouts and semantics as
// jt_encode_blocks: levels [64, nb], dc_diff [nb], a [192] table, caps up
// to 53 -> words [cap, nb], bits [nb].
//
// - A warp owns a tile of 32 consecutive blocks (4 tiles a 128-thread
//   block) and stages their levels [64][33] in shared memory with 64
//   coalesced asynchronous copies a lane, all in flight at once.
// - Then one block at a time: lane l holds coefficients l and l + 32, and
//   two ballots give the block's nonzero mask. Each nonzero AC at k finds
//   the previous nonzero below it in the mask (or 0); run = k - prev - 1
//   makes (run >> 4) ZRLs and the (run & 15, size) code. Lane 0's first
//   slot is the DC put, lane 31's second slot EOB when coefficient 63 is
//   zero.
// - Each lane's two slot lengths, packed into one word as two 16-bit
//   halves, go through one inclusive warp scan: slot 0 of every lane comes
//   before slot 1 of any lane, so the low halves give slot 0's offsets and
//   their total plus the high halves slot 1's.
// - Each put (at most 32 bits) ORs into at most two words of the warp's
//   [cap][33] word buffer with shared atomics; bits past cap * 32 are
//   dropped. The tile leaves as cap whole rows of 32 blocks.

#include <cstdint>
#include <cuda_runtime.h>

#include "../jpegtpu_torch/csrc/cp_async.cuh"

namespace {

constexpr int kHuffAc = 0, kHuffDc = 176, kHuffZrl = 188, kHuffEob = 190;
constexpr int kHuffSize = 192;
constexpr int kWarps = 4;
constexpr int kPitch = 33;  // [64][33] levels, [cap][33] words
constexpr int kMaxWords = 53;

__device__ __forceinline__ int size_of(int v) { return 32 - __clz(abs(v)); }

__device__ __forceinline__ unsigned amplitude(int v, int size) {
  const unsigned mask = size >= 32 ? 0xFFFFFFFFu : (1u << size) - 1u;
  return (unsigned)(v > 0 ? v : v - 1) & mask;
}

// OR the low `len` (1-32) bits of val into column col of the word buffer
// at bit offset o, MSB first; words past cap are dropped.
__device__ __forceinline__ void put(unsigned* col, int cap, int o,
                                    unsigned val, int len) {
  const int w = o >> 5, end = (o & 31) + len;
  if (w < cap) {
    atomicOr(col + w * kPitch,
             end <= 32 ? val << (32 - end) : val >> (end - 32));
  }
  if (end > 32 && w + 1 < cap) atomicOr(col + (w + 1) * kPitch,
                                        val << (64 - end));
}

// The slot's puts: `nzrl` ZRLs, then (val, len).
__device__ __forceinline__ void emit(unsigned* col, int cap, int o, int nzrl,
                                     unsigned zrl_code, int zrl_len,
                                     unsigned val, int len) {
  for (int z = 0; z < nzrl; ++z, o += zrl_len) {
    put(col, cap, o, zrl_code, zrl_len);
  }
  if (len > 0) put(col, cap, o, val, len);
}

size_t smem_bytes(int cap) {
  return (size_t)(kHuffSize + kWarps * (64 + cap) * kPitch) * 4;
}

__global__ void __launch_bounds__(kWarps * 32)
encode_warp_kernel(const int* __restrict__ levels,
                   const int* __restrict__ dc_diff,
                   const int* __restrict__ huff, int nb, int cap,
                   unsigned* __restrict__ words, int* __restrict__ bits) {
  extern __shared__ int smem[];
  int* s_h = smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* s_lev = s_h + kHuffSize + warp * (64 + cap) * kPitch;
  unsigned* s_w = reinterpret_cast<unsigned*>(s_lev + 64 * kPitch);
  const int base = (blockIdx.x * kWarps + warp) * 32;
  const int b = base + lane;
  const bool live = b < nb;

  for (int k = 0; k < 64; ++k) {
    cp_async_4(s_lev + k * kPitch + lane,
               levels + (live ? (size_t)k * nb + b : 0), live ? 4 : 0);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < kHuffSize; i += kWarps * 32) s_h[i] = huff[i];
  for (int r = 0; r < cap; ++r) s_w[r * kPitch + lane] = 0u;
  const int d_own = live ? dc_diff[b] : 0;
  cp_async_wait<0>();
  __syncthreads();

  const unsigned zrl_code = (unsigned)s_h[kHuffZrl];
  const int zrl_len = s_h[kHuffZrl + 1];
  const unsigned lt = (1u << lane) - 1u;
  const int n = min(32, nb - base);
  int my_bits = 0;
  for (int j = 0; j < n; ++j) {
    const int v0 = s_lev[lane * kPitch + j];
    const int v1 = s_lev[(lane + 32) * kPitch + j];
    const unsigned m0 = __ballot_sync(~0u, v0 != 0) & ~1u;  // AC only
    const unsigned m1 = __ballot_sync(~0u, v1 != 0);
    const int d = __shfl_sync(~0u, d_own, j);

    // slot 0: coefficient k = lane (lane 0: the DC put)
    unsigned val0 = 0;
    int len0 = 0, nzrl0 = 0;
    if (lane == 0) {
      const int dsize = size_of(d);
      const int pk = s_h[kHuffDc + (dsize <= 11 ? dsize : 0)];
      val0 = ((unsigned)(pk >> 6) << dsize) | amplitude(d, dsize);
      len0 = (pk & 63) + dsize;
    } else if (v0 != 0) {
      const unsigned below = m0 & lt;
      const int run = lane - (below ? 31 - __clz(below) : 0) - 1;
      const int size = size_of(v0);
      const int pk = s_h[kHuffAc + (run & 15) * 11 + (size <= 10 ? size : 0)];
      val0 = ((unsigned)(pk >> 6) << size) | amplitude(v0, size);
      len0 = (pk & 63) + size;
      nzrl0 = run >> 4;
    }
    // slot 1: coefficient k = lane + 32 (lane 31, k = 63: EOB if zero)
    unsigned val1 = 0;
    int len1 = 0, nzrl1 = 0;
    if (v1 != 0) {
      const unsigned below = m1 & lt;
      const int prev = below ? 63 - __clz(below) : m0 ? 31 - __clz(m0) : 0;
      const int run = lane + 32 - prev - 1;
      const int size = size_of(v1);
      const int pk = s_h[kHuffAc + (run & 15) * 11 + (size <= 10 ? size : 0)];
      val1 = ((unsigned)(pk >> 6) << size) | amplitude(v1, size);
      len1 = (pk & 63) + size;
      nzrl1 = run >> 4;
    } else if (lane == 31) {
      val1 = (unsigned)s_h[kHuffEob];
      len1 = s_h[kHuffEob + 1];
    }

    // offsets: one inclusive scan of both slots' lengths
    const int n0 = nzrl0 * zrl_len + len0, n1 = nzrl1 * zrl_len + len1;
    int x = n0 | n1 << 16;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(~0u, x, s);
      if (lane >= s) x += y;
    }
    const int total = __shfl_sync(~0u, x, 31);
    const int tot0 = total & 0xFFFF;
    if (lane == j) my_bits = tot0 + (total >> 16);

    unsigned* col = s_w + j;
    if (n0) emit(col, cap, (x & 0xFFFF) - n0, nzrl0, zrl_code, zrl_len, val0,
                 len0);
    if (n1) emit(col, cap, tot0 + (x >> 16) - n1, nzrl1, zrl_code, zrl_len,
                 val1, len1);
  }
  __syncwarp();
  if (!live) return;
  for (int r = 0; r < cap; ++r) {
    words[(size_t)r * nb + b] = s_w[r * kPitch + lane];
  }
  bits[b] = my_bits;
}

}  // namespace

extern "C" int jt_encode_blocks_warp(const int* levels, const int* dc_diff,
                                     const int* huff, int nb, int cap,
                                     unsigned* words, int* bits,
                                     cudaStream_t stream) {
  if (cap < 0 || cap > kMaxWords) return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    const size_t smem = smem_bytes(cap);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          encode_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    encode_warp_kernel<<<(nb + kWarps * 32 - 1) / (kWarps * 32), kWarps * 32,
                         smem, stream>>>(levels, dc_diff, huff, nb, cap,
                                         words, bits);
  }
  return (int)cudaGetLastError();
}

// Thread blocks of encode_warp_kernel one SM holds at `cap`, or -1.
extern "C" int jt_encode_blocks_warp_per_sm(int cap) {
  int n = 0;
  const size_t smem = smem_bytes(cap);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(encode_warp_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    return -1;
  }
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, encode_warp_kernel, kWarps * 32, smem) != cudaSuccess) {
    return -1;
  }
  return n;
}
