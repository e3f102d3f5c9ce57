// K8 + K9: per-block bit streams -> one scan-order stream.
//
// Kernel A (merge_rows) replaces jpegtpu/entropy/pallas_concat.py:
// merge_sublanes_pallas (_merge_kernel / _merge_kernel_skew, ws = 128).
// Kernel B (stream_concat) replaces pallas_concat.py: stream_concat_pallas
// (_stream_kernel).
//
// A row segment is up to 128 consecutive blocks of one block row: segment
// (br, cg) holds blocks br * nbw + cg * 128 + l, l < 128, the last group
// of a row ragged when nbw % 128 != 0 (pad lanes contribute nothing, which
// replaces valid_mask). Segments are in scan order (br, cg).
//
// Bound: bytes, both kernels (each stream word is read once and written
// once per kernel; ~7 MB at 12 MPix, cap 8, ~2 us each at 3.35 TB/s), so
// the design keeps every global access coalesced and does the bit-granular
// work in shared memory or with atomics:
// - A: one thread block of 128 threads per segment. Shared-memory scan of
//   the 128 bit counts; each thread funnel-shifts its block's words by
//   offset & 31 and ORs them into a shared (cap + 1) * 128-word segment
//   with shared atomicOr; the segment goes out in one coalesced pass.
//   The TPU's one-hot MXU deposit and lane skew do not exist here. The
//   segment lives in dynamic shared memory: above 48 KB (cap >= 96, which
//   the color scan's per-MCU streams of E * cap words reach) the launch
//   opts in to the device's larger limit first, and a segment past that
//   limit is refused (jt_merge_rows_max_cap says where it lies).
// - B: one thread block per segment; each thread builds one output word
//   from two neighbouring segment words (funnel shift) and plain-stores it
//   when all its 32 bits are this segment's, atomicOr's it into the zeroed
//   output when it shares the word with a neighbouring segment (the first
//   and last word). Device memory has no VMEM budget, so one kernel serves
//   every image size (the TPU's chunked K10 is not needed for size).
// Shift counts are kept in [0, 31]: a shift by 32 is undefined in CUDA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kStreamThreads = 256;

__global__ void __launch_bounds__(kLanes)
merge_rows_kernel(const unsigned* __restrict__ words,
                  const int* __restrict__ bits, int nb, int cap, int nbw,
                  unsigned* __restrict__ segs, int* __restrict__ seg_bits) {
  extern __shared__ unsigned seg[];  // (cap + 1) * 128 words
  __shared__ int scan[kLanes];
  const int ncg = (nbw + kLanes - 1) / kLanes;
  const int s = blockIdx.x;
  const int br = s / ncg, cg = s % ncg;
  const int l = threadIdx.x;
  const int col = cg * kLanes + l;
  const size_t blk = (size_t)br * nbw + col;
  // A block past cap words overflowed (the encode retries at a larger
  // cap); clamping keeps every deposit inside the segment meanwhile.
  const int b = col < nbw ? min(bits[blk], cap * 32) : 0;
  const int seg_words = (cap + 1) * kLanes;
  for (int i = l; i < seg_words; i += kLanes) seg[i] = 0u;

  scan[l] = b;  // inclusive Hillis-Steele scan
  __syncthreads();
  for (int off = 1; off < kLanes; off <<= 1) {
    const int v = l >= off ? scan[l - off] : 0;
    __syncthreads();
    scan[l] += v;
    __syncthreads();
  }
  const int excl = scan[l] - b;
  const int r = excl & 31;
  const int nw = (b + 31) >> 5;
  for (int j = 0; j < nw; ++j) {
    const unsigned w = words[(size_t)j * nb + blk];
    const int idx = (excl >> 5) + j;
    atomicOr(&seg[idx], w >> r);
    if (r) atomicOr(&seg[idx + 1], w << (32 - r));
  }
  __syncthreads();
  unsigned* dst = segs + (size_t)s * seg_words;
  for (int i = l; i < seg_words; i += kLanes) dst[i] = seg[i];
  if (l == 0) seg_bits[s] = scan[kLanes - 1];
}

__global__ void __launch_bounds__(kStreamThreads)
stream_concat_kernel(const unsigned* __restrict__ segs,
                     const int* __restrict__ seg_bits,
                     const long long* __restrict__ offs, int seg_words,
                     unsigned* __restrict__ out, long long out_words) {
  const int s = blockIdx.x;
  const long long off = offs[s];
  const long long sb = seg_bits[s];
  if (sb <= 0) return;
  const unsigned* src = segs + (size_t)s * seg_words;
  const long long first = off >> 5;
  const long long n = ((off + sb - 1) >> 5) - first + 1;
  const int r = (int)(off & 31);
  for (long long i = threadIdx.x; i < n; i += kStreamThreads) {
    const unsigned cur = i < seg_words ? src[i] : 0u;
    unsigned v = cur;
    if (r) {
      const unsigned prev = (i > 0 && i <= seg_words) ? src[i - 1] : 0u;
      v = (cur >> r) | (prev << (32 - r));
    }
    const long long d = first + i;
    if (d >= out_words) break;
    if (d * 32 >= off && d * 32 + 32 <= off + sb) {
      out[d] = v;
    } else {
      atomicOr(&out[d], v);
    }
  }
}

}  // namespace

// The largest cap whose segment fits the current device's opt-in shared
// memory per block (beside the kernel's static scan array), or -1 if the
// device cannot be queried.
extern "C" int jt_merge_rows_max_cap() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  const int seg_bytes = optin - (int)(kLanes * sizeof(int));
  return seg_bytes / (int)(kLanes * sizeof(unsigned)) - 1;
}

extern "C" int jt_merge_rows(const unsigned* words, const int* bits, int nb,
                             int cap, int nbh, int nbw, unsigned* segs,
                             int* seg_bits, cudaStream_t stream) {
  const int nseg = nbh * ((nbw + kLanes - 1) / kLanes);
  if (nseg > 0) {
    const size_t smem = (size_t)(cap + 1) * kLanes * sizeof(unsigned);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          merge_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    merge_rows_kernel<<<nseg, kLanes, smem, stream>>>(words, bits, nb, cap,
                                                      nbw, segs, seg_bits);
  }
  return (int)cudaGetLastError();
}

extern "C" int jt_stream_concat(const unsigned* segs, const int* seg_bits,
                                const long long* offs, int nseg,
                                int seg_words, unsigned* out,
                                long long out_words, cudaStream_t stream) {
  if (nseg > 0) {
    stream_concat_kernel<<<nseg, kStreamThreads, 0, stream>>>(
        segs, seg_bits, offs, seg_words, out, out_words);
  }
  return (int)cudaGetLastError();
}
