// K12: restart segments stitched into one buffer, byte-aligned and padded.
//
// Replaces jpegtpu/entropy/pallas_concat.py: _stitch_rows (_stitch_kernel,
// via stitch_segments_pallas), together with the K8 row merge
// (merge_sublanes_pallas) that jpegtpu runs before it.
//
// Input: per-stream words [C, n] (a gray block's K4 stream or a color
// MCU's K5 stream, words past its bits zero) and bit counts [n], each
// clamped to C * 32 (a stream past that overflowed; the encode retries at
// a larger cap); segments of seg_len streams. Output: one buffer of
// out_words words, every word written once: each segment starts on a byte
// boundary, its last byte padded with 1s (or 0s), zeros past the total;
// seg_tot [S] int32 (each segment's bits with its pad) and the total bits
// (int64).
//
// Bound: bytes, and at these sizes launch latency. At 3024 x 4032 the
// valid output is ~1 MB and the buffer (C words a stream) ~6 MB: a few
// microseconds at 3.35 TB/s, less than two launches take. So the design
// spends exactly two launches and nothing else on the card: no prefix
// sums in torch, no zero-fill, no atomics. A stream's offset is a scan
// over the streams with one operator: a span of streams maps the bit
// position x after the stream before it to x + a when it holds no
// segment start, and to round8(x + a) + b when it does (the last start's
// base is that value less c, the bits since it). The family is closed
// under composition: (a1, b1) then (a2, b2) gives (a1, round8(b1 + a2) +
// b2). The TPU kernel instead pads every segment to 128-slot rows and
// deposits whole rows with lane rolls, which at restart_interval = 1 costs
// (cap + 1) * 512 B of scratch per segment.
// - stitch_scan_kernel: one block per tile of `tile` streams composes the
//   tile's span and writes it to spans[tile] (three int64).
// - stitch_segments_kernel: block k composes the spans of the tiles before
//   it (its start) and of all tiles (the total) while its bit counts
//   arrive by asynchronous copy; scans its tile and a halo of kThreads
//   streams in shared memory (each stream's offset and end, and each
//   segment's seg_tot where its last stream lies in the tile); then
//   writes the words whose first bit lies in its tile's bit range
//   [offset of its first stream, offset of the next tile's first stream).
//   A thread builds each word from the bits covering it: binary search
//   for the stream holding bit 32 d, funnel shifts of that stream's words
//   and the following streams', the pad's 1s in the gaps before segment
//   starts and after the last stream. The last word of a tile reads the
//   next tile's first streams (the halo; past the halo, a serial walk over
//   the bit counts, which only runs of empty streams reach). Every block
//   zeroes a share of the words past the total. Inside a block, spans and
//   positions are 32-bit, relative to a word boundary before the tile.
// Restart interval 1 (a segment per stream, several sharing a word) is
// the same code: every stream then starts a segment. At 12 MPix the
// second kernel's 373 blocks are all resident at once (under three an
// SM), so its time is one block's chain of dependent steps (the span
// reduction, the scan, the words), not the bytes it moves.

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bitjoin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <class I>
__device__ __forceinline__ I round8(I x) {
  return (x + 7) & ~(I)7;
}

// What a span of streams does to the bit position x after the stream
// before it: b < 0, no segment start: x + a; else round8(x + a) + b, and
// the last segment start of the span lies c bits before the end. Spans
// across tiles are int64; inside a tile (< 2^31 bits) int.
template <class I>
struct Span {
  I a, b, c;
};

template <class I>
__device__ __forceinline__ Span<I> identity() {
  return {0, -1, 0};
}

template <class I>
__device__ __forceinline__ Span<I> compose(Span<I> f, Span<I> g) {  // f, g
  if (g.b < 0) {
    return f.b < 0 ? Span<I>{f.a + g.a, -1, 0}
                   : Span<I>{f.a, f.b + g.a, f.c + g.a};
  }
  return f.b < 0 ? Span<I>{f.a + g.a, g.b, g.c}
                 : Span<I>{f.a, round8(f.b + g.a) + g.b, g.c};
}

__device__ __forceinline__ Span<int> stream_span(int b, bool start) {
  return start ? Span<int>{0, b, b} : Span<int>{b, -1, 0};
}

// The bit position after a stream, and the base of its segment.
struct Pos {
  long long p, base;
};

template <class I>
__device__ __forceinline__ Pos apply(Pos s, Span<I> f) {
  if (f.b < 0) return {s.p + f.a, s.base};
  const long long p = round8(s.p + f.a) + f.b;
  return {p, p - f.c};
}

template <class I>
__device__ __forceinline__ Span<I> shfl_up(Span<I> f, int o) {
  return {__shfl_up_sync(0xffffffffu, f.a, o),
          __shfl_up_sync(0xffffffffu, f.b, o),
          __shfl_up_sync(0xffffffffu, f.c, o)};
}

template <class I>
__device__ __forceinline__ Span<I> shfl_down(Span<I> f, int o) {
  return {__shfl_down_sync(0xffffffffu, f.a, o),
          __shfl_down_sync(0xffffffffu, f.b, o),
          __shfl_down_sync(0xffffffffu, f.c, o)};
}

// The composition of every thread's span in thread order; valid in
// thread 0.
template <class I>
__device__ Span<I> block_reduce(Span<I> f, Span<I>* warp_span) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const Span<I> g = shfl_down(f, o);
    if (lane + o < 32) f = compose(f, g);
  }
  if (lane == 0) warp_span[warp] = f;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) f = compose(f, warp_span[w]);
  }
  __syncthreads();  // warp_span is reused by the next call
  return f;
}

// The composition of the spans of the threads before this one.
__device__ Span<int> block_exclusive_scan(Span<int> f,
                                          Span<int>* warp_span) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Span<int> inc = f;
  for (int o = 1; o < 32; o <<= 1) {
    const Span<int> g = shfl_up(inc, o);
    if (lane >= o) inc = compose(g, inc);
  }
  Span<int> ex = shfl_up(inc, 1);
  if (lane == 0) ex = identity<int>();
  if (lane == 31) warp_span[warp] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      warp_span[w] = compose(warp_span[w - 1], warp_span[w]);
    }
  }
  __syncthreads();
  if (warp) ex = compose(warp_span[warp - 1], ex);
  __syncthreads();
  return ex;
}

// The compositions of spans[0, k) and of spans[0, tiles) (three int64
// each), in one pass over them; valid in thread 0.
__device__ void reduce_spans(const long long* __restrict__ spans, int k,
                             int tiles, Span<long long>* warp_span,
                             Span<long long>& before, Span<long long>& all) {
  const int run = (tiles + kThreads - 1) / kThreads;
  const int r0 = min(tiles, (int)threadIdx.x * run);
  const int r1 = min(tiles, r0 + run);
  Span<long long> f = identity<long long>(), g = identity<long long>();
  for (int t = r0; t < r1; ++t) {
    const Span<long long> x{spans[3 * t], spans[3 * t + 1], spans[3 * t + 2]};
    if (t < k) f = compose(f, x);
    g = compose(g, x);
  }
  before = block_reduce(f, warp_span);
  all = block_reduce(g, warp_span);
}

__global__ void __launch_bounds__(kThreads)
stitch_scan_kernel(const int* __restrict__ bits, int n, int cap_bits,
                   int seg_len, int tile, long long* __restrict__ spans) {
  __shared__ Span<int> warp_span[kWarps];
  const int per = tile / kThreads;
  const long long i0 = (long long)blockIdx.x * tile + threadIdx.x * per;
  Span<int> f = identity<int>();
  for (int j = 0; j < per; ++j) {
    if (i0 + j < n) {
      const int i = (int)(i0 + j);
      f = compose(f, stream_span(min(bits[i], cap_bits), i % seg_len == 0));
    }
  }
  f = block_reduce(f, warp_span);
  if (threadIdx.x == 0) {
    spans[3 * blockIdx.x] = f.a;
    spans[3 * blockIdx.x + 1] = f.b;
    spans[3 * blockIdx.x + 2] = f.c;
  }
}

// A walk over the streams from one of the block's scanned streams on:
// the scan's offsets while they last (local index < r_eff), then the bit
// counts, one stream after another. Bit positions are relative to the
// block's base (a multiple of 32 at or before its first stream).
struct Cursor {
  int j;     // local index: stream t0 + j
  int o, e;  // its offset and end
  bool valid;  // false past the last stream
};

struct Streams {
  const unsigned* words;
  const int* bits;
  const int* off;
  const int* end;
  int t0, n, r_eff, cap, seg_len;

  __device__ Cursor find(int pos) const {  // the first stream ending past pos
    const int j = jt::upper_bound(end, r_eff, pos);
    if (j < r_eff) return {j, off[j], end[j], true};
    Cursor c{r_eff - 1, off[r_eff - 1], end[r_eff - 1], true};
    next(c);
    return c;
  }

  __device__ void next(Cursor& c) const {
    const int p = c.e;
    ++c.j;
    if (c.j < r_eff) {
      c.o = off[c.j];
      c.e = end[c.j];
      return;
    }
    const long long i = (long long)t0 + c.j;
    if (i >= n) {
      c.valid = false;
      return;
    }
    c.o = i % seg_len == 0 ? round8(p) : p;
    c.e = c.o + min(bits[i], cap * 32);
  }

  __device__ unsigned word(int j, int k) const {
    return words[(size_t)k * n + t0 + j];
  }
};

__global__ void __launch_bounds__(kThreads)
stitch_segments_kernel(const unsigned* __restrict__ words,
                       const int* __restrict__ bits,
                       const long long* __restrict__ spans, int n, int cap,
                       int seg_len, int tile, int tiles, int pad_ones,
                       unsigned* __restrict__ out, long long out_words,
                       int* __restrict__ seg_tot,
                       long long* __restrict__ total_out) {
  extern __shared__ int scan[];  // counts, then offsets, [R]; ends [R]
  __shared__ Span<long long> warp_span[kWarps];
  __shared__ Span<int> warp_span32[kWarps];
  __shared__ Pos start;
  __shared__ long long total_s;
  const int per = tile / kThreads + 1;  // the tile, and a halo of kThreads
  const int R = per * kThreads;
  int* off = scan;
  int* end = scan + R;
  const int cap_bits = cap * 32;
  const int t0 = blockIdx.x * tile;
  const int r_eff = min(R, n - t0);

  // The bit counts arrive by asynchronous copy while the spans of the
  // tiles are composed: where the tile starts, and the total.
  for (int j = threadIdx.x; j < R; j += kThreads) {
    if (j < r_eff) {
      __pipeline_memcpy_async(&off[j], &bits[t0 + j], sizeof(int));
    } else {
      off[j] = 0;
    }
  }
  __pipeline_commit();
  Span<long long> before, all;
  reduce_spans(spans, blockIdx.x, tiles, warp_span, before, all);
  if (threadIdx.x == 0) {
    start = apply({0, 0}, before);
    total_s = round8(apply({0, 0}, all).p);
    if (blockIdx.x == 0) *total_out = total_s;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  const long long total = total_s;
  // positions from here on are relative to base: a tile's streams, its
  // halo's and their pads span less than 2^31 bits
  const long long base = start.p & ~31LL;

  // Each scanned stream's offset and end; seg_tot of the segments whose
  // last stream is the tile's.
  const int r0 = threadIdx.x * per;
  Span<int> f = identity<int>();
  for (int j = r0; j < min(r0 + per, r_eff); ++j) {
    f = compose(f,
                stream_span(min(off[j], cap_bits), (t0 + j) % seg_len == 0));
  }
  Pos pos = apply(start, block_exclusive_scan(f, warp_span32));
  for (int j = r0; j < min(r0 + per, r_eff); ++j) {
    const int i = t0 + j;
    const int b = min(off[j], cap_bits);
    const long long o = i % seg_len == 0 ? round8(pos.p) : pos.p;
    if (i % seg_len == 0) pos.base = o;
    pos.p = o + b;
    off[j] = (int)(o - base);
    end[j] = (int)(pos.p - base);
    if (j < tile && (i % seg_len == seg_len - 1 || i == n - 1)) {
      seg_tot[i / seg_len] = (int)(round8(pos.p) - pos.base);
    }
  }
  __syncthreads();

  // The words whose first bit lies in the tile's range, built in
  // base-relative positions (the last tile's total is within range).
  const Streams st{words, bits, off, end, t0, n, r_eff, cap, seg_len};
  const bool last = (long long)t0 + tile >= n;
  const int tot = (int)min(total - base, (long long)INT_MAX);
  const int q_hi = last ? tot : off[tile];
  const long long wbase = base >> 5;
  const long long dlo = wbase + ((off[0] + 31) >> 5);
  const long long dhi = wbase + (((long long)q_hi + 31) >> 5);
  for (long long g = jt::first_group(dlo, jt::line_phase(out)) +
                     4LL * threadIdx.x;
       g < dhi; g += 4LL * kThreads) {
    const long long d0 = max(g, dlo), d1 = min(g + 4, dhi);
    unsigned v[4] = {0u, 0u, 0u, 0u};
    int p = (int)((d0 - wbase) << 5);
    Cursor c = st.find(p);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (d0 + w >= d1) break;
      const int w0 = p, wend = p + 32;
      unsigned x = 0u;
      while (p < wend) {
        while (c.valid && c.e <= p) st.next(c);
        if (!c.valid) {  // past the last stream: its segment's pad
          if (pad_ones && p < tot) {
            x |= jt::top_mask(min(tot, wend) - p) >> (p - w0);
          }
          p = wend;
          break;
        }
        if (c.o > p) {  // the pad before a segment start
          const int stop = min(c.o, wend);
          if (pad_ones) x |= jt::top_mask(stop - p) >> (p - w0);
          p = stop;
          continue;
        }
        const int stop = min(c.e, wend);
        const int j = c.j;
        x |= jt::take_bits([&st, j](int k) { return st.word(j, k); }, cap,
                           p - c.o, stop - p) >> (p - w0);
        p = stop;
      }
      v[w] = x;
    }
    jt::store_words(out, d0, (int)(d1 - d0), v);
  }

  // A share of the words past the total, zeroed.
  const long long zlo = (total + 31) >> 5;
  const long long share = ((out_words - zlo + tiles - 1) / tiles + 3) & ~3LL;
  const long long z0 = min(out_words, zlo + share * blockIdx.x);
  jt::zero_words(out, z0, min(out_words, z0 + share));
}

}  // namespace

// Tiles of `tile` streams (a multiple of 256; entropy/stitch.py:
// stitch_tile), spans [ceil(n / tile), 3] int64 scratch. Two launches.
extern "C" int jt_stitch_scan(const int* bits, int n, int cap, int seg_len,
                              int tile, long long* spans,
                              cudaStream_t stream) {
  if (tile <= 0 || tile % kThreads) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    stitch_scan_kernel<<<(n + tile - 1) / tile, kThreads, 0, stream>>>(
        bits, n, cap * 32, seg_len, tile, spans);
  }
  return (int)cudaGetLastError();
}

extern "C" int jt_stitch_segments(const unsigned* words, const int* bits,
                                  const long long* spans, int n, int cap,
                                  int seg_len, int tile, int pad_ones,
                                  unsigned* out, long long out_words,
                                  int* seg_tot, long long* total,
                                  cudaStream_t stream) {
  if (tile <= 0 || tile % kThreads) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int tiles = (n + tile - 1) / tile;
    const size_t smem = 2 * (size_t)(tile + kThreads) * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          stitch_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    stitch_segments_kernel<<<tiles, kThreads, smem, stream>>>(
        words, bits, spans, n, cap, seg_len, tile, tiles, pad_ones, out,
        out_words, seg_tot, total);
  }
  return (int)cudaGetLastError();
}
