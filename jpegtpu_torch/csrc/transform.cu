// K1, K2, K3: pixels -> quantized zigzag levels, eight threads per 8x8
// block.
//
// K1 (transform) replaces jpegtpu/ops/pallas_transform.py:
// transform_plane_raw (_make_transform_kernel / _dct_store_f32, and
// _make_transform_kernel_int / _dct_store_int in int32 mode).
// K2 (transform_rgb_y) replaces transform_rgb_y_raw (_make_rgb_y_kernel):
// interleaved RGB -> fixed-point luma, fused with K1.
// K3 (transform_rgb_chroma) replaces transform_rgb_chroma_raw
// (_make_rgb_chroma_kernel): interleaved RGB -> clipped Cb and Cr, box
// filter over each fy x fx window, then K1's transform.
//
// Bound: bytes. K1 reads 1 byte and writes 4 bytes of int32 levels per
// pixel; K2 reads 3 bytes of RGB per luma pixel; K3 reads the full-res RGB
// once and writes 2 x 4 bytes per chroma pixel. The DCT is 1,024
// multiply-adds per block (16 per pixel), below the card's float32 rate,
// but not by so much that instructions can be wasted. So the design keeps
// enough memory traffic in flight and spends few instructions besides the
// multiply-adds:
// - A thread block of 256 threads owns one tile of 32 transforms: a row of
//   32 blocks (K1, K2), or of 16 chroma blocks, Cb and Cr (K3). It copies
//   the tile's pixel rows into shared memory with 16-byte loads where a
//   row's address allows it (8-byte ones elsewhere), every load of a
//   thread issued before its first store. Each thread then makes one row
//   of 8 samples (gray, luma, or a box-filtered Cb or Cr) and stores them
//   level-shifted as 32-bit values (float32, or int32 in int32 mode), so
//   no thread unpacks a byte twice.
// - Eight threads share a block: thread u computes row u of y1 = T X from
//   the whole block (two 16-byte shared loads a sample row, a broadcast
//   within the eight), then row u of F = y1 T^T from its own row of y1, so
//   no thread waits on another between the passes. 32-40 registers a
//   thread, not the 225-255 of one thread per block, so 6-7 thread blocks
//   (48-56 warps) share an SM and one's loads and stores overlap another's
//   arithmetic.
// - The levels are staged over the samples by zigzag position and stored
//   coefficient-major ([64, nb]): each warp store covers 32 consecutive
//   blocks of one coefficient, 128 contiguous bytes (K3: 64 of Cb, 64 of
//   Cr).
// The grid is (block rows, tile columns): its first dimension holds a
// batch stacked into a tall plane (1024 x 512 rows: 65,536 block rows),
// past the 65,535 of the others.
// K2 and K3 read the caller's interleaved [PH, PW, 3] RGB: the TPU kernels'
// planar [3, PH, PW] input exists only because the TPU pads a minor axis
// of 3 to 128 lanes. The TPU kernels' block-diagonal bases, 0/1 box-sum
// matmuls and [G, 64, 8, 128] tiling have no place here.
//
// Float mode keeps the TPU kernel's arithmetic bit for bit where it is
// defined: each output of each DCT pass is its own sequential float32 FMA
// chain over k ascending (the order of an XLA dot), s = f / q is an IEEE
// division (__fdiv_rn; this file must not be built with --use_fast_math),
// and the level is (int)(s +/- 0.5f) after a float32 add, rounding half
// away from zero. Int32 mode is exact integer arithmetic: 11-bit
// fixed-point basis, (x + 2^10) >> 11 after each pass, |level| =
// (2|f| + q) / (2q). The color conversion and the box filter are integer
// arithmetic in both modes; the TPU kernels do them in float32 on exact
// integers (sums below 2^24), which gives the same values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // eight threads a transform, 32 at once
constexpr int kTransforms = kThreads / 8;

// zigzag position k -> raster index u * 8 + v
__constant__ unsigned char kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct __align__(16) Tables {
  float t[64];    // float basis, t[u * 8 + k] = T[u][k]
  float tt[64];   // transposed, tt[k * 8 + v] = T[v][k]
  int ti[64];     // 11-bit fixed-point basis
  int tit[64];    // transposed
  int q[64];      // quantization table, raster order
  float qf[64];   // the same as float32
  int zz[64];     // raster u * 8 + v -> zigzag position
};

__device__ __forceinline__ void load_tables(Tables& s, const int* quant,
                                            const float* basis,
                                            const int* basis_int) {
  const int t = threadIdx.x;
  if (t < 64) {
    const int tr = (t & 7) * 8 + (t >> 3);
    s.t[t] = basis[t];
    s.tt[tr] = basis[t];
    s.ti[t] = basis_int[t];
    s.tit[tr] = basis_int[t];
    s.q[t] = quant[t];
    s.qf[t] = (float)quant[t];
    s.zz[kZigzag[t]] = t;
  }
}

// Eight consecutive values of shared memory (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const int* p, int (&v)[8]) {
  const int4 a = reinterpret_cast<const int4*>(p)[0];
  const int4 b = reinterpret_cast<const int4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Copy kRows rows of kRowBytes (a multiple of 16) from global memory (row r
// at src + r * pitch, 8-byte aligned) to shared memory (row r at dst +
// r * kRowBytes, 16-byte aligned). Bytes of a row past `valid` (a multiple
// of 8) are zero. A 16-byte piece is one load where its address is 16-byte
// aligned, else two; each thread issues all its loads before it stores.
template <int kRows, int kRowBytes>
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ src,
                                           size_t pitch, int valid,
                                           uint8_t* dst) {
  constexpr int kPerRow = kRowBytes / 16;
  constexpr int kPieces = kRows * kPerRow;
  constexpr int kN = (kPieces + kThreads - 1) / kThreads;
  uint4 v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int c = threadIdx.x + i * kThreads;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (c < kPieces) {
      const int off = (c % kPerRow) * 16;
      const uint8_t* p = src + (size_t)(c / kPerRow) * pitch + off;
      const int left = valid - off;
      if (left >= 16 && ((uintptr_t)p & 15) == 0) {
        v[i] = *reinterpret_cast<const uint4*>(p);
      } else {
        if (left >= 8) {
          const uint2 a = *reinterpret_cast<const uint2*>(p);
          v[i].x = a.x;
          v[i].y = a.y;
        }
        if (left >= 16) {
          const uint2 b = *reinterpret_cast<const uint2*>(p + 8);
          v[i].z = b.x;
          v[i].w = b.y;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < kPieces) reinterpret_cast<uint4*>(dst)[c] = v[i];
  }
}

template <int N>
__device__ __forceinline__ int byte_at(const unsigned (&w)[N], int i) {
  return (int)((w[i >> 2] >> (8 * (i & 3))) & 0xFFu);
}

// Load n consecutive uint2 (8-byte aligned) of shared memory as 2n words.
template <int N>
__device__ __forceinline__ void load_words(const uint8_t* p,
                                           unsigned (&w)[2 * N]) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint2 v = q[i];
    w[2 * i] = v.x;
    w[2 * i + 1] = v.y;
  }
}

// Store one row of 8 samples (each in [0, 255]) level-shifted, as float32
// or, in int32 mode, int32 bits.
__device__ __forceinline__ void put_row(float* dst, const int (&px)[8],
                                        int int_mode) {
  float f[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    f[x] = int_mode ? __int_as_float(px[x] - 128) : (float)(px[x] - 128);
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// Row u of the levels of the 8x8 block whose level-shifted samples of row
// y are rows[y * row_stride + 0..7], in raster order v = 0..7.
__device__ __forceinline__ void block_row(const float* rows, int row_stride,
                                          int u, const Tables& s,
                                          int int_mode, int (&lv)[8]) {
  if (int_mode) {
    int acc[8], f[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[x] = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int x8[8];
      load8(reinterpret_cast<const int*>(rows + k * row_stride), x8);
      const int tk = s.ti[u * 8 + k];
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[x] += tk * x8[x];
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) f[v] = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int y1 = (acc[k] + 1024) >> 11;
      int tk[8];
      load8(s.tit + k * 8, tk);
#pragma unroll
      for (int v = 0; v < 8; ++v) f[v] += y1 * tk[v];
    }
    int q[8];
    load8(s.q + u * 8, q);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int fv = (f[v] + 1024) >> 11;
      const int mag = (2 * abs(fv) + q[v]) / (2 * q[v]);
      lv[v] = fv < 0 ? -mag : mag;
    }
  } else {
    // y1[u][x] = sum_k T[u][k] X[k][x]: one chain per x, k ascending
    float acc[8], f[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[x] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float x8[8];
      load8(rows + k * row_stride, x8);
      const float tk = s.t[u * 8 + k];
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[x] = __fmaf_rn(tk, x8[x], acc[x]);
    }
    // F[u][v] = sum_k y1[u][k] T[v][k]: one chain per v, k ascending
#pragma unroll
    for (int v = 0; v < 8; ++v) f[v] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float tk[8];
      load8(s.tt + k * 8, tk);
#pragma unroll
      for (int v = 0; v < 8; ++v) f[v] = __fmaf_rn(acc[k], tk[v], f[v]);
    }
    float q[8];
    load8(s.qf + u * 8, q);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float sc = __fdiv_rn(f[v], q[v]);
      lv[v] = __float2int_rz(__fadd_rn(sc, copysignf(0.5f, sc)));
    }
  }
}

// Luma of interleaved RGB: JFIF 16-bit weights, or the reference's
// (77 R + 150 G + 29 B) >> 8 (kind "y_ref"). Both lie in [0, 255].
template <bool kRefLuma>
__device__ __forceinline__ int luma(int r, int g, int b) {
  return kRefLuma ? (77 * r + 150 * g + 29 * b) >> 8
                  : (19595 * r + 38470 * g + 7471 * b + 32768) >> 16;
}

// What each kernel reads. kKind 0: gray samples (K1); 1, 2: interleaved
// RGB -> JFIF or reference luma (K2); 3, 4, 5: interleaved RGB -> Cb and Cr
// at 4:2:0, 4:2:2, 4:4:4 (K3). A tile is 32 transforms: a row of 32 blocks
// (K1, K2) or of 16 chroma blocks, both components (K3).
template <int kKind>
struct Front {
  static constexpr bool kChroma = kKind >= 3;
  static constexpr int FY = kKind == 3 ? 2 : 1;
  static constexpr int FX = kKind == 3 || kKind == 4 ? 2 : 1;
  static constexpr int kC = kChroma ? 2 : 1;       // components
  static constexpr int kTB = kTransforms / kC;     // blocks a tile row
  static constexpr int kBpp = kKind == 0 ? 1 : 3;  // bytes a pixel
  static constexpr int kRawRow = kTB * 8 * FX * kBpp;  // a pixel row
  static constexpr int kRawRows = 8 * FY;
  static constexpr int kRawBytes = kRawRows * kRawRow;
  // thread blocks an SM holds: 32-36 registers a thread, 40 for 4:2:0
  // (which spills at 32)
  static constexpr int kMinBlocks = kKind == 3 ? 6 : 7;
};

// The tile's pixels (rp) -> its samples, one row of 8 a thread: component
// c, row y of block j at samples + ((c * 8 + y) * kTB + j) * 8.
template <int kKind>
__device__ __forceinline__ void make_samples(const uint8_t* rp,
                                             float* samples, int int_mode) {
  using F = Front<kKind>;
  const int t = threadIdx.x;
  int px[8];
  if constexpr (!F::kChroma) {
    const int y = t >> 5, j = t & 31;
    if constexpr (kKind == 0) {
      unsigned w[2];
      load_words<1>(rp + y * F::kRawRow + j * 8, w);
#pragma unroll
      for (int x = 0; x < 8; ++x) px[x] = byte_at(w, x);
    } else {
      unsigned w[6];
      load_words<3>(rp + y * F::kRawRow + j * 24, w);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        px[x] = luma<kKind == 2>(byte_at(w, 3 * x), byte_at(w, 3 * x + 1),
                                 byte_at(w, 3 * x + 2));
      }
    }
    put_row(samples + (y * F::kTB + j) * 8, px, int_mode);
  } else {
    // the rounded mean of the FY x FX full-res pixels under each sample
    constexpr int kN = F::FY * F::FX;
    constexpr int kShift = kN == 4 ? 2 : kN == 2 ? 1 : 0;
    const int c = t >> 7, y = (t >> 4) & 7, j = t & 15;
    int sum[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) sum[x] = 0;
#pragma unroll
    for (int dy = 0; dy < F::FY; ++dy) {
      unsigned w[6 * F::FX];
      load_words<3 * F::FX>(
          rp + (F::FY * y + dy) * F::kRawRow + j * 24 * F::FX, w);
#pragma unroll
      for (int p = 0; p < 8 * F::FX; ++p) {
        const int rr = byte_at(w, 3 * p), g = byte_at(w, 3 * p + 1),
                  b = byte_at(w, 3 * p + 2);
        const int v = c == 0
            ? ((-11059 * rr - 21709 * g + 32768 * b + 32768) >> 16) + 128
            : ((32768 * rr - 27439 * g - 5329 * b + 32768) >> 16) + 128;
        sum[p / F::FX] += min(max(v, 0), 255);
      }
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) px[x] = (sum[x] + kN / 2) >> kShift;
    put_row(samples + ((c * 8 + y) * F::kTB + j) * 8, px, int_mode);
  }
}

// The transform: thread block (br, tile column) one tile. Out: component c's
// coefficient k of block (br, bc) at out[c * comp_stride + k * stride +
// br * nbw + bc].
template <int kKind>
__global__ void __launch_bounds__(kThreads, Front<kKind>::kMinBlocks)
transform_kernel(const uint8_t* __restrict__ img, int pw, int nbh, int nbw,
                 const int* __restrict__ quant,
                 const float* __restrict__ basis,
                 const int* __restrict__ basis_int, int int_mode,
                 int* __restrict__ out, size_t stride, size_t comp_stride) {
  using F = Front<kKind>;
  constexpr int kTB = F::kTB, kPitch = kTB + 1;
  constexpr int kCompStride = 64 * kPitch + (F::kC > 1 ? 16 : 0);
  constexpr int kStageFloats = F::kC * kCompStride;
  __shared__ __align__(16) uint8_t raw[F::kRawBytes];
  // the samples, then the levels staged over them
  __shared__ __align__(16) float samples[
      kStageFloats > kTransforms * 64 ? kStageFloats : kTransforms * 64];
  __shared__ Tables s;
  const int br = blockIdx.x, bc0 = blockIdx.y * kTB;
  const int n = min(kTB, nbw - bc0);
  const int t = threadIdx.x;
  load_tables(s, quant, basis, basis_int);
  stage_rows<F::kRawRows, F::kRawRow>(
      img + ((size_t)br * F::kRawRows * pw + (size_t)bc0 * 8 * F::FX) *
                F::kBpp,
      (size_t)pw * F::kBpp, n * 8 * F::FX * F::kBpp, raw);
  __syncthreads();
  make_samples<kKind>(raw, samples, int_mode);
  __syncthreads();
  // where this thread stores (lanes 16-31 of K3 store Cr)
  const int lane = t & 31, warp = t >> 5;
  const int sc = lane / kTB, sj = lane % kTB;
  int* dst = out + sc * comp_stride + (size_t)br * nbw + bc0 + sj +
             (size_t)warp * stride;
  const bool stores = sj < n;
  const int c = (t >> 3) / kTB, j = (t >> 3) % kTB, u = t & 7;
  int lv[8];
  if (j < n) {
    block_row(samples + (c * 8 * kTB + j) * 8, kTB * 8, u, s, int_mode, lv);
  }
  __syncthreads();  // every sample read: the stage goes over them
  int* stage = reinterpret_cast<int*>(samples);
  if (j < n) {
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      stage[c * kCompStride + s.zz[u * 8 + v] * kPitch + j] = lv[v];
    }
  }
  __syncthreads();
  if (!stores) return;
  constexpr int kWarps = kThreads / 32;
  const int* src = stage + sc * kCompStride + warp * kPitch + sj;
#pragma unroll
  for (int i = 0; i < 64 / kWarps; ++i) {
    dst[(size_t)i * kWarps * stride] = src[i * kWarps * kPitch];
  }
}

// nbh x nbw blocks (chroma blocks for K3) of the plane or image.
template <int kKind>
void launch(const uint8_t* img, int pw, int nbh, int nbw, const int* quant,
            const float* basis, const int* basis_int, int int_mode, int* out,
            cudaStream_t stream) {
  using F = Front<kKind>;
  if (nbh <= 0 || nbw <= 0) return;
  const size_t nb = (size_t)nbh * nbw;
  const dim3 tiles(nbh, (nbw + F::kTB - 1) / F::kTB);
  transform_kernel<kKind><<<tiles, kThreads, 0, stream>>>(
      img, pw, nbh, nbw, quant, basis, basis_int, int_mode, out, F::kC * nb,
      nb);
}

}  // namespace

extern "C" int jt_transform(const uint8_t* img, int ph, int pw,
                            const int* quant, const float* basis,
                            const int* basis_int, int int_mode, int* out,
                            cudaStream_t stream) {
  launch<0>(img, pw, ph / 8, pw / 8, quant, basis, basis_int, int_mode, out,
            stream);
  return (int)cudaGetLastError();
}

extern "C" int jt_transform_rgb_y(const uint8_t* rgb, int ph, int pw,
                                  const int* quant, const float* basis,
                                  const int* basis_int, int int_mode,
                                  int ref_luma, int* out,
                                  cudaStream_t stream) {
  if (ref_luma) {
    launch<2>(rgb, pw, ph / 8, pw / 8, quant, basis, basis_int, int_mode,
              out, stream);
  } else {
    launch<1>(rgb, pw, ph / 8, pw / 8, quant, basis, basis_int, int_mode,
              out, stream);
  }
  return (int)cudaGetLastError();
}

extern "C" int jt_transform_rgb_chroma(const uint8_t* rgb, int ph, int pw,
                                       int fy, int fx, const int* quant,
                                       const float* basis,
                                       const int* basis_int, int int_mode,
                                       int* out, cudaStream_t stream) {
  const int nbh = ph / (8 * fy), nbw = pw / (8 * fx);
  if (fy == 2 && fx == 2) {
    launch<3>(rgb, pw, nbh, nbw, quant, basis, basis_int, int_mode, out,
              stream);
  } else if (fy == 1 && fx == 2) {
    launch<4>(rgb, pw, nbh, nbw, quant, basis, basis_int, int_mode, out,
              stream);
  } else if (fy == 1 && fx == 1) {
    launch<5>(rgb, pw, nbh, nbw, quant, basis, basis_int, int_mode, out,
              stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Thread blocks of transform_kernel<kind> one SM holds (the runtime's
// occupancy calculator), or -1 on an error; launches nothing.
extern "C" int jt_transform_blocks_per_sm(int kind) {
  const void* kernels[] = {
      (const void*)transform_kernel<0>, (const void*)transform_kernel<1>,
      (const void*)transform_kernel<2>, (const void*)transform_kernel<3>,
      (const void*)transform_kernel<4>, (const void*)transform_kernel<5>};
  int n = 0;
  if (kind < 0 || kind > 5 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernels[kind],
                                                    kThreads, 0) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}
