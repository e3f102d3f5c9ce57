// K1, K2, K3: pixels -> quantized zigzag levels, one thread per 8x8 block.
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
// multiply-adds per block (16 per pixel), far below the card's float32
// rate. So the design is about memory access: a thread block stages a
// tile of 8 x 32 blocks (64 x 256 samples) in shared memory with
// coalesced 8-byte loads, computing the samples (luma, or subsampled
// chroma) while it loads, each thread transforms one block in registers
// against the 8x8 basis held in shared memory, and the levels are stored
// coefficient-major ([64, nb]), so each warp writes 32 consecutive blocks
// of one coefficient: 128 contiguous bytes. K2 and K3 read the caller's
// interleaved [PH, PW, 3] RGB: the TPU kernels' planar [3, PH, PW] input
// exists only because the TPU pads a minor axis of 3 to 128 lanes. The TPU
// kernels' block-diagonal bases, 0/1 box-sum matmuls and [G, 64, 8, 128]
// tiling have no place here.
//
// Float mode keeps the TPU kernel's arithmetic bit for bit where it is
// defined: each DCT pass is a sequential float32 FMA chain (the order of
// an XLA dot), s = f / q is an IEEE division (__fdiv_rn; this file must
// not be built with --use_fast_math), and the level is
// (int)(s +/- 0.5f) after a float32 add, rounding half away from zero.
// Int32 mode is exact integer arithmetic: 11-bit fixed-point basis,
// (x + 2^10) >> 11 after each pass, |level| = (2|f| + q) / (2q). The
// color conversion and the box filter are integer arithmetic in both
// modes; the TPU kernels do them in float32 on exact integers (sums below
// 2^24), which gives the same values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileBlockRows = 8;
constexpr int kTileBlockCols = 32;
constexpr int kThreads = kTileBlockRows * kTileBlockCols;  // one per block

using Tile = uint2[kTileBlockRows * 8][kTileBlockCols];

struct Tables {
  float t[64];   // float basis
  int ti[64];    // 11-bit fixed-point basis
  int q[64];     // quantization table, raster order
};

__device__ __forceinline__ void load_tables(Tables& s, const int* quant,
                                            const float* basis,
                                            const int* basis_int) {
  const int t = threadIdx.x;
  if (t < 64) {
    s.t[t] = basis[t];
    s.ti[t] = basis_int[t];
    s.q[t] = quant[t];
  }
}

// Transform the 8x8 block whose rows are tile[8 * lr + y][lc] (8 samples
// packed per uint2) and store its 64 zigzag levels at out[k * stride +
// col].
__device__ __forceinline__ void block_levels(const Tile& tile, int lr, int lc,
                                             const Tables& s, int int_mode,
                                             int* __restrict__ out,
                                             size_t stride, size_t col) {
  // zigzag position k -> raster index u * 8 + v
  constexpr int kZigzag[64] = {
      0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
      12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
      35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
      58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
  int px[8][8];
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    const uint2 v = tile[lr * 8 + y][lc];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      px[y][x] = (int)((v.x >> (8 * x)) & 0xFFu) - 128;
      px[y][x + 4] = (int)((v.y >> (8 * x)) & 0xFFu) - 128;
    }
  }

  int lv[64];  // raster u * 8 + v
  if (int_mode) {
    int y1[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += s.ti[u * 8 + k] * px[k][x];
        y1[u][x] = (acc + 1024) >> 11;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += y1[u][k] * s.ti[v * 8 + k];
        const int f = (acc + 1024) >> 11;
        const int q = s.q[u * 8 + v];
        const int mag = (2 * abs(f) + q) / (2 * q);
        lv[u * 8 + v] = f < 0 ? -mag : mag;
      }
    }
  } else {
    float y1[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          acc = __fmaf_rn(s.t[u * 8 + k], (float)px[k][x], acc);
        }
        y1[u][x] = acc;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          acc = __fmaf_rn(y1[u][k], s.t[v * 8 + k], acc);
        }
        const float sc = __fdiv_rn(acc, (float)s.q[u * 8 + v]);
        lv[u * 8 + v] =
            __float2int_rz(__fadd_rn(sc, sc >= 0.0f ? 0.5f : -0.5f));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 64; ++k) out[(size_t)k * stride + col] = lv[kZigzag[k]];
}

// Sample loaders for K1 and K2: the 8 samples of row py of block column
// bc, packed into a uint2 (sample x in byte x).
struct GrayLoader {
  const uint8_t* img;  // [ph, pw]
  int pw;
  __device__ __forceinline__ uint2 operator()(int py, int bc) const {
    return *reinterpret_cast<const uint2*>(img + (size_t)py * pw +
                                           (size_t)bc * 8);
  }
};

// Load n consecutive uint2 (8-byte aligned) as 2n words.
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

template <int N>
__device__ __forceinline__ int byte_at(const unsigned (&w)[N], int i) {
  return (int)((w[i >> 2] >> (8 * (i & 3))) & 0xFFu);
}

// Luma of interleaved RGB: JFIF 16-bit weights, or the reference's
// (77 R + 150 G + 29 B) >> 8 (kind "y_ref"). Both lie in [0, 255].
template <bool kRefLuma>
struct LumaLoader {
  const uint8_t* img;  // [ph, pw, 3]
  int pw;
  __device__ __forceinline__ uint2 operator()(int py, int bc) const {
    unsigned w[6];
    load_words<3>(img + ((size_t)py * pw + (size_t)bc * 8) * 3, w);
    unsigned out[2] = {0u, 0u};
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int r = byte_at(w, 3 * x), g = byte_at(w, 3 * x + 1),
                b = byte_at(w, 3 * x + 2);
      const int y = kRefLuma ? (77 * r + 150 * g + 29 * b) >> 8
                             : (19595 * r + 38470 * g + 7471 * b + 32768) >> 16;
      out[x >> 2] |= (unsigned)y << (8 * (x & 3));
    }
    return make_uint2(out[0], out[1]);
  }
};

template <class Loader>
__global__ void __launch_bounds__(kThreads)
transform_kernel(Loader load, int nbh, int nbw, const int* __restrict__ quant,
                 const float* __restrict__ basis,
                 const int* __restrict__ basis_int, int int_mode,
                 int* __restrict__ out) {
  __shared__ Tile tile;
  __shared__ Tables s;
  const int br0 = blockIdx.y * kTileBlockRows;
  const int bc0 = blockIdx.x * kTileBlockCols;
  const int t = threadIdx.x;
  load_tables(s, quant, basis, basis_int);
  for (int i = t; i < kTileBlockRows * 8 * kTileBlockCols; i += kThreads) {
    const int r = i / kTileBlockCols, c = i % kTileBlockCols;
    const int py = br0 * 8 + r, bc = bc0 + c;
    tile[r][c] = (py < nbh * 8 && bc < nbw) ? load(py, bc) : make_uint2(0u, 0u);
  }
  __syncthreads();

  const int lr = t / kTileBlockCols, lc = t % kTileBlockCols;
  const int br = br0 + lr, bc = bc0 + lc;
  if (br >= nbh || bc >= nbw) return;
  block_levels(tile, lr, lc, s, int_mode, out, (size_t)nbh * nbw,
               (size_t)br * nbw + bc);
}

// K3: the tile holds chroma samples, computed from the FY x FX full-res
// pixels under each one. nbh, nbw count chroma blocks.
template <int FY, int FX>
__global__ void __launch_bounds__(kThreads)
transform_rgb_chroma_kernel(const uint8_t* __restrict__ img, int pw, int nbh,
                            int nbw, const int* __restrict__ quant,
                            const float* __restrict__ basis,
                            const int* __restrict__ basis_int, int int_mode,
                            int* __restrict__ out) {
  constexpr int kN = FY * FX;
  constexpr int kShift = kN == 4 ? 2 : kN == 2 ? 1 : 0;
  __shared__ Tile tiles[2];  // Cb, Cr
  __shared__ Tables s;
  const int br0 = blockIdx.y * kTileBlockRows;
  const int bc0 = blockIdx.x * kTileBlockCols;
  const int t = threadIdx.x;
  load_tables(s, quant, basis, basis_int);
  for (int i = t; i < kTileBlockRows * 8 * kTileBlockCols; i += kThreads) {
    const int r = i / kTileBlockCols, c = i % kTileBlockCols;
    const int cy = br0 * 8 + r, bc = bc0 + c;
    unsigned pcb[2] = {0u, 0u}, pcr[2] = {0u, 0u};
    if (cy < nbh * 8 && bc < nbw) {
      int scb[8], scr[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) scb[x] = scr[x] = 0;
#pragma unroll
      for (int dy = 0; dy < FY; ++dy) {
        unsigned w[6 * FX];
        load_words<3 * FX>(
            img + ((size_t)(FY * cy + dy) * pw + (size_t)bc * 8 * FX) * 3, w);
#pragma unroll
        for (int p = 0; p < 8 * FX; ++p) {
          const int rr = byte_at(w, 3 * p), g = byte_at(w, 3 * p + 1),
                    b = byte_at(w, 3 * p + 2);
          const int cb = ((-11059 * rr - 21709 * g + 32768 * b + 32768) >> 16)
                         + 128;
          const int cr = ((32768 * rr - 27439 * g - 5329 * b + 32768) >> 16)
                         + 128;
          scb[p / FX] += min(max(cb, 0), 255);
          scr[p / FX] += min(max(cr, 0), 255);
        }
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        pcb[x >> 2] |= (unsigned)((scb[x] + kN / 2) >> kShift) << (8 * (x & 3));
        pcr[x >> 2] |= (unsigned)((scr[x] + kN / 2) >> kShift) << (8 * (x & 3));
      }
    }
    tiles[0][r][c] = make_uint2(pcb[0], pcb[1]);
    tiles[1][r][c] = make_uint2(pcr[0], pcr[1]);
  }
  __syncthreads();

  const int lr = t / kTileBlockCols, lc = t % kTileBlockCols;
  const int br = br0 + lr, bc = bc0 + lc;
  if (br >= nbh || bc >= nbw) return;
  const size_t nc = (size_t)nbh * nbw;
  const size_t blk = (size_t)br * nbw + bc;
#pragma unroll 1
  for (int comp = 0; comp < 2; ++comp) {
    block_levels(tiles[comp], lr, lc, s, int_mode, out, 2 * nc,
                 comp * nc + blk);
  }
}

dim3 grid_for(int nbh, int nbw) {
  return dim3((nbw + kTileBlockCols - 1) / kTileBlockCols,
              (nbh + kTileBlockRows - 1) / kTileBlockRows);
}

}  // namespace

extern "C" int jt_transform(const uint8_t* img, int ph, int pw,
                            const int* quant, const float* basis,
                            const int* basis_int, int int_mode, int* out,
                            cudaStream_t stream) {
  const int nbh = ph / 8, nbw = pw / 8;
  transform_kernel<<<grid_for(nbh, nbw), kThreads, 0, stream>>>(
      GrayLoader{img, pw}, nbh, nbw, quant, basis, basis_int, int_mode, out);
  return (int)cudaGetLastError();
}

extern "C" int jt_transform_rgb_y(const uint8_t* rgb, int ph, int pw,
                                  const int* quant, const float* basis,
                                  const int* basis_int, int int_mode,
                                  int ref_luma, int* out,
                                  cudaStream_t stream) {
  const int nbh = ph / 8, nbw = pw / 8;
  if (ref_luma) {
    transform_kernel<<<grid_for(nbh, nbw), kThreads, 0, stream>>>(
        LumaLoader<true>{rgb, pw}, nbh, nbw, quant, basis, basis_int,
        int_mode, out);
  } else {
    transform_kernel<<<grid_for(nbh, nbw), kThreads, 0, stream>>>(
        LumaLoader<false>{rgb, pw}, nbh, nbw, quant, basis, basis_int,
        int_mode, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int jt_transform_rgb_chroma(const uint8_t* rgb, int ph, int pw,
                                       int fy, int fx, const int* quant,
                                       const float* basis,
                                       const int* basis_int, int int_mode,
                                       int* out, cudaStream_t stream) {
  const int nbh = ph / (8 * fy), nbw = pw / (8 * fx);
  const dim3 grid = grid_for(nbh, nbw);
  if (fy == 2 && fx == 2) {
    transform_rgb_chroma_kernel<2, 2><<<grid, kThreads, 0, stream>>>(
        rgb, pw, nbh, nbw, quant, basis, basis_int, int_mode, out);
  } else if (fy == 1 && fx == 2) {
    transform_rgb_chroma_kernel<1, 2><<<grid, kThreads, 0, stream>>>(
        rgb, pw, nbh, nbw, quant, basis, basis_int, int_mode, out);
  } else if (fy == 1 && fx == 1) {
    transform_rgb_chroma_kernel<1, 1><<<grid, kThreads, 0, stream>>>(
        rgb, pw, nbh, nbw, quant, basis, basis_int, int_mode, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
