// K1: uint8 plane -> quantized zigzag levels, one thread per 8x8 block.
//
// Replaces jpegtpu/ops/pallas_transform.py: transform_plane_raw
// (_make_transform_kernel / _dct_store_f32, and _make_transform_kernel_int
// / _dct_store_int in int32 mode).
//
// Bound: bytes. 1 byte of pixels in and 4 bytes of int32 levels out per
// pixel; the DCT is 1,024 multiply-adds per block (16 per pixel), far
// below the card's float32 rate. So the design is about memory access:
// a thread block stages a tile of 8 x 32 blocks (64 x 256 pixels) in
// shared memory with coalesced 8-byte loads, each thread transforms one
// block in registers against the 8x8 basis held in shared memory, and
// the levels are stored coefficient-major ([64, nb]), so each warp writes
// 32 consecutive blocks of one coefficient: 128 contiguous bytes. The TPU
// kernel's block-diagonal 64x64 / 128x128 bases and its [G, 64, 8, 128]
// tiling have no place here.
//
// Float mode keeps the TPU kernel's arithmetic bit for bit where it is
// defined: each DCT pass is a sequential float32 FMA chain (the order of
// an XLA dot), s = f / q is an IEEE division (__fdiv_rn; this file must
// not be built with --use_fast_math), and the level is
// (int)(s +/- 0.5f) after a float32 add, rounding half away from zero.
// Int32 mode is exact integer arithmetic: 11-bit fixed-point basis,
// (x + 2^10) >> 11 after each pass, |level| = (2|f| + q) / (2q).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileBlockRows = 8;
constexpr int kTileBlockCols = 32;
constexpr int kThreads = kTileBlockRows * kTileBlockCols;  // one per block

__global__ void __launch_bounds__(kThreads)
transform_kernel(const uint8_t* __restrict__ img, int ph, int pw,
                 const int* __restrict__ quant,
                 const float* __restrict__ basis,
                 const int* __restrict__ basis_int, int int_mode,
                 int* __restrict__ out) {
  // zigzag position k -> raster index u * 8 + v
  constexpr int kZigzag[64] = {
      0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
      12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
      35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
      58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
  __shared__ uint2 tile[kTileBlockRows * 8][kTileBlockCols];
  __shared__ float s_t[64];
  __shared__ int s_ti[64];
  __shared__ int s_q[64];

  const int nbh = ph / 8, nbw = pw / 8;
  const int br0 = blockIdx.y * kTileBlockRows;
  const int bc0 = blockIdx.x * kTileBlockCols;
  const int t = threadIdx.x;
  if (t < 64) {
    s_t[t] = basis[t];
    s_ti[t] = basis_int[t];
    s_q[t] = quant[t];
  }
  for (int i = t; i < kTileBlockRows * 8 * kTileBlockCols; i += kThreads) {
    const int r = i / kTileBlockCols, c = i % kTileBlockCols;
    const int py = br0 * 8 + r, bc = bc0 + c;
    uint2 v = make_uint2(0u, 0u);
    if (py < ph && bc < nbw) {
      v = *reinterpret_cast<const uint2*>(img + (size_t)py * pw +
                                          (size_t)bc * 8);
    }
    tile[r][c] = v;
  }
  __syncthreads();

  const int lr = t / kTileBlockCols, lc = t % kTileBlockCols;
  const int br = br0 + lr, bc = bc0 + lc;
  if (br >= nbh || bc >= nbw) return;
  const size_t nb = (size_t)nbh * nbw;
  const size_t blk = (size_t)br * nbw + bc;

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
        for (int k = 0; k < 8; ++k) acc += s_ti[u * 8 + k] * px[k][x];
        y1[u][x] = (acc + 1024) >> 11;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += y1[u][k] * s_ti[v * 8 + k];
        const int f = (acc + 1024) >> 11;
        const int q = s_q[u * 8 + v];
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
          acc = __fmaf_rn(s_t[u * 8 + k], (float)px[k][x], acc);
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
          acc = __fmaf_rn(y1[u][k], s_t[v * 8 + k], acc);
        }
        const float s = __fdiv_rn(acc, (float)s_q[u * 8 + v]);
        lv[u * 8 + v] = __float2int_rz(__fadd_rn(s, s >= 0.0f ? 0.5f : -0.5f));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 64; ++k) out[(size_t)k * nb + blk] = lv[kZigzag[k]];
}

}  // namespace

extern "C" int jt_transform(const uint8_t* img, int ph, int pw,
                            const int* quant, const float* basis,
                            const int* basis_int, int int_mode, int* out,
                            cudaStream_t stream) {
  const int nbh = ph / 8, nbw = pw / 8;
  const dim3 grid((nbw + kTileBlockCols - 1) / kTileBlockCols,
                  (nbh + kTileBlockRows - 1) / kTileBlockRows);
  transform_kernel<<<grid, kThreads, 0, stream>>>(img, ph, pw, quant, basis,
                                                  basis_int, int_mode, out);
  return (int)cudaGetLastError();
}
