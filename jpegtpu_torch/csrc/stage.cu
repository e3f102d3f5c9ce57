// K13 stage_images: uint8 images already on the card -> one edge-padded
// stack [B * ph, pw, C], the input of K1 (C = 1) or of K2 and K3 (C = 3).
//
//   out[b, y, x, c] = img_b[min(y, h_b - 1), min(x, w_b - 1), c]
//
// is np.pad(mode="edge") of each image to ph x pw, with a 2-D image into
// three channels repeated to each (its channel stride is 0). jpegtpu pads
// on the host before its upload, so this kernel has no TPU counterpart.
//
// Each image is read through its own pointer, height, width and byte
// strides (a row, a pixel, a channel), so any strided view is read in
// place: an interleaved [H, W, 3] tensor, a decoder's planar [3, H, W]
// tensor permuted to [H, W, 3], a crop. The table of up to kMaxImages
// images is a __grid_constant__ kernel parameter: the launch carries it,
// with no copy to the card and no host wait.
//
// A thread block fills one output row; each thread writes 8 output bytes
// at a time with one 8-byte store, so a warp stores 256 contiguous bytes
// whatever the source's layout. Its loads are single bytes from the
// clamped source row; the warp's loads of one store round touch a few
// sectors of each source plane, which L1 keeps for the next byte.
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxImages = 64;  // images one launch's table holds
constexpr int kThreads = 256;

struct Image {
  const unsigned char* pixels;
  long long sy, sx, sc;  // byte strides of a row, a pixel, a channel
  int h, w;
};

struct Table {
  Image im[kMaxImages];
};

template <int C>
__global__ void __launch_bounds__(kThreads)
    stage_images_kernel(const __grid_constant__ Table t, int ph, int pw,
                        unsigned char* out) {
  const int row = blockIdx.x;  // b * ph + y
  const int b = row / ph;
  const Image& im = t.im[b];
  const int y = min(row - b * ph, im.h - 1);
  const unsigned char* src = im.pixels + y * im.sy;
  const int last = im.w - 1;
  const long long sx = im.sx, sc = im.sc;
  const int units = pw * C / 8;  // pw is a multiple of 8
  uint2* dst = reinterpret_cast<uint2*>(out + (long long)row * pw * C);
  for (int u = threadIdx.x; u < units; u += kThreads) {
    unsigned half[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 8 * u + j;
      const int x = k / C;
      const int c = k - x * C;
      const unsigned v = src[min(x, last) * sx + c * sc];
      half[j >> 2] |= v << (8 * (j & 3));
    }
    dst[u] = make_uint2(half[0], half[1]);
  }
}

}  // namespace

// Stage the n Image entries at `images` (n <= 64; a plain pointer, as a
// parameter of a type in the unnamed namespace would give this entry
// internal linkage) into out [n * ph, pw, c] (c 1 or 3; pw a multiple of
// 8; every image within ph x pw, of at least one pixel); returns
// cudaGetLastError().
extern "C" int jt_stage_images(const void* images, int n, int ph, int pw,
                               int c, unsigned char* out,
                               cudaStream_t stream) {
  if (n < 0 || n > kMaxImages || ph < 1 || pw < 1 || pw % 8) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  Table t;
  memcpy(t.im, images, n * sizeof(Image));
  if (c == 3) {
    stage_images_kernel<3><<<n * ph, kThreads, 0, stream>>>(t, ph, pw, out);
  } else if (c == 1) {
    stage_images_kernel<1><<<n * ph, kThreads, 0, stream>>>(t, ph, pw, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
