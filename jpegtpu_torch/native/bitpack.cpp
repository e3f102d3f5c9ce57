// Native host bitstream runtime for jpegtpu_torch (counterpart of
// jpegtpu/native/bitpack.cpp, the entries this package uses).
//
// The card hands back a packed MSB-first word stream that needs only
// 0xFF byte stuffing; that serial, byte-granular finish runs here at
// memory speed, as does the BMP pixel pass.
//
// Build: g++ -O3 -shared -fPIC (driven by jpegtpu_torch/native/__init__.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// 0xFF -> 0xFF 0x00 byte stuffing. `out` must hold 2*n bytes. Returns the
// stuffed length.
size_t jt_stuff_bytes(const uint8_t* in, size_t n, uint8_t* out) {
  size_t o = 0;
  size_t i = 0;
  while (i < n) {
    const uint8_t* ff =
        static_cast<const uint8_t*>(memchr(in + i, 0xFF, n - i));
    if (!ff) {
      memcpy(out + o, in + i, n - i);
      o += n - i;
      break;
    }
    size_t run = static_cast<size_t>(ff - (in + i));
    memcpy(out + o, in + i, run);
    o += run;
    out[o++] = 0xFF;
    out[o++] = 0x00;
    i += run + 1;
  }
  return o;
}

// Big-endian uint32 word stream (MSB-aligned bitstream of `total_bits`
// bits, already byte-padded) -> stuffed bytes. `words` holds host-order
// uint32; bytes go out MSB-first per word. `out` must hold
// 2 * ceil(total_bits/8). Returns the stuffed length.
size_t jt_words_to_stuffed(const uint32_t* words, int64_t total_bits,
                           uint8_t* out) {
  size_t nbytes = static_cast<size_t>((total_bits + 7) / 8);
  size_t o = 0;
  size_t full = nbytes / 4;
  for (size_t wi = 0; wi < full; ++wi) {
    uint32_t w = words[wi];
    uint8_t b0 = static_cast<uint8_t>(w >> 24);
    uint8_t b1 = static_cast<uint8_t>(w >> 16);
    uint8_t b2 = static_cast<uint8_t>(w >> 8);
    uint8_t b3 = static_cast<uint8_t>(w);
    out[o++] = b0;
    if (b0 == 0xFF) out[o++] = 0;
    out[o++] = b1;
    if (b1 == 0xFF) out[o++] = 0;
    out[o++] = b2;
    if (b2 == 0xFF) out[o++] = 0;
    out[o++] = b3;
    if (b3 == 0xFF) out[o++] = 0;
  }
  for (size_t bi = full * 4; bi < nbytes; ++bi) {
    uint8_t b = static_cast<uint8_t>(words[bi / 4] >> (24 - 8 * (bi % 4)));
    out[o++] = b;
    if (b == 0xFF) out[o++] = 0;
  }
  return o;
}

// BMP pixel block -> RGB [H, W, 3]: row flip (bottom-up default) and
// BGR->RGB swizzle in one pass. Header parsing and validation stay in
// io/bmp.py; this moves only the O(pixels) work.
void jt_bmp_to_rgb(const uint8_t* px, int64_t height, int64_t width,
                   int64_t row_stride, int top_down, uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = px + (top_down ? y : height - 1 - y) * row_stride;
    uint8_t* dst = out + y * width * 3;
    for (int64_t x = 0; x < width; ++x) {
      dst[3 * x + 0] = src[3 * x + 2];
      dst[3 * x + 1] = src[3 * x + 1];
      dst[3 * x + 2] = src[3 * x + 0];
    }
  }
}

}  // extern "C"
