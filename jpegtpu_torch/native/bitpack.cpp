// Native host bitstream runtime for jpegtpu_torch (counterpart of
// jpegtpu/native/bitpack.cpp, the entries this package uses).
//
// The card hands back a packed MSB-first word stream (or one buffer of
// byte-aligned restart segments) that needs only 0xFF byte stuffing and
// RST markers; that serial, byte-granular finish runs here at memory
// speed, as does the BMP pixel pass.
//
// Build: g++ -O3 -shared -fPIC (driven by jpegtpu_torch/native/__init__.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

// Byte b of an MSB-first stream held in host-order uint32 words.
static inline uint8_t stream_byte(const uint32_t* words, int64_t b) {
  return static_cast<uint8_t>(words[b >> 2] >> (24 - 8 * (b & 3)));
}

static inline size_t put_stuffed(uint8_t v, uint8_t* out, size_t o) {
  out[o++] = v;
  if (v == 0xFF) out[o++] = 0;
  return o;
}

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
// 8 stream bytes, the first in the low byte -> out from o, stuffed; a
// chunk that holds a 0xFF goes a byte at a time and adds 1 to *slow.
static inline size_t stuff_chunk(uint64_t s, uint8_t* out, size_t o,
                                 int64_t* slow) {
  constexpr uint64_t kOnes = 0x0101010101010101ull;
  constexpr uint64_t kHighs = 0x8080808080808080ull;
  // s holds a 0xFF byte exactly where ~s holds a zero byte
  if (((~s) - kOnes) & s & kHighs) {
    ++*slow;
    for (int k = 0; k < 8; ++k)
      o = put_stuffed(static_cast<uint8_t>(s >> (8 * k)), out, o);
    return o;
  }
  memcpy(out + o, &s, 8);
  return o + 8;
}
#endif

// Stuffs bytes [b, end) of an MSB-first word stream into out from o and
// returns the new output length. From the first word boundary on, the
// bytes go in 8-byte chunks (two words, put in stream order by a byte
// swap): a chunk with no 0xFF is stored whole, one with a 0xFF byte by
// byte. With SSE2 (predefined on every x86-64 compiler) two chunks are
// swapped and tested at once. counts (null: not counted) gains the
// chunks in [0] and those that held a 0xFF in [1]. The swap assumes a
// little-endian host; elsewhere every byte goes by the byte path.
static inline size_t stuff_span(const uint32_t* words, int64_t b, int64_t end,
                                uint8_t* out, size_t o, int64_t* counts) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  while (b < end && (b & 3)) o = put_stuffed(stream_byte(words, b++), out, o);
  const int64_t first = b;
  int64_t slow = 0;
#if defined(__SSE2__)
  const __m128i ff = _mm_set1_epi8(-1);
  for (; b + 16 <= end; b += 16) {
    __m128i x =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(words + (b >> 2)));
    x = _mm_or_si128(_mm_slli_epi16(x, 8), _mm_srli_epi16(x, 8));
    x = _mm_shufflehi_epi16(_mm_shufflelo_epi16(x, 0xB1), 0xB1);
    if (_mm_movemask_epi8(_mm_cmpeq_epi8(x, ff)) == 0) {
      _mm_storeu_si128(reinterpret_cast<__m128i*>(out + o), x);
      o += 16;
    } else {
      uint64_t s[2];
      _mm_storeu_si128(reinterpret_cast<__m128i*>(s), x);
      o = stuff_chunk(s[0], out, o, &slow);
      o = stuff_chunk(s[1], out, o, &slow);
    }
  }
#endif
  for (; b + 8 <= end; b += 8) {
    uint64_t x;
    memcpy(&x, words + (b >> 2), 8);
    x = __builtin_bswap64(x);
    o = stuff_chunk((x >> 32) | (x << 32), out, o, &slow);
  }
  if (counts) {
    counts[0] += (b - first) / 8;
    counts[1] += slow;
  }
#else
  (void)counts;
#endif
  while (b < end) o = put_stuffed(stream_byte(words, b++), out, o);
  return o;
}

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
// 2 * ceil(total_bits/8). `counts` as stuff_span's. Returns the stuffed
// length.
size_t jt_words_to_stuffed(const uint32_t* words, int64_t total_bits,
                           uint8_t* out, int64_t* counts) {
  return stuff_span(words, 0, (total_bits + 7) / 8, out, 0, counts);
}

// Full restart-marker scan from ONE stitched word buffer: the buffer holds
// byte-aligned segments back to back (entropy/stitch.py); emit
// stuff(seg_0) RST stuff(seg_1) RST ... in one pass. The marker after
// segment s is FFD0 + ((rst_phase + s) & 7); none follows the last
// segment unless `trailing` (a scan continued by another buffer, as a
// shard's segments are by the next shard's). seg_bytes[s] = segment byte
// length. Words are host-order uint32, bytes MSB-first (as
// jt_words_to_stuffed). `out` must hold 2 * sum(seg_bytes) + 2 * n_seg.
// `counts` as stuff_span's, summed over the segments. Returns the output
// length.
size_t jt_scan_from_words(const uint32_t* words, const int64_t* seg_bytes,
                          int64_t n_seg, int rst_phase, int trailing,
                          uint8_t* out, int64_t* counts) {
  size_t o = 0;
  int64_t b = 0;  // global byte cursor into the word buffer
  for (int64_t s = 0; s < n_seg; ++s) {
    o = stuff_span(words, b, b + seg_bytes[s], out, o, counts);
    b += seg_bytes[s];
    if (s + 1 < n_seg || trailing) {
      out[o++] = 0xFF;
      out[o++] = static_cast<uint8_t>(0xD0 + ((rst_phase + s) & 7));
    }
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
