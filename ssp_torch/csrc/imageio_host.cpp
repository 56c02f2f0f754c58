// Grayscale image decoding on the host, without OpenCV, libjpeg or libpng.
//
// What ``cv2.imread(path, IMREAD_GRAYSCALE)`` returns, byte for byte, and
// an image exactly when it returns one (OpenCV 5.0 on libjpeg-turbo 3.1,
// with its x86 SIMD code, and libpng 1.6.58):
//
// * JPEG, as libjpeg-turbo decodes it for OpenCV: the markers through
//   jdmarker.c's reader (extraneous bytes skipped, reserved markers and bad
//   segments fatal) over the file as jdatasrc.c hands it on (fake EOI
//   markers past its end).  Huffman-coded sequential (SOF0, SOF1; a missing
//   table 0 or 1 is the standard's) and progressive (SOF2, jdphuff.c);
//   arithmetic-coded sequential and progressive (SOF9, SOF10, jdarith.c: the
//   QM decoder of T.81 Annex D, DAC conditioning); lossless (SOF3,
//   jddiffct.c, jdlhuff.c, jdlossls.c: predictors 1-7, point transform,
//   2- to 8-bit samples, gray or CMYK).  Restart intervals, with
//   jpeg_resync_to_restart's recovery.  1, 3 or 4 components; the colour
//   space is libjpeg's guess (jdapimin.c): gray, YCbCr, RGB (Adobe
//   transform 0, ids R, G, B, or ids 1, 2, 3 of a lossless file), CMYK or
//   YCCK.  Gray output needs Y alone of YCbCr and every component of the
//   rest.  A file of several scans (libjpeg's has_multiple_scans) is held as
//   coefficients until its EOI, and a progressive one smoothed where
//   libjpeg-turbo smooths (jdcoefct.c decompress_smooth_data, the 5×5
//   estimate); a file of one scan is decoded as it is read, and what follows
//   its data is not.  Data that runs out, or a bad code, is what jdhuff.c
//   makes of it (zero bits to the end of the MCU, the scan's later MCUs
//   skipped up to a restart; symbol 0) and jdarith.c (zero bytes; an
//   overflow stops the scan up to a restart).  Each needed component goes
//   through libjpeg-turbo's ``jpeg_idct_islow`` as its SIMD code computes
//   it, its upsampling (jdsample.c: h2v1, h1v2, h2v2 triangle filters,
//   integral replication; replication alone in a lossless file) and colour
//   conversion (jdcolor.c: RGB → Y in 16-bit fixed point, YCCK → CMYK),
//   CMYK through OpenCV's CMYK → gray.  The EXIF orientation of APP1 is
//   applied afterwards, as OpenCV does.  Refused, each with a message naming
//   it, as libjpeg or OpenCV refuses them: 12-bit JPEG, 12- to 16-bit
//   lossless JPEG, SOF11, hierarchical JPEG, lossless JPEG in RGB, YCbCr or
//   YCCK, 2 or 5-10 components, fractional sampling and MCUs of more than
//   10 blocks, a height of 0 (DNL), and header damage that libjpeg finds
//   fatal.
// * PNG rows after inflate (the caller inflates): the five filters undone,
//   pass by pass for Adam7, then libpng's conversions as OpenCV requests
//   them: gray bit depths below 8 expanded, 16-bit samples cut to their high
//   byte, alpha dropped, palette to RGB, and RGB to gray in libpng's 15-bit
//   fixed point, (9797 R + 19234 G + 3737 B) >> 15, truncated (16-bit:
//   rounded at 16 bits first); with a file gamma through libpng's gamma
//   tables (``PngGamma``).
//
// Integer arithmetic, except libpng's gamma tables, which libpng computes
// with pow() in double.  A plain C interface for ctypes; each entry point
// returns 0, or -1 with a message naming what is not supported or what is
// wrong in ``msg``.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw DecodeError{what}; }

int report(const std::string& what, char* msg, int cap) {
  if (msg != nullptr && cap > 0) std::snprintf(msg, static_cast<size_t>(cap), "%s", what.c_str());
  return -1;
}

// ---- EXIF orientation --------------------------------------------------------

// The Orientation tag (0x0112) of IFD0 of a TIFF-structured EXIF block
// ("Exif\0\0" prefix optional); 1 where it is absent or malformed.
int exif_orientation(const uint8_t* p, size_t n) {
  if (n >= 6 && std::memcmp(p, "Exif\0\0", 6) == 0) {
    p += 6;
    n -= 6;
  }
  if (n < 8) return 1;
  bool le;
  if (p[0] == 'I' && p[1] == 'I') {
    le = true;
  } else if (p[0] == 'M' && p[1] == 'M') {
    le = false;
  } else {
    return 1;
  }
  auto u16 = [&](size_t o) -> uint32_t {
    return le ? (p[o] | (p[o + 1] << 8)) : ((p[o] << 8) | p[o + 1]);
  };
  auto u32 = [&](size_t o) -> uint32_t {
    return le ? (p[o] | (p[o + 1] << 8) | (p[o + 2] << 16) | (uint32_t(p[o + 3]) << 24))
              : ((uint32_t(p[o]) << 24) | (p[o + 1] << 16) | (p[o + 2] << 8) | p[o + 3]);
  };
  if (u16(2) != 42) return 1;
  size_t ifd = u32(4);
  if (ifd + 2 > n) return 1;
  size_t count = u16(ifd);
  for (size_t i = 0; i < count; ++i) {
    size_t e = ifd + 2 + 12 * i;
    if (e + 12 > n) return 1;
    if (u16(e) == 0x0112) {
      uint32_t type = u16(e + 2);
      uint32_t v = type == 3 ? u16(e + 8) : type == 4 ? u32(e + 8) : 0;
      return (v >= 1 && v <= 8) ? static_cast<int>(v) : 1;
    }
  }
  return 1;
}

// Output shape of an [h, w] plane shown with ``orientation``.
void oriented_shape(int orientation, int h, int w, int* oh, int* ow) {
  bool t = orientation >= 5;
  *oh = t ? w : h;
  *ow = t ? h : w;
}

// out[oh, ow] = the plane src[h, w] (row stride ``stride``) as OpenCV shows an
// image with this EXIF orientation: 2 flip left-right, 3 rotate 180, 4 flip
// top-bottom, 5 transpose, 6 transpose then flip left-right (90° clockwise),
// 7 transpose then rotate 180, 8 transpose then flip top-bottom.
void orient(const uint8_t* src, size_t stride, int h, int w, int orientation, uint8_t* out) {
  int oh, ow;
  oriented_shape(orientation, h, w, &oh, &ow);
  for (int i = 0; i < oh; ++i) {
    uint8_t* row = out + static_cast<size_t>(i) * ow;
    for (int j = 0; j < ow; ++j) {
      int y, x;
      switch (orientation) {
        case 2: y = i; x = w - 1 - j; break;
        case 3: y = h - 1 - i; x = w - 1 - j; break;
        case 4: y = h - 1 - i; x = j; break;
        case 5: y = j; x = i; break;
        case 6: y = h - 1 - j; x = i; break;
        case 7: y = h - 1 - j; x = w - 1 - i; break;
        case 8: y = j; x = w - 1 - i; break;
        default: y = i; x = j; break;
      }
      row[j] = src[static_cast<size_t>(y) * stride + x];
    }
  }
}

// ---- JPEG ---------------------------------------------------------------------

// Zigzag position → natural (row-major) position, with 16 extra entries so
// that a corrupt run past the block's end lands on its last coefficient, as
// libjpeg's jpeg_natural_order does.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

// jidctint.c's fixed point: 13 fraction bits, 2 more kept between the passes
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t kFix0_298631336 = 2446, kFix0_390180644 = 3196, kFix0_541196100 = 4433,
                  kFix0_765366865 = 6270, kFix0_899976223 = 7373, kFix1_175875602 = 9633,
                  kFix1_501321110 = 12299, kFix1_847759065 = 15137, kFix1_961570560 = 16069,
                  kFix2_053119869 = 16819, kFix2_562915447 = 20995, kFix3_072711026 = 25172;

// The standard's Huffman tables (K.3 of ITU-T T.81), which libjpeg-turbo
// (jstdhuff.c) puts in place of a table 0 or 1 that a sequential scan names and
// no DHT has defined (motion-JPEG frames carry none).
const uint8_t kStdDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdDcChrBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdDcVal[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
const uint8_t kStdAcLumVal[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChrBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
const uint8_t kStdAcChrVal[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// T.81 Table D.2, the QM coder's probability estimation (jaritab.c): Qe,
// the next state after a less and after a more probable symbol, and
// whether a less probable one swaps the sense of the more probable.  State
// 113 is a fixed estimate of one half (T.851), for signs and refinement bits.
struct QmState {
  uint16_t qe;
  uint8_t nlps, nmps, swap;
};
const QmState kQm[114] = {
    {0x5a1d, 1, 1, 1}, {0x2586, 14, 2, 0}, {0x1114, 16, 3, 0}, {0x080b, 18, 4, 0},
    {0x03d8, 20, 5, 0}, {0x01da, 23, 6, 0}, {0x00e5, 25, 7, 0}, {0x006f, 28, 8, 0},
    {0x0036, 30, 9, 0}, {0x001a, 33, 10, 0}, {0x000d, 35, 11, 0}, {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0}, {0x0001, 12, 13, 0}, {0x5a7f, 15, 15, 1}, {0x3f25, 36, 16, 0},
    {0x2cf2, 38, 17, 0}, {0x207c, 39, 18, 0}, {0x17b9, 40, 19, 0}, {0x1182, 42, 20, 0},
    {0x0cef, 43, 21, 0}, {0x09a1, 45, 22, 0}, {0x072f, 46, 23, 0}, {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0}, {0x0303, 51, 26, 0}, {0x0240, 52, 27, 0}, {0x01b1, 54, 28, 0},
    {0x0144, 56, 29, 0}, {0x00f5, 57, 30, 0}, {0x00b7, 59, 31, 0}, {0x008a, 60, 32, 0},
    {0x0068, 62, 33, 0}, {0x004e, 63, 34, 0}, {0x003b, 32, 35, 0}, {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1}, {0x484c, 64, 38, 0}, {0x3a0d, 65, 39, 0}, {0x2ef1, 67, 40, 0},
    {0x261f, 68, 41, 0}, {0x1f33, 69, 42, 0}, {0x19a8, 70, 43, 0}, {0x1518, 72, 44, 0},
    {0x1177, 73, 45, 0}, {0x0e74, 74, 46, 0}, {0x0bfb, 75, 47, 0}, {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0}, {0x0706, 79, 50, 0}, {0x05cd, 48, 51, 0}, {0x04de, 50, 52, 0},
    {0x040f, 50, 53, 0}, {0x0363, 51, 54, 0}, {0x02d4, 52, 55, 0}, {0x025c, 53, 56, 0},
    {0x01f8, 54, 57, 0}, {0x01a4, 55, 58, 0}, {0x0160, 56, 59, 0}, {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0}, {0x00cb, 59, 62, 0}, {0x00ab, 61, 63, 0}, {0x008f, 61, 32, 0},
    {0x5b12, 65, 65, 1}, {0x4d04, 80, 66, 0}, {0x412c, 81, 67, 0}, {0x37d8, 82, 68, 0},
    {0x2fe8, 83, 69, 0}, {0x293c, 84, 70, 0}, {0x2379, 86, 71, 0}, {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0}, {0x174e, 72, 74, 0}, {0x1424, 72, 75, 0}, {0x119c, 74, 76, 0},
    {0x0f6b, 74, 77, 0}, {0x0d51, 75, 78, 0}, {0x0bb6, 77, 79, 0}, {0x0a40, 77, 48, 0},
    {0x5832, 80, 81, 1}, {0x4d1c, 88, 82, 0}, {0x438e, 89, 83, 0}, {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0}, {0x2eae, 92, 86, 0}, {0x299a, 93, 87, 0}, {0x2516, 86, 71, 0},
    {0x5570, 88, 89, 1}, {0x4ca9, 95, 90, 0}, {0x44d9, 96, 91, 0}, {0x3e22, 97, 92, 0},
    {0x3824, 99, 93, 0}, {0x32b4, 99, 94, 0}, {0x2e17, 93, 86, 0}, {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0}, {0x47e5, 102, 98, 0}, {0x41cf, 103, 99, 0}, {0x3c3d, 104, 100, 0},
    {0x375e, 99, 93, 0}, {0x5231, 105, 102, 0}, {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0},
    {0x415e, 103, 99, 0}, {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1}, {0x5522, 112, 109, 0},
    {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};

// A Huffman table as a DHT segment defines it.
struct HuffSpec {
  bool defined = false;
  uint8_t bits[16] = {};  // codes of each length 1-16
  uint8_t vals[256] = {};
};

// A Huffman table ready to decode with (jdhuff.c jpeg_make_d_derived_tbl).
struct Huffman {
  uint8_t look_len[1 << kLookBits];  // 0: the code is longer than kLookBits
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoff[18];
  uint8_t vals[256];

  // libjpeg's checks: the counts fit the code space with no code of all
  // ones; a DC table's symbols are at most 15 (16 in a lossless scan).
  void build(const HuffSpec& spec, bool dc, bool lossless) {
    std::memcpy(vals, spec.vals, sizeof(vals));
    std::memset(look_len, 0, sizeof(look_len));
    int total = 0, last = 0;
    for (int len = 1; len <= 16; ++len) {
      total += spec.bits[len - 1];
      if (spec.bits[len - 1]) last = len;
    }
    if (total > 256) fail("corrupt JPEG: bad Huffman table");
    int32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoff[len] = k - code;
      for (int i = 0; i < spec.bits[len - 1]; ++i, ++k, ++code) {
        if (code >= (1 << len)) fail("corrupt JPEG: bad Huffman table");
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int f = 0; f < (1 << shift); ++f) {
            look_len[(code << shift) | f] = static_cast<uint8_t>(len);
            look_sym[(code << shift) | f] = vals[k];
          }
        }
      }
      if (len <= last && code >= (1 << len)) fail("corrupt JPEG: bad Huffman table");
      maxcode[len] = spec.bits[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    if (dc)
      for (int i = 0; i < total; ++i)
        if (vals[i] > (lossless ? 16 : 15)) fail("corrupt JPEG: bad Huffman table");
  }
};

// The file as libjpeg's stdio source manager (jdatasrc.c) hands it on: its
// bytes, then a fake EOI marker (FF D9) each time more is asked for.
// ``unread`` is the code of a marker met and not yet acted on (jdmarker.c's
// unread_marker, 0: none).
struct Stream {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int unread = 0;

  Stream(const uint8_t* data, size_t size) : d(data), n(size) {}

  int byte() {
    if (pos < n) return d[pos++];
    return (pos++ - n) & 1 ? 0xD9 : 0xFF;
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(long k) {
    if (k > 0) pos += static_cast<size_t>(k);
  }
  // jdmarker.c next_marker: past any bytes that are not a marker
  // (extraneous data, FF 00 pairs), to the next FF xx; FF fill is skipped.
  void next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) {
        unread = c;
        return;
      }
    }
  }
  // jdmarker.c read_restart_marker: the expected RSTn is taken; another
  // marker goes to jpeg_resync_to_restart, which skips markers < SOF0 and
  // the two restarts before the expected one, leaves a non-restart marker
  // or one of the next two restarts unread (the interval is then empty),
  // and takes any other restart as the expected one.
  void read_restart_marker(int* next) {
    if (!unread) next_marker();
    const int want = *next;
    if (unread == 0xD0 + want) {
      unread = 0;
    } else {
      for (;;) {
        const int m = unread;
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((want + 1) & 7) || m == 0xD0 + ((want + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((want - 1) & 7) || m == 0xD0 + ((want - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) unread = 0;
        if (action != 2) break;
        next_marker();
      }
    }
    *next = (want + 1) & 7;
  }
};

// The entropy-coded segment's bits for Huffman decoding (jdhuff.c
// jpeg_fill_bit_buffer): byte stuffing (FF 00) undone, FF fill skipped; at
// a marker (or the fake EOI past the end) zero bits are fed, and counted,
// so that a read that took them (libjpeg's insufficient_data) is seen.
struct BitReader {
  Stream& s;
  uint64_t acc = 0;
  int cnt = 0;
  int64_t fake = 0;

  explicit BitReader(Stream& stream) : s(stream) {}

  void fill() {
    // the bytes of the file, while no FF comes
    while (cnt <= 56 && !s.unread && s.pos < s.n && s.d[s.pos] != 0xFF) {
      acc = (acc << 8) | s.d[s.pos++];
      cnt += 8;
    }
    while (cnt <= 56) {
      uint32_t b = 0;
      if (s.unread) {
        fake += 8;
      } else {
        b = static_cast<uint32_t>(s.byte());
        if (b == 0xFF) {
          int c;
          do {
            c = s.byte();
          } while (c == 0xFF);
          if (c != 0) {
            s.unread = c;
            b = 0;
            fake += 8;
          }
        }
      }
      acc = (acc << 8) | b;
      cnt += 8;
    }
  }
  uint32_t peek(int k) {
    if (cnt < k) fill();
    return static_cast<uint32_t>(acc >> (cnt - k)) & ((1u << k) - 1);
  }
  void skip(int k) { cnt -= k; }
  uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    cnt -= k;
    return v;
  }
  // Whether a read took a zero bit fed in place of data.
  bool overran() const { return fake > cnt; }
  // A restart: the bits left are dropped.
  void reset() {
    acc = 0;
    cnt = 0;
    fake = 0;
  }
};

// The QM decoder of T.81 Annex D as jdarith.c runs it: C and A registers,
// ``ct`` the bits left in C's buffer byte (-16 before the first two bytes,
// -1 after an error, which stops the scan's decoding up to its next
// restart).  At a marker, zero bytes are fed, which is legal here.
struct ArithReader {
  Stream& s;
  int64_t c = 0, a = 0;
  int ct = -16;

  explicit ArithReader(Stream& stream) : s(stream) {}

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!s.unread) {
          data = s.byte();
          if (data == 0xFF) {
            do {
              data = s.byte();
            } while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              s.unread = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // the two first bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    const QmState& q = kQm[sv & 0x7F];
    const int64_t qe = q.qe;
    const int nl = (q.swap << 7) | q.nlps, nm = q.nmps;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Component {
  int id = 0;
  int h = 1, v = 1;
  int tq = 0;
  bool needed = false;   // output to gray needs it (libjpeg's component_needed)
  bool scanned = false;  // named by a scan (its quantisation table is latched then)
  int dw = 0, dh = 0;    // samples: libjpeg's downsampled_width/height
  int bw = 0, bh = 0;    // data units holding them (width_in_blocks, height_in_blocks)
  int bwp = 0, bhp = 0;  // units up to the interleaved MCUs' edge
  uint16_t qv[64] = {};  // the latched table (quantval), natural order
  int16_t qt[64] = {};   // the same as the inverse DCT multiplies (zero until latched)
  int coef_bits[64] = {};  // progressive: the Al of each coefficient's last scan, -1 before
  int prev_bits[64] = {};  // progressive: coef_bits before this component's last scan
  std::vector<int16_t> coef;   // a file of several scans: bwp × bhp blocks, natural order
  std::vector<uint8_t> plane;  // samples: bwp × bhp units
  size_t stride = 0;
};

// One scan's header.
struct ScanHeader {
  int ns = 0;
  int idx[4] = {}, td[4] = {}, ta[4] = {};
  int ss = 0, se = 0, ah = 0, al = 0;
};

// The colour space libjpeg gives the frame (jdapimin.c default_decompress_parms).
enum class Colour { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* data, size_t size) : s_(data, size) {}

  // Parse the headers up to the first scan: size, components, orientation.
  void read_header() { run(false); }
  // Decode the whole file: every needed component's samples.
  void decode() {
    run(true);
    finish();
  }

  int height() const { return height_; }
  int width() const { return width_; }
  int orientation() const { return orientation_; }

  // out [height, width] after the EXIF orientation: [width, height] for 5-8.
  void render(uint8_t* out) const {
    const Component& y = comps_[0];
    if (colour_ == Colour::kGray || colour_ == Colour::kYCbCr) {
      if (y.h == hmax_ && y.v == vmax_) {
        orient(y.plane.data(), y.stride, height_, width_, orientation_, out);
        return;
      }
    }
    const size_t npx = static_cast<size_t>(width_) * height_;
    std::vector<std::vector<uint8_t>> full(comps_.size());
    for (size_t c = 0; c < comps_.size(); ++c) {
      if (!comps_[c].needed) continue;
      full[c].resize(npx);
      upsample(comps_[c], full[c].data());
    }
    std::vector<uint8_t> gray;
    switch (colour_) {
      case Colour::kGray:
      case Colour::kYCbCr:
        gray.swap(full[0]);
        break;
      case Colour::kRGB:
        gray.resize(npx);
        // jdcolor.c rgb_gray_convert: Y = 0.299 R + 0.587 G + 0.114 B in
        // 16-bit fixed point, rounded
        for (size_t i = 0; i < npx; ++i)
          gray[i] = static_cast<uint8_t>(
              (19595 * full[0][i] + 38470 * full[1][i] + 7471 * full[2][i] + 32768) >> 16);
        break;
      case Colour::kCMYK:
      case Colour::kYCCK:
        gray.resize(npx);
        for (size_t i = 0; i < npx; ++i) {
          int c0 = full[0][i], c1 = full[1][i], c2 = full[2][i];
          if (colour_ == Colour::kYCCK) ycc_to_inverted_rgb(&c0, &c1, &c2);
          gray[i] = cmyk_gray(c0, c1, c2, full[3][i]);
        }
        break;
    }
    orient(gray.data(), static_cast<size_t>(width_), height_, width_, orientation_, out);
  }

 private:
  Stream s_;
  int precision_ = 8, height_ = 0, width_ = 0;
  int orientation_ = 1;
  bool saw_exif_ = false, saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  bool frame_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  bool colour_set_ = false;  // the first scan's header was read
  bool multi_scan_ = false;  // libjpeg's has_multiple_scans: all is decoded before output
  Colour colour_ = Colour::kGray;
  std::vector<Component> comps_;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  uint16_t qt_[4][64] = {};  // natural order
  bool qt_defined_[4] = {};
  HuffSpec dc_spec_[4], ac_spec_[4];
  uint8_t arith_l_[16] = {}, arith_u_[16] = {}, arith_k_[16] = {};  // DAC conditioning
  int restart_interval_ = 0;
  int scans_ = 0;      // input_scan_number
  int last_good_ = 0;  // last_good_iMCU_row: the iMCU row where the last scan's data ran out

  void run(bool full) {
    if (s_.n < 2 || s_.d[0] != 0xFF || s_.d[1] != 0xD8) fail("not a JPEG (no SOI marker)");
    std::fill(arith_l_, arith_l_ + 16, 0);
    std::fill(arith_u_, arith_u_ + 16, 1);
    std::fill(arith_k_, arith_k_ + 16, 5);
    s_.pos = 2;
    for (;;) {
      if (!s_.unread) s_.next_marker();
      const int m = s_.unread;
      s_.unread = 0;
      switch (m) {
        case 0xD8:
          fail("corrupt JPEG: a second SOI marker");
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC3:
        case 0xC9:
        case 0xCA:
        case 0xCB:
          get_sof(m);
          break;
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail("hierarchical JPEG (SOF5-7, SOF13-15) is not read: libjpeg refuses it");
        case 0xDA: {
          const ScanHeader sh = get_sos();
          if (!colour_set_) {
            first_scan(sh);
            if (!full) return;
          }
          scan(sh);
          // one scan holds the whole image: libjpeg outputs it as it is
          // decoded, and OpenCV ignores what jpeg_finish_decompress finds after
          if (!multi_scan_) return;
          break;
        }
        case 0xD9:
          if (!colour_set_) fail("truncated JPEG: no image (it ends before its first scan)");
          return;
        case 0xCC:
          get_dac();
          break;
        case 0xC4:
          get_dht();
          break;
        case 0xDB:
          get_dqt();
          break;
        case 0xDD:
          if (s_.u16() != 4) fail("corrupt JPEG: DRI of a wrong length");
          restart_interval_ = s_.u16();
          break;
        case 0xE0:
        case 0xEE:
          get_app0_app14(m);
          break;
        case 0xE1:
          get_app1();
          break;
        case 0x01:
        case 0xD0:
        case 0xD1:
        case 0xD2:
        case 0xD3:
        case 0xD4:
        case 0xD5:
        case 0xD6:
        case 0xD7:
          break;  // no payload
        default:
          if ((m >= 0xE2 && m <= 0xEF) || m == 0xFE || m == 0xDC) {  // APPn, COM, DNL
            s_.skip(s_.u16() - 2);
            break;
          }
          fail("corrupt JPEG: unknown marker 0x" + hex(m));
      }
    }
  }

  static std::string hex(int v) {
    char b[8];
    std::snprintf(b, sizeof(b), "%02X", v & 0xFF);
    return b;
  }

  // jdmarker.c get_sof: the frame header, checked as libjpeg checks it then
  // (the rest at the first scan, first_scan).
  void get_sof(int m) {
    if (frame_) fail("corrupt JPEG: two frame headers");
    progressive_ = m == 0xC2 || m == 0xCA;
    lossless_ = m == 0xC3 || m == 0xCB;
    arith_ = m >= 0xC9;
    int length = s_.u16();
    precision_ = s_.byte();
    height_ = s_.u16();
    width_ = s_.u16();
    const int nc = s_.byte();
    length -= 8;
    if (height_ == 0)
      fail("JPEG with a height of 0 (set by a DNL marker) is not read: libjpeg refuses it");
    if (width_ == 0 || nc == 0) fail("corrupt JPEG: empty frame");
    if (length != nc * 3) fail("corrupt JPEG: SOF of a wrong length");
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.id = s_.byte();
      const int hv = s_.byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = s_.byte();
      comps_.push_back(c);
    }
    frame_ = true;
  }

  // jdmarker.c get_sos, with its quirk: a component id is matched against
  // the components whose index has no scan entry yet at that position.
  ScanHeader get_sos() {
    if (!frame_) fail("corrupt JPEG: scan before the frame header");
    const int length = s_.u16();
    ScanHeader sh;
    const int n = s_.byte();
    if (length != n * 2 + 6 || n < 1 || n > 4) fail("corrupt JPEG: SOS of a wrong length");
    sh.ns = n;
    int set[4] = {-1, -1, -1, -1};  // cur_comp_info
    for (int i = 0; i < n; ++i) {
      const int cs = s_.byte(), t = s_.byte();
      int found = -1;
      for (int ci = 0; ci < static_cast<int>(comps_.size()) && ci < 4; ++ci)
        if (comps_[ci].id == cs && set[ci] < 0) {
          found = ci;
          break;
        }
      if (found < 0) fail("corrupt JPEG: scan names an unknown component");
      for (int p = 0; p < i; ++p)
        if (set[p] == found) fail("corrupt JPEG: scan names a component twice");
      set[i] = found;
      sh.idx[i] = found;
      sh.td[i] = t >> 4;
      sh.ta[i] = t & 15;
    }
    sh.ss = s_.byte();
    sh.se = s_.byte();
    const int a = s_.byte();
    sh.ah = a >> 4;
    sh.al = a & 15;
    ++scans_;
    return sh;
  }

  void get_dqt() {
    long length = s_.u16() - 2;
    while (length > 0) {
      const int b = s_.byte();
      const int pq = b >> 4, tq = b & 15;
      if (tq > 3) fail("corrupt JPEG: DQT names table " + std::to_string(tq));
      for (int i = 0; i < 64; ++i)
        qt_[tq][kNatural[i]] = static_cast<uint16_t>(pq ? s_.u16() : s_.byte());
      qt_defined_[tq] = true;
      length -= pq ? 129 : 65;
    }
    if (length != 0) fail("corrupt JPEG: DQT of a wrong length");
  }

  void get_dht() {
    long length = s_.u16() - 2;
    while (length > 16) {
      const int index = s_.byte();
      HuffSpec spec;
      int count = 0;
      for (int i = 0; i < 16; ++i) {
        spec.bits[i] = static_cast<uint8_t>(s_.byte());
        count += spec.bits[i];
      }
      length -= 17;
      if (count > 256 || count > length) fail("corrupt JPEG: bad Huffman table");
      for (int i = 0; i < count; ++i) spec.vals[i] = static_cast<uint8_t>(s_.byte());
      length -= count;
      const int th = index & ~0x10;
      if (th > 3) fail("corrupt JPEG: DHT names table " + std::to_string(th));
      spec.defined = true;
      (index & 0x10 ? ac_spec_ : dc_spec_)[th] = spec;
    }
    if (length != 0) fail("corrupt JPEG: DHT of a wrong length");
  }

  void get_dac() {
    long length = s_.u16() - 2;
    while (length > 0) {
      const int index = s_.byte(), val = s_.byte();
      length -= 2;
      if (index >= 32) fail("corrupt JPEG: DAC names table " + std::to_string(index));
      if (index >= 16) {
        arith_k_[index - 16] = static_cast<uint8_t>(val);
      } else {
        arith_l_[index] = static_cast<uint8_t>(val & 15);
        arith_u_[index] = static_cast<uint8_t>(val >> 4);
        if (arith_l_[index] > arith_u_[index]) fail("corrupt JPEG: DAC with L above U");
      }
    }
    if (length != 0) fail("corrupt JPEG: DAC of a wrong length");
  }

  // jdmarker.c get_interesting_appn: the JFIF and Adobe markers, read
  // before the first scan, set the colour space.
  void get_app0_app14(int m) {
    long length = s_.u16() - 2;
    const int take = static_cast<int>(std::min<long>(std::max<long>(length, 0), 14));
    uint8_t b[14];
    for (int i = 0; i < take; ++i) b[i] = static_cast<uint8_t>(s_.byte());
    length -= take;
    if (m == 0xE0 && take >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) saw_jfif_ = true;
    if (m == 0xEE && take >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      saw_adobe_ = true;
      adobe_transform_ = b[11];
    }
    s_.skip(length);
  }

  // APP1, saved whole (OpenCV's jpeg_save_markers); the first Exif block
  // before the first scan gives the orientation.
  void get_app1() {
    const long length = s_.u16() - 2;
    if (length <= 0) return;
    std::vector<uint8_t> seg(static_cast<size_t>(length));
    for (long i = 0; i < length; ++i) seg[i] = static_cast<uint8_t>(s_.byte());
    if (!colour_set_ && !saw_exif_ && length >= 6 && std::memcmp(seg.data(), "Exif\0\0", 6) == 0) {
      saw_exif_ = true;
      orientation_ = exif_orientation(seg.data(), seg.size());
    }
  }

  // The first scan: jdinput.c initial_setup, jdapimin.c's colour space, and
  // what jpeg_start_decompress refuses for gray output (OpenCV asks for
  // CMYK from 4 components and converts it itself).
  void first_scan(const ScanHeader& sh) {
    if (height_ > 65500 || width_ > 65500)
      fail("JPEG wider or taller than 65500 is not read: libjpeg refuses it");
    if (lossless_) {
      if (precision_ < 2 || precision_ > 16)
        fail("corrupt JPEG: precision " + std::to_string(precision_));
      if (precision_ > 8)
        fail(std::to_string(precision_) + "-bit lossless JPEG is not read (2- to 8-bit only): "
             "OpenCV's libjpeg interface refuses it");
      if (arith_) fail("arithmetic-coded lossless JPEG (SOF11) is not read: libjpeg refuses it");
    } else {
      if (precision_ != 8 && precision_ != 12)
        fail("corrupt JPEG: precision " + std::to_string(precision_));
      if (precision_ == 12)
        fail("12-bit JPEG is not read (8-bit only): OpenCV's libjpeg interface refuses it");
    }
    const int nc = static_cast<int>(comps_.size());
    if (nc > 10) fail("corrupt JPEG: more than 10 components");
    for (const Component& c : comps_) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("corrupt JPEG: bad sampling factors");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    if (static_cast<int64_t>(width_) * height_ > (int64_t(1) << 30))
      fail("JPEG of more than 2^30 pixels is not read");
    // jdinput.c initial_setup: each component's extent, in samples and data
    // units (8×8 blocks; single samples in a lossless file)
    const int du = lossless_ ? 1 : 8;
    mcux_ = (width_ + du * hmax_ - 1) / (du * hmax_);
    mcuy_ = (height_ + du * vmax_ - 1) / (du * vmax_);
    for (Component& c : comps_) {
      c.dw = static_cast<int>((static_cast<int64_t>(width_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<int64_t>(height_) * c.v + vmax_ - 1) / vmax_);
      c.bw = (c.dw + du - 1) / du;
      c.bh = (c.dh + du - 1) / du;
      c.bwp = mcux_ * c.h;
      c.bhp = mcuy_ * c.v;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 64, 0);
    }
    set_colour();
    multi_scan_ = sh.ns < nc || progressive_;
    for (Component& k : comps_) {
      k.stride = static_cast<size_t>(k.bwp) * du;
      if (k.needed) k.plane.assign(k.stride * k.bhp * du, 0);
      if (multi_scan_ && !lossless_) k.coef.assign(static_cast<size_t>(k.bwp) * k.bhp * 64, 0);
    }
    colour_set_ = true;
  }

  // jdapimin.c's colour space, then the components that output to gray
  // needs (jdcolor.c: Y alone of YCbCr; every component of RGB, CMYK and
  // YCCK, which OpenCV reads as CMYK), and the upsampling each takes.
  void set_colour() {
    const size_t nc = comps_.size();
    if (nc == 1) {
      colour_ = Colour::kGray;
    } else if (nc == 3) {
      bool rgb;
      if (saw_jfif_) {
        rgb = false;
      } else if (saw_adobe_) {
        rgb = adobe_transform_ == 0;
      } else {
        // by the component ids: R, G, B; a lossless file is taken for RGB
        rgb = (comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B') || lossless_;
      }
      colour_ = rgb ? Colour::kRGB : Colour::kYCbCr;
    } else if (nc == 4) {
      colour_ = saw_adobe_ && adobe_transform_ != 0 ? Colour::kYCCK : Colour::kCMYK;
    } else {
      fail(std::to_string(nc) +
           "-component JPEG is not read: libjpeg has no conversion of it to gray");
    }
    // jdcolor.c: lossless output takes no colour conversion that loses
    // data, and OpenCV asks for gray (CMYK from 4 components)
    if (lossless_ && colour_ != Colour::kGray && colour_ != Colour::kCMYK) {
      const char* name =
          colour_ == Colour::kRGB ? "RGB" : colour_ == Colour::kYCbCr ? "YCbCr" : "YCCK";
      fail(std::string("lossless JPEG in ") + name + " is not read as gray: libjpeg refuses " +
           "a lossy colour conversion of a lossless file");
    }
    for (size_t c = 0; c < nc; ++c) {
      Component& k = comps_[c];
      k.needed = c == 0 || (colour_ != Colour::kYCbCr);
      if (!k.needed) continue;
      // jdsample.c jinit_upsampler: integral factors only
      if (hmax_ % k.h || vmax_ % k.v)
        fail("JPEG with fractional sampling factors (" + std::to_string(k.h) + "x" +
             std::to_string(k.v) + " against " + std::to_string(hmax_) + "x" +
             std::to_string(vmax_) + ") is not read: libjpeg refuses them");
    }
  }

  // jdhuff.c jpeg_make_d_derived_tbl's table lookup; a sequential file's
  // missing table 0 or 1 is the standard's (jinit_huff_decoder installs
  // them, the progressive and lossless decoders do not).
  const HuffSpec& huff_spec(bool dc, int t) {
    if (t > 3 || (!(dc ? dc_spec_ : ac_spec_)[t].defined && (t > 1 || lossless_ || progressive_)))
      fail("corrupt JPEG: a scan without its Huffman tables (table " + std::to_string(t) +
           " is not defined)");
    HuffSpec& spec = (dc ? dc_spec_ : ac_spec_)[t];
    if (!spec.defined) {
      const uint8_t* bits =
          dc ? (t ? kStdDcChrBits : kStdDcLumBits) : (t ? kStdAcChrBits : kStdAcLumBits);
      const uint8_t* vals = dc ? kStdDcVal : (t ? kStdAcChrVal : kStdAcLumVal);
      int total = 0;
      for (int i = 0; i < 16; ++i) total += bits[i];
      std::memcpy(spec.bits, bits, 16);
      std::memcpy(spec.vals, vals, static_cast<size_t>(total));
      spec.defined = true;
    }
    return spec;
  }

  static int decode_huff(BitReader& br, const Huffman& h) {
    uint32_t look = br.peek(kLookBits);
    int len = h.look_len[look];
    if (len) {
      br.skip(len);
      return h.look_sym[look];
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(br.peek(l));
      if (code <= h.maxcode[l]) {
        br.skip(l);
        return h.vals[(code + h.valoff[l]) & 0xFF];
      }
    }
    // no code of 16 bits or less: libjpeg reads a 17th bit and takes symbol 0
    br.skip(17);
    return 0;
  }

  static int extend(uint32_t v, int s) {
    return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1 : static_cast<int>(v);
  }

  // One sequential block's coefficients (natural order, int16 as libjpeg's
  // JCOEF); coef null: decoded to stay in step, then dropped.
  static void decode_block(BitReader& br, const Huffman& dc, const Huffman& ac, int& pred,
                           int16_t* coef) {
    int s = decode_huff(br, dc);
    // the sum wraps as libjpeg's int does on damaged data
    if (s) pred = static_cast<int>(static_cast<uint32_t>(pred) + extend(br.get(s), s));
    if (coef) coef[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64;) {
      int rs = decode_huff(br, ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.get(s), s);
        if (coef) coef[kNatural[k]] = static_cast<int16_t>(v);
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
  }

  // The progressive decoders of jdphuff.c, one block each (F.2.4 of the
  // standard): DC first, DC refinement, AC first and AC refinement with
  // end-of-band runs (``eobrun``, carried from block to block).
  static void dc_first(BitReader& br, const Huffman& dc, int& pred, int al, int16_t* coef) {
    int s = decode_huff(br, dc);
    if (s) {
      const int64_t sum = static_cast<int64_t>(pred) + extend(br.get(s), s);
      if (sum > INT32_MAX || sum < INT32_MIN) fail("corrupt JPEG: DC coefficient out of range");
      pred = static_cast<int>(sum);
    }
    coef[0] = static_cast<int16_t>(static_cast<uint32_t>(pred) << al);
  }

  static void ac_first(BitReader& br, const Huffman& ac, int ss, int se, int al, int& eobrun,
                       int16_t* coef) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = decode_huff(br, ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.get(s), s);
        coef[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += static_cast<int>(br.get(r));
        --eobrun;
        break;
      }
    }
  }

  static void ac_refine(BitReader& br, const Huffman& ac, int ss, int se, int al, int& eobrun,
                        int16_t* coef) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    auto correct = [&](int16_t* c) {
      if (br.get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode_huff(br, ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // a newly nonzero coefficient of magnitude 1 (libjpeg warns on s != 1)
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(br.get(r));
          break;  // the rest of the block is the end-of-band run's
        }
        // past the nonzero coefficients (each takes a correction bit) and r
        // zero ones, to the zero one that the new value lands on
        do {
          int16_t* c = coef + kNatural[k];
          if (*c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) coef[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* c = coef + kNatural[k];
        if (*c != 0) correct(c);
      }
      --eobrun;
    }
  }

  // jdarith.c's statistics of one scan: DC (64 bins per table, Table F.4)
  // and AC (256 per table), each reset at a restart.
  struct ArithStats {
    uint8_t dc[16][64];
    uint8_t ac[16][256];
    uint8_t fixed[4] = {113, 0, 0, 0};
    int last_dc[4] = {}, dc_context[4] = {};
  };

  // jdarith.c: a DC difference (F.19-F.24), with its conditioning; false
  // on a magnitude overflow (the decoder's error state).
  bool arith_dc(ArithReader& ar, ArithStats& st, int tbl, int ci) {
    uint8_t* s = st.dc[tbl] + st.dc_context[ci];
    if (ar.decode(s) == 0) {
      st.dc_context[ci] = 0;
      return true;
    }
    const int sign = ar.decode(s + 1);
    s += 2 + sign;
    int m = ar.decode(s);
    if (m != 0) {
      s = st.dc[tbl] + 20;
      while (ar.decode(s)) {
        if ((m <<= 1) == 0x8000) return false;
        s += 1;
      }
    }
    if (m < static_cast<int>((1L << arith_l_[tbl]) >> 1))
      st.dc_context[ci] = 0;
    else if (m > static_cast<int>((1L << arith_u_[tbl]) >> 1))
      st.dc_context[ci] = 12 + sign * 4;
    else
      st.dc_context[ci] = 4 + sign * 4;
    int v = m;
    s += 14;
    while (m >>= 1)
      if (ar.decode(s)) v |= m;
    v += 1;
    if (sign) v = -v;
    st.last_dc[ci] = (st.last_dc[ci] + v) & 0xffff;
    return true;
  }

  // jdarith.c: AC coefficients ss..se of one block, each shifted by al;
  // false on a spectral or magnitude overflow.
  bool arith_ac(ArithReader& ar, ArithStats& st, int tbl, int ss, int se, int al, int16_t* block) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* s = st.ac[tbl] + 3 * (k - 1);
      if (ar.decode(s)) break;  // end of block
      while (ar.decode(s + 1) == 0) {
        s += 3;
        if (++k > se) return false;
      }
      const int sign = ar.decode(st.fixed);
      s += 2;
      int m = ar.decode(s);
      if (m != 0) {
        if (ar.decode(s)) {
          m <<= 1;
          s = st.ac[tbl] + (k <= arith_k_[tbl] ? 189 : 217);
          while (ar.decode(s)) {
            if ((m <<= 1) == 0x8000) return false;
            s += 1;
          }
        }
      }
      int v = m;
      s += 14;
      while (m >>= 1)
        if (ar.decode(s)) v |= m;
      v += 1;
      if (sign) v = -v;
      block[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
    }
    return true;
  }

  // jdarith.c decode_mcu_AC_refine for one block; false on a spectral overflow.
  bool arith_ac_refine(ArithReader& ar, ArithStats& st, int tbl, int ss, int se, int al,
                       int16_t* block) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;  // the end of block of the previous stages
    for (; kex > 0; --kex)
      if (block[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* s = st.ac[tbl] + 3 * (k - 1);
      if (k > kex)
        if (ar.decode(s)) break;
      for (;;) {
        int16_t* c = block + kNatural[k];
        if (*c) {
          if (ar.decode(s + 2)) *c = static_cast<int16_t>(*c + (*c < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(s + 1)) {
          *c = static_cast<int16_t>(ar.decode(st.fixed) ? m1 : p1);
          break;
        }
        s += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }

  // per_scan_setup, latch_quant_tables and the entropy decoder's start_pass
  // (jdinput.c, jdhuff.c, jdphuff.c, jdarith.c, jdlhuff.c), then the scan's
  // data.
  void scan(const ScanHeader& sh) {
    const int ns = sh.ns;
    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += comps_[sh.idx[i]].h * comps_[sh.idx[i]].v;
    if (ns > 1 && blocks > 10) fail("corrupt JPEG: more than 10 blocks in an MCU");
    if (lossless_) {
      scan_lossless(sh);
      return;
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = comps_[sh.idx[i]];
      // jdinput.c latch_quant_tables: a component's table is the one defined
      // when its first scan starts
      if (!c.scanned) {
        if (c.tq > 3 || !qt_defined_[c.tq]) fail("corrupt JPEG: quantisation table missing");
        for (int k = 0; k < 64; ++k) {
          c.qv[k] = qt_[c.tq][k];
          c.qt[k] = static_cast<int16_t>(qt_[c.tq][k]);
        }
        c.scanned = true;
      }
    }
    const bool dc_band = sh.ss == 0;
    if (progressive_) {
      // start_pass's checks, then the progression status (coef_bits) and,
      // for block smoothing, its state before this scan (prev_bits)
      bool bad = dc_band ? sh.se != 0 : (sh.ss > sh.se || sh.se > 63 || ns != 1);
      if ((sh.ah != 0 && sh.al != sh.ah - 1) || sh.al > 13) bad = true;
      if (bad) fail("corrupt JPEG: bad progression parameters in a scan");
      for (int i = 0; i < ns; ++i) {
        Component& c = comps_[sh.idx[i]];
        for (int k = std::min(sh.ss, 1); k <= std::max(sh.se, 9); ++k)
          c.prev_bits[k] = scans_ > 1 ? c.coef_bits[k] : 0;
        for (int k = sh.ss; k <= sh.se; ++k) c.coef_bits[k] = sh.al;
      }
    }
    // the Huffman tables the scan reads (an arithmetic scan's 16 tables of
    // statistics need no checks: SOS cannot name a 17th)
    Huffman dct[4], act[4];
    for (int i = 0; i < ns && !arith_; ++i) {
      if (!progressive_ || (dc_band && sh.ah == 0))
        dct[i].build(huff_spec(true, sh.td[i]), true, false);
      if (!progressive_ || !dc_band) act[i].build(huff_spec(false, sh.ta[i]), false, false);
    }
    scan_lossy(sh, dct, act);
  }

  void scan_lossy(const ScanHeader& sh, const Huffman* dct, const Huffman* act) {
    const int ns = sh.ns;
    const bool dc_band = sh.ss == 0;
    long long total, per_row;
    if (ns == 1) {
      // a single-component scan: one block per MCU, over the component's
      // own extent (not padded to the interleaved MCU)
      per_row = comps_[sh.idx[0]].bw;
      total = per_row * comps_[sh.idx[0]].bh;
    } else {
      per_row = mcux_;
      total = static_cast<long long>(mcux_) * mcuy_;
    }
    BitReader br(s_);
    ArithReader ar(s_);
    std::unique_ptr<ArithStats> st;
    if (arith_) st.reset(new ArithStats);
    auto reset_stats = [&]() {
      for (int i = 0; i < ns; ++i) {
        if (!progressive_ || (dc_band && sh.ah == 0)) {
          std::memset(st->dc[sh.td[i]], 0, 64);
          st->last_dc[i] = 0;
          st->dc_context[i] = 0;
        }
        if (!progressive_ || !dc_band) std::memset(st->ac[sh.ta[i]], 0, 256);
      }
      ar.reset();
    };
    if (arith_) reset_stats();
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    bool insufficient = false;
    int16_t scratch[64];
    int next_rst = 0;
    // the MCU's blocks: component (as the scan's index), row and column
    // offsets within the MCU, in order
    int nb = 0, member[10], boff_r[10], boff_c[10], bsz_r[10], bsz_c[10];
    for (int i = 0; i < ns; ++i) {
      const Component& c = comps_[sh.idx[i]];
      const int bx = ns == 1 ? 1 : c.h, by = ns == 1 ? 1 : c.v;
      for (int v = 0; v < by; ++v)
        for (int h = 0; h < bx; ++h, ++nb) {
          member[nb] = i;
          boff_r[nb] = v;
          boff_c[nb] = h;
          bsz_r[nb] = by;
          bsz_c[nb] = bx;
        }
    }
    const int row_v = ns == 1 ? comps_[sh.idx[0]].v : 1;  // MCU rows per iMCU row
    long long my = 0, mx = -1, to_restart = restart_interval_;
    for (long long m = 0; m < total; ++m) {
      if (++mx == per_row) {
        mx = 0;
        ++my;
      }
      if (restart_interval_ && to_restart-- == 0) {
        to_restart = restart_interval_ - 1;
        if (arith_) {
          s_.read_restart_marker(&next_rst);
          reset_stats();
        } else {
          // jdhuff.c process_restart: the bits left are dropped; decoding
          // resumes unless the resync left a marker unread
          if (br.overran()) insufficient = true;
          br.reset();
          s_.read_restart_marker(&next_rst);
          if (!s_.unread) insufficient = false;
          pred[0] = pred[1] = pred[2] = pred[3] = 0;
          eobrun = 0;
        }
      }
      if (!arith_ && br.overran()) insufficient = true;
      if (!insufficient) last_good_ = static_cast<int>(row_v == 1 ? my : my / row_v);
      // the blocks' coefficients in a file of several scans, their samples
      // in a file of one
      int16_t* blk[10];
      uint8_t* dst[10];
      Component* owner[10];
      for (int b = 0; b < nb; ++b) {
        Component& c = comps_[sh.idx[member[b]]];
        const size_t row = static_cast<size_t>(my * bsz_r[b] + boff_r[b]);
        const size_t col = static_cast<size_t>(mx * bsz_c[b] + boff_c[b]);
        blk[b] = multi_scan_ ? c.coef.data() + (row * c.bwp + col) * 64 : scratch;
        dst[b] = c.needed && !multi_scan_ ? c.plane.data() + row * 8 * c.stride + col * 8 : nullptr;
        owner[b] = &c;
      }
      if (!progressive_) {
        // sequential: one scan decodes straight to samples (libjpeg zeroes
        // each block first), several fill the coefficient buffer
        bool stop = ar.ct == -1;
        for (int b = 0; b < nb; ++b) {
          const Component& c = *owner[b];
          const int i = member[b];
          if (!multi_scan_) std::memset(scratch, 0, sizeof(scratch));
          if (arith_) {
            if (!stop) {
              if (!arith_dc(ar, *st, sh.td[i], i)) {
                stop = true;
              } else {
                blk[b][0] = static_cast<int16_t>(st->last_dc[i]);
                stop = !arith_ac(ar, *st, sh.ta[i], 1, 63, 0, blk[b]);
              }
              if (stop) ar.ct = -1;
            }
          } else if (!insufficient) {
            decode_block(br, dct[i], act[i], pred[i], c.needed ? blk[b] : nullptr);
          }
          if (dst[b]) idct_islow(scratch, c.qt, dst[b], c.stride);
        }
        continue;
      }
      if (arith_) {
        if (dc_band && sh.ah != 0) {
          // DC refinement: the next bit of each block's DC (no error check)
          for (int b = 0; b < nb; ++b)
            if (ar.decode(st->fixed)) blk[b][0] = static_cast<int16_t>(blk[b][0] | (1 << sh.al));
          continue;
        }
        if (ar.ct == -1) continue;
        if (dc_band) {
          for (int b = 0; b < nb; ++b) {
            const int i = member[b];
            if (!arith_dc(ar, *st, sh.td[i], i)) {
              ar.ct = -1;
              break;
            }
            blk[b][0] = static_cast<int16_t>(static_cast<uint32_t>(st->last_dc[i]) << sh.al);
          }
        } else if (sh.ah == 0) {
          if (!arith_ac(ar, *st, sh.ta[0], sh.ss, sh.se, sh.al, blk[0])) ar.ct = -1;
        } else if (!arith_ac_refine(ar, *st, sh.ta[0], sh.ss, sh.se, sh.al, blk[0])) {
          ar.ct = -1;
        }
        continue;
      }
      if (dc_band && sh.ah != 0) {
        // DC refinement reads on: zero bits change nothing
        for (int b = 0; b < nb; ++b)
          if (br.get(1)) blk[b][0] = static_cast<int16_t>(blk[b][0] | (1 << sh.al));
        continue;
      }
      if (insufficient) continue;
      for (int b = 0; b < nb; ++b) {
        if (dc_band) {
          dc_first(br, dct[member[b]], pred[member[b]], sh.al, blk[b]);
        } else if (sh.ah == 0) {
          ac_first(br, act[0], sh.ss, sh.se, sh.al, eobrun, blk[b]);
        } else {
          ac_refine(br, act[0], sh.ss, sh.se, sh.al, eobrun, blk[b]);
        }
      }
    }
  }

  // An 8-bit (or narrower) lossless scan (jddiffct.c, jdlhuff.c,
  // jdlossls.c): each MCU row's differences, then per iMCU row the
  // undifferencing of each component's rows by the scan's predictor (the
  // first row after the start, a restart or the end of the data by the
  // first-row rule), scaled by the point transform.
  void scan_lossless(const ScanHeader& sh) {
    const int ns = sh.ns;
    if (sh.ss < 1 || sh.ss > 7 || sh.se != 0 || sh.ah != 0 || sh.al >= precision_)
      fail("corrupt JPEG: bad lossless scan parameters");
    const int per_row = ns == 1 ? comps_[sh.idx[0]].bw : mcux_;
    if (restart_interval_ % per_row != 0)
      fail("corrupt JPEG: lossless restart interval not a whole number of MCU rows");
    Huffman dct[4];
    for (int i = 0; i < ns; ++i) dct[i].build(huff_spec(true, sh.td[i]), true, true);
    const int initial = 1 << (precision_ - sh.al - 1);
    const int T = mcuy_;  // total_iMCU_rows
    struct Lane {
      Component* c;
      int bx, by;                  // samples per MCU
      std::vector<int32_t> diff;   // this iMCU row's differences, rows of (per_row × bx)
      std::vector<int32_t> prev;   // the last undifferenced row
      bool first = true;
    };
    Lane lane[4];
    for (int i = 0; i < ns; ++i) {
      Component& c = comps_[sh.idx[i]];
      c.scanned = true;
      lane[i].c = &c;
      lane[i].bx = ns == 1 ? 1 : c.h;
      lane[i].by = ns == 1 ? 1 : c.v;
      lane[i].diff.assign(static_cast<size_t>(c.v) * per_row * lane[i].bx, 0);
      lane[i].prev.assign(static_cast<size_t>(c.dw), 0);
    }
    BitReader br(s_);
    bool insufficient = false;
    int next_rst = 0;
    const int restart_rows = restart_interval_ / per_row;
    int rows_to_go = restart_rows;
    for (int im = 0; im < T; ++im) {
      // MCU rows in this iMCU row: one interleaved; v of the component's rows alone
      int mrows = 1;
      if (ns == 1) {
        const Component& c = *lane[0].c;
        mrows = im < T - 1 ? c.v : (c.bh % c.v ? c.bh % c.v : c.v);
      }
      for (int yo = 0; yo < mrows; ++yo) {
        if (restart_interval_) {
          if (rows_to_go == 0) {
            if (br.overran()) insufficient = true;
            br.reset();
            s_.read_restart_marker(&next_rst);
            if (!s_.unread) insufficient = false;
            for (int i = 0; i < ns; ++i) lane[i].first = true;
            rows_to_go = restart_rows;
          }
        }
        if (br.overran()) insufficient = true;
        if (insufficient) {
          // out of data: zero differences from the first-row predictor
          for (int i = 0; i < ns; ++i) {
            const size_t w = static_cast<size_t>(per_row) * lane[i].bx;
            for (int by = 0; by < lane[i].by; ++by)
              std::fill_n(lane[i].diff.begin() + (yo * lane[i].by + by) * w, w, 0);
            lane[i].first = true;
          }
        } else {
          for (int mx = 0; mx < per_row; ++mx)
            for (int i = 0; i < ns; ++i) {
              Lane& L = lane[i];
              const size_t w = static_cast<size_t>(per_row) * L.bx;
              for (int by = 0; by < L.by; ++by)
                for (int bx = 0; bx < L.bx; ++bx) {
                  int s = decode_huff(br, dct[i]);
                  if (s == 16) {
                    s = 32768;
                  } else if (s) {
                    s = extend(br.get(s), s);
                  }
                  L.diff[(yo * L.by + by) * w + static_cast<size_t>(mx) * L.bx + bx] = s;
                }
            }
        }
        if (restart_interval_) --rows_to_go;
      }
      for (int i = 0; i < ns; ++i) {
        Lane& L = lane[i];
        Component& c = *L.c;
        const int rows = ns == 1 ? mrows : (im < T - 1 ? c.v : (c.bh % c.v ? c.bh % c.v : c.v));
        const size_t w = static_cast<size_t>(per_row) * L.bx;
        for (int r = 0; r < rows; ++r) {
          const int32_t* df = L.diff.data() + r * w;
          int32_t* pv = L.prev.data();
          const size_t y = static_cast<size_t>(im) * c.v + r;
          uint8_t* out = c.plane.data() + y * c.stride;
          undifference(df, pv, c.dw, sh.ss, initial, L.first);
          L.first = false;
          for (int x = 0; x < c.dw; ++x) out[x] = static_cast<uint8_t>(pv[x] << sh.al);
        }
      }
    }
  }

  // jdlossls.c: one row undifferenced in place of ``row`` (which holds the
  // row above): the first row of a run from 2^(P - Pt - 1) and the left
  // neighbour; the others from the one above in column 0, the predictor after.
  static void undifference(const int32_t* diff, int32_t* row, int w, int psv, int initial,
                           bool first) {
    if (first) {
      int ra = (diff[0] + initial) & 0xFFFF;
      row[0] = ra;
      for (int x = 1; x < w; ++x) {
        ra = (diff[x] + ra) & 0xFFFF;
        row[x] = ra;
      }
      return;
    }
    int rb = row[0];
    int ra = (diff[0] + rb) & 0xFFFF;
    row[0] = ra;
    for (int x = 1; x < w; ++x) {
      const int rc = rb;
      rb = row[x];
      int p;
      switch (psv) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      ra = (diff[x] + p) & 0xFFFF;
      row[x] = ra;
    }
  }

  // After the last scan of a file of several: each needed component's
  // coefficients through the inverse DCT (a component no scan named has a
  // zero table: flat 128), progressive ones smoothed where libjpeg smooths.
  void finish() {
    if (lossless_ || !multi_scan_) return;
    int latch[10][10], prev_latch[10][10];
    const bool smooth = progressive_ && smoothing_ok(latch, prev_latch);
    for (size_t ci = 0; ci < comps_.size(); ++ci) {
      Component& c = comps_[ci];
      if (!c.needed) continue;
      if (smooth) {
        smooth_idct(c, latch[ci], prev_latch[ci]);
      } else {
        for (int by = 0; by < c.bh; ++by)
          for (int bx = 0; bx < c.bw; ++bx)
            idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bwp + bx) * 64, c.qt,
                       c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8, c.stride);
      }
    }
    for (Component& c : comps_) std::vector<int16_t>().swap(c.coef);
  }

  // jdcoefct.c smoothing_ok (libjpeg-turbo 2.1 and later): every component
  // scanned, its DC and first nine AC quantisers nonzero and its DC at
  // least partly known; useful where some of the first nine AC coefficients
  // of a component are short of their last bit.  Latches coef_bits, and
  // their state before each component's last scan.
  bool smoothing_ok(int latch[][10], int prev_latch[][10]) const {
    static const int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (size_t ci = 0; ci < comps_.size(); ++ci) {
      const Component& c = comps_[ci];
      if (!c.scanned) return false;
      for (int k : kQPos)
        if (c.qv[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      latch[ci][0] = c.coef_bits[0];
      for (int k = 1; k < 10; ++k) {
        prev_latch[ci][k] = scans_ > 1 ? c.prev_bits[k] : -1;
        latch[ci][k] = c.coef_bits[k];
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): each
  // block's first nine AC coefficients, where zero and not known to their
  // last bit, estimated from the DC values of the 5×5 blocks around it;
  // where no AC coefficient is known at all, the DC too (a Gaussian-like
  // average).  Rows past the one where the last scan's data ran out take
  // the progression status from before that scan.  The row arithmetic
  // (``ibr``, ``rows``) is libjpeg's, which in the last iMCU row counts
  // in that row's block rows.
  void smooth_idct(Component& c, const int* latch, const int* prev_latch) {
    const int T = mcuy_;
    const int wib = c.bw;
    const int64_t Q00 = c.qv[0], Q01 = c.qv[1], Q10 = c.qv[8], Q20 = c.qv[16], Q11 = c.qv[9],
                  Q02 = c.qv[2], Q03 = c.qv[3], Q12 = c.qv[10], Q21 = c.qv[17], Q30 = c.qv[24];
    int16_t ws[64];
    for (int r = 0; r < T; ++r) {
      const int block_rows = r < T - 1 ? c.v : (c.bh % c.v ? c.bh % c.v : c.v);
      const int* bits = r > last_good_ ? prev_latch : latch;
      bool change_dc = true;
      for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
      const int rows = block_rows * T;
      for (int b = 0; b < block_rows; ++b) {
        const int ibr = r * block_rows + b;
        const int row = r * c.v + b;
        const int prev = ibr > 0 ? row - 1 : row;
        const int pprev = ibr > 1 ? row - 2 : prev;
        const int next = ibr < rows - 1 ? row + 1 : row;
        const int nnext = ibr < rows - 2 ? row + 2 : next;
        const int R[5] = {pprev, prev, row, next, nnext};
        for (int x = 0; x < wib; ++x) {
          int dc[5][5];
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 5; ++j) {
              const int col = std::min(std::max(x + j - 2, 0), wib - 1);
              dc[i][j] = c.coef[(static_cast<size_t>(R[i]) * c.bwp + col) * 64];
            }
          std::memcpy(ws, c.coef.data() + (static_cast<size_t>(row) * c.bwp + x) * 64, sizeof(ws));
          // DC01..DC25 row by row, as jdcoefct.c names them
          const int64_t DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2], DC04 = dc[0][3],
                        DC05 = dc[0][4], DC06 = dc[1][0], DC07 = dc[1][1], DC08 = dc[1][2],
                        DC09 = dc[1][3], DC10 = dc[1][4], DC11 = dc[2][0], DC12 = dc[2][1],
                        DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4], DC16 = dc[3][0],
                        DC17 = dc[3][1], DC18 = dc[3][2], DC19 = dc[3][3], DC20 = dc[3][4],
                        DC21 = dc[4][0], DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3],
                        DC25 = dc[4][4];
          auto estimate = [&](int pos, int al, int64_t q, int64_t sum) {
            if (al == 0 || ws[pos] != 0) return;
            const int64_t num = Q00 * sum;
            int pred;
            if (num >= 0) {
              pred = static_cast<int>(((q << 7) + num) / (q << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            } else {
              pred = static_cast<int>(((q << 7) - num) / (q << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
              pred = -pred;
            }
            ws[pos] = static_cast<int16_t>(pred);
          };
          estimate(1, bits[1], Q01,
                   change_dc ? -DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                   3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                   3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                   DC24 + DC25
                             : -7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15);
          estimate(8, bits[2], Q10,
                   change_dc ? -DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                                   38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                                   13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25
                             : -7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23);
          estimate(16, bits[3], Q20,
                   change_dc ? DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                   5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23
                             : -DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23);
          estimate(9, bits[4], Q11,
                   change_dc ? -DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 -
                                   DC25
                             : DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 +
                                   DC04 - DC06 + 10 * DC07 - 10 * DC09);
          estimate(2, bits[5], Q02,
                   change_dc ? 2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                   7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19
                             : -DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15);
          if (change_dc) {
            estimate(3, bits[6], Q03, DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            estimate(10, bits[7], Q12, DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            estimate(17, bits[8], Q21, DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            estimate(24, bits[9], Q30, DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            const int64_t num =
                Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                       42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                       42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                       6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
            const int pred = num >= 0 ? static_cast<int>(((Q00 << 7) + num) / (Q00 << 8))
                                      : -static_cast<int>(((Q00 << 7) - num) / (Q00 << 8));
            ws[0] = static_cast<int16_t>(pred);
          }
          idct_islow(ws, c.qt, c.plane.data() + static_cast<size_t>(row) * 8 * c.stride + x * 8,
                     c.stride);
        }
      }
    }
  }

  // The component's samples at the output size, as libjpeg-turbo's
  // jdsample.c makes them (do_fancy_upsampling on, its default; off in a
  // lossless file, whose units are single samples): the triangle filters
  // for 2:1 horizontally (h2v1, more than 2 samples wide), 2:1 vertically
  // (h1v2) and both (h2v2, more than 2 wide); otherwise integral
  // replication.  Rows above the first and below the last sample row repeat
  // it (jdmainct.c's context rows).
  void upsample(const Component& c, uint8_t* out) const {
    const int W = width_, H = height_;
    const uint8_t* p = c.plane.data();
    const size_t st = c.stride;
    const int hx = hmax_ / c.h, vx = vmax_ / c.v;
    const int dw = c.dw, dh = c.dh;
    const bool fancy = !lossless_;
    std::vector<uint8_t> row(static_cast<size_t>(2) * dw + 2);
    auto clamp_row = [&](int r) { return p + static_cast<size_t>(std::min(std::max(r, 0), dh - 1)) * st; };
    for (int y = 0; y < H; ++y) {
      uint8_t* o = out + static_cast<size_t>(y) * W;
      if (hx == 1 && vx == 1) {
        std::memcpy(o, p + static_cast<size_t>(y) * st, static_cast<size_t>(W));
      } else if (fancy && hx == 2 && vx == 1 && dw > 2) {
        const uint8_t* in = p + static_cast<size_t>(y) * st;
        row[0] = in[0];
        row[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int j = 1; j < dw - 1; ++j) {
          const int cur = in[j] * 3;
          row[2 * j] = static_cast<uint8_t>((cur + in[j - 1] + 1) >> 2);
          row[2 * j + 1] = static_cast<uint8_t>((cur + in[j + 1] + 2) >> 2);
        }
        row[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        row[2 * dw - 1] = in[dw - 1];
        std::memcpy(o, row.data(), static_cast<size_t>(W));
      } else if (fancy && hx == 1 && vx == 2) {
        const int i = y / 2;
        const bool above = y % 2 == 0;
        const uint8_t* in0 = clamp_row(i);
        const uint8_t* in1 = clamp_row(above ? i - 1 : i + 1);
        const int bias = above ? 1 : 2;
        for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      } else if (fancy && hx == 2 && vx == 2 && dw > 2) {
        const int i = y / 2;
        const uint8_t* in0 = clamp_row(i);
        const uint8_t* in1 = clamp_row(y % 2 == 0 ? i - 1 : i + 1);
        auto sum = [&](int j) { return in0[j] * 3 + in1[j]; };
        int cur = sum(0), nxt = sum(1), last;
        row[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
        row[1] = static_cast<uint8_t>((cur * 3 + nxt + 7) >> 4);
        for (int j = 1; j < dw - 1; ++j) {
          last = cur;
          cur = nxt;
          nxt = sum(j + 1);
          row[2 * j] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
          row[2 * j + 1] = static_cast<uint8_t>((cur * 3 + nxt + 7) >> 4);
        }
        last = cur;
        cur = nxt;
        row[2 * dw - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
        row[2 * dw - 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
        std::memcpy(o, row.data(), static_cast<size_t>(W));
      } else {
        const uint8_t* in = p + static_cast<size_t>(y / vx) * st;
        for (int x = 0; x < W; ++x) o[x] = in[x / hx];
      }
    }
  }

  // jdcolor.c ycck_cmyk_convert's first three channels: YCbCr → RGB through
  // build_ycc_rgb_table's 16-bit tables, each subtracted from 255 and
  // clamped (K passes through).
  static void ycc_to_inverted_rgb(int* y_c, int* cb_m, int* cr_y) {
    constexpr int kBits = 16;
    constexpr int64_t kHalf = int64_t(1) << (kBits - 1);
    const int y = *y_c, cb = *cb_m - 128, cr = *cr_y - 128;
    auto rs = [](int64_t x) { return static_cast<int>(x >> kBits); };  // RIGHT_SHIFT
    const int r = y + rs(91881 * cr + kHalf);
    const int g = y + rs(-22554 * static_cast<int64_t>(cb) + kHalf - 46802 * static_cast<int64_t>(cr));
    const int b = y + rs(116130 * cb + kHalf);
    auto lim = [](int x) { return std::min(std::max(x, 0), 255); };
    *y_c = lim(255 - r);
    *cb_m = lim(255 - g);
    *cr_y = lim(255 - b);
  }

  // OpenCV's CMYK → gray on the values libjpeg gives for JCS_CMYK (an
  // Adobe file's inverted ink): R = k − ((255 − c) k >> 8), G and B likewise
  // from m and y (icvCvt_CMYK2BGR), then (cR R + cG G + cB B + 2^13) >> 14.
  // Fitted to cv2.imread over flat 8×8 tiles of 4096 CMYK values at
  // quality 100, every one exact.
  static uint8_t cmyk_gray(int c, int m, int y, int k) {
    constexpr int cR = 4899, cG = 9617, cB = 1868;  // 0.299, 0.587, 0.114 in 14 bits
    const int r = k - (((255 - c) * k) >> 8);
    const int g = k - (((255 - m) * k) >> 8);
    const int b = k - (((255 - y) * k) >> 8);
    return static_cast<uint8_t>((cR * r + cG * g + cB * b + (1 << 13)) >> 14);
  }

  // libjpeg-turbo's "slow but accurate" integer inverse DCT as its x86 SIMD
  // code computes it (jidctint-sse2/avx2.asm, which OpenCV's build runs),
  // bit for bit: jidctint.c's arithmetic with the SIMD code's 16-bit lanes.
  // The dequantised coefficients, the sums in0 ± in4 and the odd part's
  // in7 + in3 and in5 + in1 wrap at 16 bits; each pass's output saturates
  // to 16 bits, the samples to 0-255.  A block whose rows 1-7 are zero
  // takes the shortcut of pass 1 (the DC row scaled, wrapping at 16 bits).
  // On the values of an intact file this is jidctint.c exactly; the lanes
  // show only on damaged data.
  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride) {
    constexpr int kDescale1 = kConstBits - kPass1Bits, kDescale2 = kConstBits + kPass1Bits + 3;
    // ws: pass 1's output transposed, [column][row], the rows' inputs
    int16_t x[64], ws[64];
    int32_t o[64];
    bool ac_zero = true;
    for (int k = 8; k < 64 && ac_zero; ++k) ac_zero = in[k] == 0;
    if (ac_zero) {
      for (int c = 0; c < 8; ++c) {
        const int16_t dc = wrap16(wrap16(in[c] * q[c]) * (1 << kPass1Bits));
        for (int r = 0; r < 8; ++r) ws[8 * c + r] = dc;
      }
    } else {
      for (int k = 0; k < 64; ++k) x[k] = wrap16(in[k] * q[k]);
      idct_pass(x, o);
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c)
          ws[8 * c + r] = sat16((o[8 * r + c] + (1 << (kDescale1 - 1))) >> kDescale1);
    }
    idct_pass(ws, o);
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        out[r * stride + c] = clamp_sample((o[8 * c + r] + (1 << (kDescale2 - 1))) >> kDescale2);
  }

  static int16_t wrap16(int32_t x) {
    return static_cast<int16_t>(static_cast<uint16_t>(x & 0xFFFF));
  }
  static int16_t sat16(int32_t x) {
    return static_cast<int16_t>(std::min(std::max(x, -32768), 32767));
  }
  // the 16-bit then 8-bit saturating packs, then + 128
  static uint8_t clamp_sample(int32_t x) {
    return static_cast<uint8_t>(std::min(std::max(x, -128), 127) + 128);
  }

  // Eight 8-point passes side by side, as the SIMD code's lanes run them:
  // input k of pass j is the 16-bit v[8k + j], and o[8k + j] gets its
  // output k before descaling (jidctint.c's sums, with the SIMD code's
  // combined constants, which give the same sums, and its 16-bit adds; the
  // sums fit 32 bits, as in the SIMD code's lanes).
  static void idct_pass(const int16_t* v, int32_t* o) {
    constexpr int32_t f0298 = kFix0_298631336, f0390 = kFix0_390180644, f0541 = kFix0_541196100,
                      f0765 = kFix0_765366865, f0899 = kFix0_899976223, f1175 = kFix1_175875602,
                      f1501 = kFix1_501321110, f1847 = kFix1_847759065, f1961 = kFix1_961570560,
                      f2053 = kFix2_053119869, f2562 = kFix2_562915447, f3072 = kFix3_072711026;
    for (int j = 0; j < 8; ++j) {
      const int32_t v0 = v[j], v1 = v[8 + j], v2 = v[16 + j], v3 = v[24 + j], v4 = v[32 + j],
                    v5 = v[40 + j], v6 = v[48 + j], v7 = v[56 + j];
      // even part: the rotator is sqrt(2)·c(−6)
      const int32_t tmp3 = v2 * (f0541 + f0765) + v6 * f0541;
      const int32_t tmp2 = v2 * f0541 + v6 * (f0541 - f1847);
      const int32_t tmp0 = wrap16(v0 + v4) * (1 << kConstBits);
      const int32_t tmp1 = wrap16(v0 - v4) * (1 << kConstBits);
      const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      // odd part: y7, y5, y3, y1
      const int32_t z3 = wrap16(v7 + v3), z4 = wrap16(v5 + v1);
      const int32_t z3r = z3 * (f1175 - f1961) + z4 * f1175;
      const int32_t z4r = z3 * f1175 + z4 * (f1175 - f0390);
      const int32_t o0 = v7 * (f0298 - f0899) - v1 * f0899 + z3r;
      const int32_t o1 = v5 * (f2053 - f2562) - v3 * f2562 + z4r;
      const int32_t o2 = -v5 * f2562 + v3 * (f3072 - f2562) + z3r;
      const int32_t o3 = -v7 * f0899 + v1 * (f1501 - f0899) + z4r;
      o[j] = tmp10 + o3;
      o[56 + j] = tmp10 - o3;
      o[8 + j] = tmp11 + o2;
      o[48 + j] = tmp11 - o2;
      o[16 + j] = tmp12 + o1;
      o[40 + j] = tmp12 - o1;
      o[24 + j] = tmp13 + o0;
      o[32 + j] = tmp13 - o0;
    }
  }
};

// ---- PNG ----------------------------------------------------------------------

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

inline uint8_t rgb8_gray(uint32_t r, uint32_t g, uint32_t b) {
  return static_cast<uint8_t>((9797 * r + 19234 * g + 3737 * b) >> 15);
}

inline uint8_t rgb16_gray(uint32_t r, uint32_t g, uint32_t b) {
  return static_cast<uint8_t>(((9797 * r + 19234 * g + 3737 * b + 16384) >> 15) >> 8);
}

int png_channels(int color_type) {
  switch (color_type) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

// libpng's gamma arithmetic (png.c), for png_set_rgb_to_gray on a file with
// a gamma: fixed point with 5 decimals, the tables through pow() in double.
constexpr int kFp1 = 100000;

bool gamma_significant(int64_t g) { return g < kFp1 - 5000 || g > kFp1 + 5000; }

int64_t fp_reciprocal(int64_t a) {  // png_reciprocal
  const double r = std::floor(1e10 / static_cast<double>(a) + .5);
  return r <= 2147483647. && r >= -2147483648. ? static_cast<int64_t>(r) : 0;
}

int64_t fp_reciprocal2(int64_t a, int64_t b) {  // png_reciprocal2: 1 / (a b)
  if (a == 0 || b == 0) return 0;
  double r = 1e15 / static_cast<double>(a);
  r /= static_cast<double>(b);
  r = std::floor(r + .5);
  return r <= 2147483647. && r >= -2147483648. ? static_cast<int64_t>(r) : 0;
}

uint16_t gamma16_correct(unsigned v, int64_t g) {  // png_gamma_16bit_correct
  if (v == 0 || v >= 65535) return static_cast<uint16_t>(v);
  return static_cast<uint16_t>(
      std::floor(65535 * std::pow(static_cast<int32_t>(v) / 65535., static_cast<double>(g) * .00001) + .5));
}

// What png_build_gamma_table makes for png_set_rgb_to_gray with no screen
// gamma: the screen gamma is 1 / the file's, "to 1" linearises with the
// file's reciprocal and "from 1" re-encodes.  16-bit tables are indexed
// [(v & 0xff) >> shift][v >> 8].  A gray pixel (r = g = b) goes through
// the file-to-screen table instead: ``eq8`` (the identity unless the two
// gammas' product strays 5% from 1), ``eq16`` (16 → 8 bits).  Where the
// file's reciprocal overflows (a gAMA of 1-4) the screen gamma stays unset:
// "from 1" re-encodes with the file's gamma and the file-to-screen tables
// take gamma 1.
struct PngGamma {
  bool on = false;
  uint8_t to1[256], from1[256], eq8[256];
  int shift = 0;
  std::vector<uint16_t> to1_16, from1_16, eq16;

  PngGamma(int64_t file_gamma, int depth, int sig_bit) {
    // png_init_read_transformations builds the tables where the file's or
    // the screen's gamma is significant (95000 is not, its reciprocal is)
    const int64_t screen = file_gamma > 0 ? fp_reciprocal(file_gamma) : 0;
    if (file_gamma <= 0 || !(gamma_significant(file_gamma) || gamma_significant(screen))) return;
    on = true;
    const int64_t from = screen > 0 ? fp_reciprocal(screen) : file_gamma;
    if (depth <= 8) {
      table8(to1, fp_reciprocal(file_gamma));
      table8(from1, from);
      table8(eq8, screen > 0 ? fp_reciprocal2(file_gamma, screen) : kFp1);
      return;
    }
    // the insignificant bits (sBIT), at least 16 − PNG_MAX_GAMMA_8 (11) as
    // png_set_strip_16 asks, at most 8
    shift = sig_bit > 0 && sig_bit < 16 ? 16 - sig_bit : 0;
    shift = std::min(std::max(shift, 5), 8);
    table16(&to1_16, fp_reciprocal(file_gamma));
    table16(&from1_16, from);
    // the 16→8 table inverts the file-to-screen gamma it is given: the
    // reciprocal of the reciprocal (fitted to cv2.imread's gray pixels over
    // every 16-bit value at gAMAs 5 to 2^31 − 1; png_product2 misses some)
    table16to8(&eq16, screen > 0 ? fp_reciprocal(fp_reciprocal2(file_gamma, screen)) : kFp1);
  }

  uint16_t at(const std::vector<uint16_t>& t, uint32_t v) const {
    return t[(((v & 0xff) >> shift) << 8) | (v >> 8)];
  }

  static void table8(uint8_t* t, int64_t g) {  // png_build_8bit_table
    for (int i = 0; i < 256; ++i) {
      t[i] = static_cast<uint8_t>(i);
      if (gamma_significant(g) && i > 0 && i < 255)
        t[i] = static_cast<uint8_t>(
            std::floor(255 * std::pow(i / 255., static_cast<double>(g) * .00001) + .5));
    }
  }

  void table16(std::vector<uint16_t>* t, int64_t g) const {  // png_build_16bit_table
    const unsigned num = 1u << (8 - shift);
    const double fmax = 1.0 / ((int32_t(1) << (16 - shift)) - 1);
    const unsigned max = (1u << (16 - shift)) - 1, max_by_2 = 1u << (15 - shift);
    t->assign(static_cast<size_t>(num) * 256, 0);
    for (unsigned i = 0; i < num; ++i) {
      for (unsigned j = 0; j < 256; ++j) {
        uint32_t ig = (j << (8 - shift)) + i;
        uint16_t v;
        if (gamma_significant(g)) {
          v = static_cast<uint16_t>(
              std::floor(65535. * std::pow(ig * fmax, static_cast<double>(g) * .00001) + .5));
        } else {
          v = static_cast<uint16_t>(shift ? (ig * 65535u + max_by_2) / max : ig);
        }
        (*t)[i * 256 + j] = v;
      }
    }
  }

  void table16to8(std::vector<uint16_t>* t, int64_t g) const {  // png_build_16to8_table
    const unsigned num = 1u << (8 - shift);
    const uint32_t max = (1u << (16 - shift)) - 1;
    t->assign(static_cast<size_t>(num) * 256, 0);
    auto set = [&](uint32_t last, uint16_t out) {
      (*t)[((last & (0xffu >> shift)) << 8) | (last >> (8 - shift))] = out;
    };
    uint32_t last = 0;
    for (unsigned i = 0; i < 255; ++i) {
      const uint16_t out = static_cast<uint16_t>(i * 257u);
      uint32_t bound = gamma16_correct(out + 128u, g);
      bound = (bound * max + 32768u) / 65535u + 1u;
      for (; last < bound; ++last) set(last, out);
    }
    for (; last < (num << 8); ++last) set(last, 65535u);
  }
};

// One unfiltered row of n pixels to gray, as OpenCV asks libpng for it:
// gray bit depths below 8 expanded, 16-bit samples cut to their high byte,
// alpha dropped, palette to RGB, and RGB to gray (png_do_rgb_to_gray) in
// 15-bit fixed point: truncated without a gamma; with one, each sample
// linearised, the sum rounded and re-encoded; a pixel with r = g = b keeps
// its value (16-bit: through the 16→8 table).  out[x * step].
void png_row_gray(const uint8_t* c, int n, int depth, int color_type, const uint8_t* palette,
                  const PngGamma& gm, uint8_t* out, size_t step) {
  auto rgb8 = [&](uint32_t r, uint32_t g, uint32_t b) -> uint8_t {
    if (!gm.on) return rgb8_gray(r, g, b);
    if (r == g && r == b) return gm.eq8[r];
    return gm.from1[(9797 * gm.to1[r] + 19234 * gm.to1[g] + 3737 * gm.to1[b] + 16384) >> 15];
  };
  auto rgb16 = [&](uint32_t r, uint32_t g, uint32_t b) -> uint8_t {
    if (!gm.on) return rgb16_gray(r, g, b);
    if (r == g && r == b) return static_cast<uint8_t>(gm.at(gm.eq16, r) >> 8);
    const uint32_t gray =
        (9797 * gm.at(gm.to1_16, r) + 19234 * gm.at(gm.to1_16, g) + 3737 * gm.at(gm.to1_16, b) +
         16384) >> 15;
    return static_cast<uint8_t>(gm.at(gm.from1_16, gray) >> 8);
  };
  if (color_type == 0 || color_type == 3) {
    for (int x = 0; x < n; ++x) {
      uint32_t v;
      if (depth == 16) {
        v = c[2 * x];
      } else if (depth == 8) {
        v = c[x];
      } else {
        const int per = 8 / depth;
        v = (c[x / per] >> (8 - depth * (x % per + 1))) & ((1u << depth) - 1);
        if (color_type == 0) v = v * (255 / ((1u << depth) - 1));
      }
      if (color_type == 3) {
        const uint8_t* rgb = palette + 3 * v;
        out[x * step] = rgb8(rgb[0], rgb[1], rgb[2]);
      } else {
        out[x * step] = static_cast<uint8_t>(v);
      }
    }
  } else if (color_type == 4) {
    const int px = depth == 16 ? 4 : 2;
    for (int x = 0; x < n; ++x) out[x * step] = c[px * x];
  } else {
    const int ch = png_channels(color_type);
    if (depth == 8) {
      for (int x = 0; x < n; ++x) {
        const uint8_t* px = c + static_cast<size_t>(ch) * x;
        out[x * step] = rgb8(px[0], px[1], px[2]);
      }
    } else {
      for (int x = 0; x < n; ++x) {
        const uint8_t* px = c + static_cast<size_t>(2 * ch) * x;
        out[x * step] = rgb16((px[0] << 8) | px[1], (px[2] << 8) | px[3], (px[4] << 8) | px[5]);
      }
    }
  }
}

// Undo one row's filter: cur from the filtered bytes src, the row above prev.
void png_unfilter(int filter, const uint8_t* src, const uint8_t* p, uint8_t* c, size_t rowbytes,
                  size_t bpp) {
  switch (filter) {
    case 0:
      std::memcpy(c, src, rowbytes);
      break;
    case 1:
      for (size_t i = 0; i < rowbytes; ++i)
        c[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? c[i - bpp] : 0));
      break;
    case 2:
      for (size_t i = 0; i < rowbytes; ++i) c[i] = static_cast<uint8_t>(src[i] + p[i]);
      break;
    case 3:
      for (size_t i = 0; i < rowbytes; ++i) {
        int a = i >= bpp ? c[i - bpp] : 0;
        c[i] = static_cast<uint8_t>(src[i] + ((a + p[i]) >> 1));
      }
      break;
    case 4:
      for (size_t i = 0; i < rowbytes; ++i) {
        bool left = i >= bpp;
        int a = left ? c[i - bpp] : 0, cc = left ? p[i - bpp] : 0;
        c[i] = static_cast<uint8_t>(src[i] + paeth(a, p[i], cc));
      }
      break;
    default:
      fail("corrupt PNG: filter type " + std::to_string(filter));
  }
}

// The inflated image data of a PNG [h, w] to gray in out (row-major [h, w]):
// one pass, or Adam7's seven (each a sub-image of its own, filtered from a
// zero row above; empty passes have no bytes), scattered to their pixels.
void png_gray(const uint8_t* raw, size_t len, int h, int w, int depth, int color_type,
              bool adam7, const uint8_t* palette, const PngGamma& gm, uint8_t* out) {
  static const int kPass[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                  {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};  // x0 y0 dx dy
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int ch = png_channels(color_type);
  if (ch == 0) fail("corrupt PNG: bad colour type");
  const size_t bpp = static_cast<size_t>(std::max(1, ch * depth / 8));
  size_t used = 0;
  for (int p = 0; p < (adam7 ? 7 : 1); ++p) {
    const int* ps = adam7 ? kPass[p] : kWhole[0];
    const int pw = w > ps[0] ? (w - ps[0] + ps[2] - 1) / ps[2] : 0;
    const int ph = h > ps[1] ? (h - ps[1] + ps[3] - 1) / ps[3] : 0;
    if (pw == 0 || ph == 0) continue;
    const size_t rowbytes = (static_cast<size_t>(pw) * ch * depth + 7) / 8;
    if (len - used < static_cast<size_t>(ph) * (rowbytes + 1))
      fail("truncated PNG: too little image data");
    std::vector<uint8_t> prev(rowbytes, 0), cur(rowbytes, 0);
    for (int y = 0; y < ph; ++y) {
      const uint8_t* src = raw + used;
      used += rowbytes + 1;
      png_unfilter(src[0], src + 1, prev.data(), cur.data(), rowbytes, bpp);
      uint8_t* o = out + static_cast<size_t>(ps[1] + y * ps[3]) * w + ps[0];
      png_row_gray(cur.data(), pw, depth, color_type, palette, gm, o, static_cast<size_t>(ps[2]));
      cur.swap(prev);
    }
  }
}

}  // namespace

extern "C" {

// Size (after the EXIF orientation) of a JPEG held in memory: out_hw[0] rows,
// out_hw[1] columns.  Reads the headers up to the first scan only.
int ssp_jpeg_info(const uint8_t* data, size_t size, int* out_hw, char* msg, int cap) {
  try {
    JpegDecoder dec(data, size);
    dec.read_header();
    oriented_shape(dec.orientation(), dec.height(), dec.width(), out_hw, out_hw + 1);
    return 0;
  } catch (const DecodeError& e) {
    return report(e.what, msg, cap);
  } catch (...) {
    return report("out of memory decoding the JPEG", msg, cap);
  }
}

// Decode a JPEG held in memory into out [h, w] uint8 (the shape that
// ssp_jpeg_info gave).
int ssp_jpeg_gray(const uint8_t* data, size_t size, uint8_t* out, int h, int w, char* msg,
                  int cap) {
  try {
    JpegDecoder dec(data, size);
    dec.decode();
    int oh, ow;
    oriented_shape(dec.orientation(), dec.height(), dec.width(), &oh, &ow);
    if (oh != h || ow != w) fail("output shape does not match the JPEG");
    dec.render(out);
    return 0;
  } catch (const DecodeError& e) {
    return report(e.what, msg, cap);
  } catch (...) {
    return report("out of memory decoding the JPEG", msg, cap);
  }
}

// The EXIF orientation (1-8) of a TIFF-structured block, as PNG's eXIf
// chunk holds it; 1 where it has none.
int ssp_exif_orientation(const uint8_t* data, size_t size) { return exif_orientation(data, size); }

// Unfilter the inflated image data of a PNG [h, w] (Adam7 if ``interlace``)
// and convert it to gray into out (the oriented shape: [w, h] for
// orientations 5-8).  ``palette`` holds 256 RGB entries (zeros past the PLTE
// chunk's); ``gamma`` is the file's gamma in libpng's fixed point (0: none),
// ``sig_bit`` the largest colour sBIT (0: none).
int ssp_png_gray(const uint8_t* raw, size_t len, int h, int w, int depth, int color_type,
                 int interlace, const uint8_t* palette, int gamma, int sig_bit, int orientation,
                 uint8_t* out, char* msg, int cap) {
  try {
    const bool colour = color_type == 2 || color_type == 3 || color_type == 6;
    const PngGamma gm(colour ? gamma : 0, color_type == 3 ? 8 : depth, sig_bit);
    if (orientation == 1) {
      png_gray(raw, len, h, w, depth, color_type, interlace != 0, palette, gm, out);
    } else {
      std::vector<uint8_t> plane(static_cast<size_t>(h) * w);
      png_gray(raw, len, h, w, depth, color_type, interlace != 0, palette, gm, plane.data());
      orient(plane.data(), static_cast<size_t>(w), h, w, orientation, out);
    }
    return 0;
  } catch (const DecodeError& e) {
    return report(e.what, msg, cap);
  } catch (...) {
    return report("out of memory decoding the PNG", msg, cap);
  }
}

}  // extern "C"
