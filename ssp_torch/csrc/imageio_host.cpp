// Grayscale image decoding on the host, without OpenCV, libjpeg or libpng.
//
// What ``cv2.imread(path, IMREAD_GRAYSCALE)`` returns, byte for byte
// (OpenCV 5.0 on libjpeg-turbo 3.1 and libpng 1.6.58):
//
// * JPEG, 8-bit, Huffman-coded: baseline (SOF0), extended sequential (SOF1)
//   and progressive (SOF2: DC first and refinement, AC first and refinement
//   with end-of-band runs, jdphuff.c), restart intervals, 1, 3 or 4
//   components.  The colour space is libjpeg's guess (jdapimin.c): gray,
//   YCbCr, RGB (Adobe transform 0, or ids R, G, B), CMYK or YCCK.  Gray
//   output needs Y alone of YCbCr (the other components' data is decoded to
//   stay in step, or skipped where a scan holds none that is needed) and
//   every component of the rest.  A progressive file's coefficients are held
//   (int16) until its last scan.  Each needed component goes through
//   libjpeg's ``jpeg_idct_islow`` (jidctint.c) with its range-limit table,
//   libjpeg-turbo's upsampling (jdsample.c: h2v1, h1v2, h2v2 triangle
//   filters, integral replication) and colour conversion (jdcolor.c: RGB → Y
//   in 16-bit fixed point, YCCK → CMYK), CMYK through OpenCV's CMYK → gray.
//   The EXIF orientation of APP1 is applied afterwards, as OpenCV does.
//   Refused, each with a message naming it: lossless, hierarchical,
//   arithmetic-coded and 12-bit JPEG, DNL; fractional sampling and MCUs of
//   more than 10 blocks (libjpeg refuses them too); a progressive file that
//   libjpeg would smooth (``check_no_smoothing``).
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

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];  // 0: the code is longer than kLookBits
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoff[18];
  uint8_t vals[256];

  void build(const uint8_t* counts, const uint8_t* symbols, int total) {
    std::memcpy(vals, symbols, static_cast<size_t>(total));
    std::memset(look_len, 0, sizeof(look_len));
    int32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoff[len] = k - code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (code >= (1 << len)) fail("corrupt JPEG: bad Huffman table");
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int f = 0; f < (1 << shift); ++f) {
            look_len[(code << shift) | f] = static_cast<uint8_t>(len);
            look_sym[(code << shift) | f] = vals[k];
          }
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// The entropy-coded segment's bits: byte stuffing (FF 00) undone, fill bytes
// (FF FF) skipped; at a marker or the end of the data, zero bits are fed, as
// libjpeg feeds them, and counted, so that a decode that used them (a
// truncated or corrupt file) is caught.
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t acc = 0;
  int cnt = 0;
  int64_t fake = 0;
  bool stopped = false;
  size_t marker_pos = 0;  // where the marker that stopped the reader starts

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (stopped) {
        fake += 8;
      } else if (pos >= n) {
        stopped = true;
        marker_pos = n;
        fake += 8;
      } else {
        b = d[pos++];
        if (b == 0xFF) {
          size_t q = pos;
          while (q < n && d[q] == 0xFF) ++q;
          if (q < n && d[q] == 0x00) {
            pos = q + 1;
          } else {
            stopped = true;
            marker_pos = q < n ? q - 1 : n;
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
  // Whether a decode went past the real data.
  bool overran() const { return fake > cnt; }
  // Drop the bits left in the current byte and the zero fill; the position
  // of the next marker (FF xx) in the data.
  size_t next_marker() {
    if (!stopped) {
      // bytes already taken into ``acc`` but not used lie before ``pos``;
      // a marker is found by scanning on from the byte being read
      size_t q = pos;
      while (q + 1 < n && !(d[q] == 0xFF && d[q + 1] != 0x00 && d[q + 1] != 0xFF)) ++q;
      return q + 1 < n ? q : n;
    }
    return marker_pos;
  }
  void restart_at(size_t p) {
    pos = p;
    acc = 0;
    cnt = 0;
    fake = 0;
    stopped = false;
  }
};

struct Component {
  int id = 0;
  int h = 1, v = 1;
  int tq = 0;
  bool needed = false;   // goes through the inverse DCT (libjpeg's component_needed)
  bool scanned = false;  // named by a scan (its quantisation table is latched then)
  int dw = 0, dh = 0;    // samples: libjpeg's downsampled_width/height
  int bw = 0, bh = 0;    // blocks holding them (width_in_blocks, height_in_blocks)
  int bwp = 0, bhp = 0;  // blocks up to the interleaved MCUs' edge
  int16_t qt[64] = {};   // latched at the first scan, as libjpeg's quant_table
  int coef_bits[64] = {};  // progressive: the Al of each coefficient's last scan, -1 before
  std::vector<int16_t> coef;  // progressive: bwp × bhp blocks, natural order
  std::vector<uint8_t> plane;  // samples: (8 bwp) × (8 bhp)
  size_t stride = 0;
};

// The colour space libjpeg gives the frame (jdapimin.c default_decompress_parms).
enum class Colour { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* data, size_t size) : d_(data), n_(size) {}

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
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  int height_ = 0, width_ = 0;
  int orientation_ = 1;
  bool saw_exif_ = false, saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  bool frame_ = false, progressive_ = false, colour_set_ = false;
  Colour colour_ = Colour::kGray;
  std::vector<Component> comps_;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  uint16_t qt_[4][64] = {};  // natural order
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  int restart_interval_ = 0;

  uint32_t u8(size_t p) const {
    if (p >= n_) fail("truncated JPEG");
    return d_[p];
  }
  uint32_t u16(size_t p) const { return (u8(p) << 8) | u8(p + 1); }

  void run(bool full) {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG (no SOI marker)");
    pos_ = 2;
    for (;;) {
      // markers may be preceded by any number of fill bytes
      if (u8(pos_) != 0xFF) fail("corrupt JPEG: marker expected");
      while (u8(pos_) == 0xFF) ++pos_;
      uint32_t m = u8(pos_++);
      if (m == 0xD9) return;  // EOI
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // no payload
      size_t len = u16(pos_);
      if (len < 2 || pos_ + len > n_) fail("truncated JPEG: marker segment past the end");
      const uint8_t* seg = d_ + pos_ + 2;
      size_t slen = len - 2;
      size_t next = pos_ + len;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          progressive_ = m == 0xC2;
          parse_sof(seg, slen);
          break;
        case 0xC3:
          fail("lossless JPEG (SOF3) is not supported");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          fail("hierarchical JPEG (SOF5-7) is not supported");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
        case 0xCC:
          fail("arithmetic-coded JPEG is not supported");
        case 0xC4:
          parse_dht(seg, slen);
          break;
        case 0xDB:
          parse_dqt(seg, slen);
          break;
        case 0xDD:
          if (slen < 2) fail("corrupt JPEG: DRI");
          restart_interval_ = static_cast<int>((seg[0] << 8) | seg[1]);
          break;
        case 0xE0:
          if (slen >= 14 && std::memcmp(seg, "JFIF\0", 5) == 0) saw_jfif_ = true;
          break;
        case 0xE1:
          if (!saw_exif_ && slen >= 6 && std::memcmp(seg, "Exif\0\0", 6) == 0) {
            saw_exif_ = true;
            orientation_ = exif_orientation(seg, slen);
          }
          break;
        case 0xEE:
          if (slen >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
            saw_adobe_ = true;
            adobe_transform_ = seg[11];
          }
          break;
        case 0xDA: {
          if (!frame_) fail("corrupt JPEG: scan before the frame header");
          if (!colour_set_) {
            set_colour();
            if (full) allocate();
          }
          if (!full) return;
          next = scan(seg, slen, next);
          break;
        }
        case 0xDC:
          fail("JPEG with a DNL marker is not supported");
        default:
          break;  // APPn, COM and the rest: skipped
      }
      pos_ = next;
      if (pos_ >= n_) {
        if (full && colour_set_) return;  // a missing EOI after the last scan
        fail("truncated JPEG");
      }
    }
  }

  void parse_sof(const uint8_t* s, size_t n) {
    if (frame_) fail("corrupt JPEG: two frame headers");
    if (n < 6) fail("corrupt JPEG: SOF");
    if (s[0] != 8) fail(std::to_string(s[0]) + "-bit JPEG is not supported (8-bit only)");
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    int nc = s[5];
    if (height_ == 0) fail("JPEG with a DNL marker is not supported");
    if (width_ == 0) fail("corrupt JPEG: zero width");
    if (static_cast<int64_t>(width_) * height_ > (int64_t(1) << 30))
      fail("JPEG of more than 2^30 pixels is not read");
    if (n < 6 + 3 * static_cast<size_t>(nc) || nc < 1) fail("corrupt JPEG: SOF");
    if (nc != 1 && nc != 3 && nc != 4)
      fail(std::to_string(nc) + "-component JPEG is not supported");
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: bad sampling factors or table index");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
      comps_.push_back(c);
    }
    // jdinput.c initial_setup: each component's extent, in samples and blocks
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (Component& c : comps_) {
      c.dw = static_cast<int>((static_cast<int64_t>(width_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<int64_t>(height_) * c.v + vmax_ - 1) / vmax_);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.bwp = mcux_ * c.h;
      c.bhp = mcuy_ * c.v;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    frame_ = true;
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
        rgb = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
      }
      colour_ = rgb ? Colour::kRGB : Colour::kYCbCr;
    } else {
      colour_ = saw_adobe_ && adobe_transform_ != 0 ? Colour::kYCCK : Colour::kCMYK;
    }
    for (size_t c = 0; c < nc; ++c) {
      Component& k = comps_[c];
      k.needed = c == 0 || (colour_ != Colour::kYCbCr);
      if (!k.needed) continue;
      // jdsample.c jinit_upsampler: integral factors only
      if (hmax_ % k.h || vmax_ % k.v)
        fail("JPEG with fractional sampling factors (" + std::to_string(k.h) + "x" +
             std::to_string(k.v) + " against " + std::to_string(hmax_) + "x" +
             std::to_string(vmax_) + ") is not supported: libjpeg refuses it");
    }
    colour_set_ = true;
  }

  void allocate() {
    for (Component& k : comps_) {
      if (!k.needed) continue;
      k.stride = static_cast<size_t>(k.bwp) * 8;
      k.plane.assign(k.stride * k.bhp * 8, 0);
      if (progressive_) k.coef.assign(static_cast<size_t>(k.bwp) * k.bhp * 64, 0);
    }
  }

  void parse_dqt(const uint8_t* s, size_t n) {
    size_t p = 0;
    while (p < n) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      ++p;
      if (tq > 3 || pq > 1) fail("corrupt JPEG: DQT");
      size_t need = pq ? 128 : 64;
      if (p + need > n) fail("corrupt JPEG: DQT");
      for (int i = 0; i < 64; ++i)
        qt_[tq][kNatural[i]] = pq ? static_cast<uint16_t>((s[p + 2 * i] << 8) | s[p + 2 * i + 1])
                                  : s[p + i];
      qt_defined_[tq] = true;
      p += need;
    }
  }

  void parse_dht(const uint8_t* s, size_t n) {
    size_t p = 0;
    while (p < n) {
      if (p + 17 > n) fail("corrupt JPEG: DHT");
      int tc = s[p] >> 4, th = s[p] & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: DHT");
      const uint8_t* counts = s + p + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (total > 256 || p + 17 + total > n) fail("corrupt JPEG: DHT");
      (tc ? ac_[th] : dc_[th]).build(counts, s + p + 17, total);
      p += 17 + static_cast<size_t>(total);
    }
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
    fail("corrupt JPEG: bad Huffman code");
  }

  static int extend(uint32_t v, int s) {
    return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1 : static_cast<int>(v);
  }

  // One sequential block's coefficients (natural order, int16 as libjpeg's
  // JCOEF); coef null: decoded to stay in step, then dropped.
  static void decode_block(BitReader& br, const Huffman& dc, const Huffman& ac, int& pred,
                           int16_t* coef) {
    int s = decode_huff(br, dc);
    if (s > 15) fail("corrupt JPEG: bad DC magnitude");
    if (s) pred += extend(br.get(s), s);
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
    if (s > 15) fail("corrupt JPEG: bad DC magnitude");
    if (s) pred += extend(br.get(s), s);
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

  // The position of the next marker that is not a restart marker, from p on:
  // where a scan that no needed component is in ends.
  size_t skip_scan(size_t p) const {
    for (; p + 1 < n_; ++p) {
      if (d_[p] != 0xFF) continue;
      const uint8_t m = d_[p + 1];
      if (m != 0x00 && m != 0xFF && !(m >= 0xD0 && m <= 0xD7)) return p;
    }
    return n_;
  }

  // Returns the position after the scan's entropy-coded data.
  size_t scan(const uint8_t* s, size_t n, size_t data_start) {
    if (n < 1) fail("corrupt JPEG: SOS");
    const int ns = s[0];
    if (ns < 1 || ns > 4 || n < 4 + 2 * static_cast<size_t>(ns)) fail("corrupt JPEG: SOS");
    const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns];
    const int ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    int idx[4], td[4], ta[4];
    bool any_needed = false;
    for (int i = 0; i < ns; ++i) {
      int cs = s[1 + 2 * i];
      idx[i] = -1;
      for (size_t c = 0; c < comps_.size(); ++c)
        if (comps_[c].id == cs) idx[i] = static_cast<int>(c);
      if (idx[i] < 0) fail("corrupt JPEG: scan names an unknown component");
      td[i] = s[2 + 2 * i] >> 4;
      ta[i] = s[2 + 2 * i] & 15;
      if (td[i] > 3 || ta[i] > 3) fail("JPEG scan without its Huffman tables is not supported");
      any_needed = any_needed || comps_[idx[i]].needed;
    }
    // jdinput.c per_scan_setup: an interleaved MCU holds at most 10 blocks
    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += comps_[idx[i]].h * comps_[idx[i]].v;
    if (ns > 1 && blocks > 10) fail("corrupt JPEG: more than 10 blocks in an MCU");
    const bool dc_band = ss == 0;
    if (progressive_) {
      // jdphuff.c start_pass_phuff_decoder's checks
      bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) fail("corrupt JPEG: bad progression parameters in a scan");
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = comps_[idx[i]];
      // jdinput.c latch_quant_tables: a component's table is the one defined
      // when its first scan starts
      if (!c.scanned) {
        if (!qt_defined_[c.tq]) fail("corrupt JPEG: quantisation table missing");
        for (int k = 0; k < 64; ++k) c.qt[k] = static_cast<int16_t>(qt_[c.tq][k]);
        c.scanned = true;
      } else if (!progressive_ && c.needed) {
        fail("corrupt JPEG: two scans of one component");
      }
      if (progressive_)
        for (int k = ss; k <= std::min(se, 63); ++k) c.coef_bits[k] = al;
      bool need_dc = !progressive_ || (dc_band && ah == 0);
      bool need_ac = !progressive_ || !dc_band;
      if ((need_dc && !dc_[td[i]].defined) || (need_ac && !ac_[ta[i]].defined))
        fail("JPEG scan without its Huffman tables is not supported");
    }
    if (!any_needed) return skip_scan(data_start);

    long long total, per_row;
    if (ns == 1) {
      // a single-component scan: one block per MCU, over the component's
      // own extent (not padded to the interleaved MCU)
      per_row = comps_[idx[0]].bw;
      total = per_row * comps_[idx[0]].bh;
    } else {
      per_row = mcux_;
      total = static_cast<long long>(mcux_) * mcuy_;
    }
    BitReader br(d_, n_, data_start);
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int16_t scratch[64];
    int next_rst = 0;
    for (long long m = 0; m < total; ++m) {
      if (restart_interval_ && m > 0 && m % restart_interval_ == 0) {
        if (br.overran()) fail("truncated or corrupt JPEG entropy-coded data");
        size_t p = br.next_marker();
        if (p + 1 >= n_ || d_[p + 1] != 0xD0 + next_rst)
          fail("corrupt JPEG: restart marker missing or out of order");
        next_rst = (next_rst + 1) & 7;
        br.restart_at(p + 2);
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun = 0;
      }
      const long long my = m / per_row, mx = m % per_row;
      for (int i = 0; i < ns; ++i) {
        Component& c = comps_[idx[i]];
        const int bx = ns == 1 ? 1 : c.h, by = ns == 1 ? 1 : c.v;
        for (int v = 0; v < by; ++v) {
          for (int h = 0; h < bx; ++h) {
            const size_t row = static_cast<size_t>(my * by + v);
            const size_t col = static_cast<size_t>(mx * bx + h);
            if (!progressive_) {
              if (c.needed) {
                std::memset(scratch, 0, sizeof(scratch));
                decode_block(br, dc_[td[i]], ac_[ta[i]], pred[i], scratch);
                idct_islow(scratch, c.qt, c.plane.data() + row * 8 * c.stride + col * 8,
                           c.stride);
              } else {
                decode_block(br, dc_[td[i]], ac_[ta[i]], pred[i], nullptr);
              }
              continue;
            }
            int16_t* coef = c.needed ? c.coef.data() + (row * c.bwp + col) * 64 : scratch;
            if (dc_band) {
              if (ah == 0) {
                dc_first(br, dc_[td[i]], pred[i], al, coef);
              } else if (br.get(1)) {
                coef[0] = static_cast<int16_t>(coef[0] | (1 << al));
              }
            } else if (ah == 0) {
              ac_first(br, ac_[ta[i]], ss, se, al, eobrun, coef);
            } else {
              ac_refine(br, ac_[ta[i]], ss, se, al, eobrun, coef);
            }
          }
        }
      }
    }
    if (br.overran()) fail("truncated or corrupt JPEG entropy-coded data");
    return br.next_marker();
  }

  // After the last scan: every needed component was scanned; a progressive
  // file's coefficients through the inverse DCT.
  void finish() {
    for (size_t c = 0; c < comps_.size(); ++c)
      if (comps_[c].needed && !comps_[c].scanned)
        fail(c == 0 ? "truncated JPEG: no scan of the luma component"
                    : "truncated JPEG: no scan of component " + std::to_string(c));
    if (!progressive_) return;
    check_no_smoothing();
    for (Component& c : comps_) {
      if (!c.needed) continue;
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bwp + bx) * 64, c.qt,
                     c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8, c.stride);
      std::vector<int16_t>().swap(c.coef);
    }
  }

  // libjpeg smooths the blocks of a progressive file (jdcoefct.c
  // decompress_smooth_data, on by default) where its scans leave one of the
  // first nine AC coefficients short of its last bit; smoothing_ok() lets it
  // run only when every component has its DC and nonzero first ten
  // quantisers.  That estimate is not reproduced: such a file is refused.
  void check_no_smoothing() const {
    bool useful = false;
    for (const Component& c : comps_) {
      if (!c.scanned || c.coef_bits[0] < 0) return;
      for (int k = 0; k < 10; ++k)
        if (c.qt[kNatural[k]] == 0) return;
      for (int k = 1; k < 10; ++k) useful = useful || c.coef_bits[k] != 0;
    }
    if (!useful) return;
    for (const Component& c : comps_) {
      if (!c.needed) continue;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          fail("progressive JPEG whose scans leave low-frequency AC coefficients unrefined "
               "(libjpeg's block smoothing) is not supported");
    }
  }

  // The component's samples at the output size, as libjpeg-turbo's
  // jdsample.c makes them (do_fancy_upsampling on, its default): the
  // triangle filters for 2:1 horizontally (h2v1, more than 2 samples wide),
  // 2:1 vertically (h1v2) and both (h2v2, more than 2 wide); otherwise
  // integral replication.  Rows above the first and below the last sample
  // row repeat it (jdmainct.c's context rows).
  void upsample(const Component& c, uint8_t* out) const {
    const int W = width_, H = height_;
    const uint8_t* p = c.plane.data();
    const size_t st = c.stride;
    const int hx = hmax_ / c.h, vx = vmax_ / c.v;
    const int dw = c.dw, dh = c.dh;
    std::vector<uint8_t> row(static_cast<size_t>(2) * dw + 2);
    auto clamp_row = [&](int r) { return p + static_cast<size_t>(std::min(std::max(r, 0), dh - 1)) * st; };
    for (int y = 0; y < H; ++y) {
      uint8_t* o = out + static_cast<size_t>(y) * W;
      if (hx == 1 && vx == 1) {
        std::memcpy(o, p + static_cast<size_t>(y) * st, static_cast<size_t>(W));
      } else if (hx == 2 && vx == 1 && dw > 2) {
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
      } else if (hx == 1 && vx == 2) {
        const int i = y / 2;
        const bool above = y % 2 == 0;
        const uint8_t* in0 = clamp_row(i);
        const uint8_t* in1 = clamp_row(above ? i - 1 : i + 1);
        const int bias = above ? 1 : 2;
        for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      } else if (hx == 2 && vx == 2 && dw > 2) {
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

  // libjpeg's jpeg_idct_islow (jidctint.c), its "slow but accurate" integer
  // inverse DCT, bit for bit: columns first, dequantised, into an int
  // workspace scaled by 2^PASS1_BITS; then rows, through libjpeg's range-limit
  // table, indexed by the value & RANGE_MASK.  (libjpeg skips the arithmetic
  // of a column whose AC terms are all zero; that shortcut gives the same
  // values, and is kept for speed.)
  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride) {
    static const RangeLimit limit;
    auto descale = [](int64_t x, int n) -> int64_t { return (x + (int64_t(1) << (n - 1))) >> n; };
    int ws[64];
    int64_t v[8], o[8];
    for (int c = 0; c < 8; ++c) {
      for (int r = 0; r < 8; ++r) v[r] = static_cast<int>(in[8 * r + c]) * q[8 * r + c];
      if (!in[8 + c] && !in[16 + c] && !in[24 + c] && !in[32 + c] && !in[40 + c] &&
          !in[48 + c] && !in[56 + c]) {
        const int dc = static_cast<int>(static_cast<uint64_t>(v[0]) << kPass1Bits);
        for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
        continue;
      }
      idct_1d(v, o);
      for (int r = 0; r < 8; ++r)
        ws[8 * r + c] = static_cast<int>(descale(o[r], kConstBits - kPass1Bits));
    }
    for (int r = 0; r < 8; ++r) {
      for (int c = 0; c < 8; ++c) v[c] = ws[8 * r + c];
      idct_1d(v, o);
      for (int c = 0; c < 8; ++c)
        out[r * stride + c] = limit[static_cast<int>(descale(o[c], kConstBits + kPass1Bits + 3))];
    }
  }

  // One 8-point pass of jpeg_idct_islow over v[0..7]: the eight sums before
  // the pass's descaling, in output order.
  static void idct_1d(const int64_t* v, int64_t* o) {
    // even part: the rotator is sqrt(2)·c(−6)
    int64_t z1 = (v[2] + v[6]) * kFix0_541196100;
    int64_t tmp2 = z1 + v[6] * -kFix1_847759065;
    int64_t tmp3 = z1 + v[2] * kFix0_765366865;
    int64_t tmp0 = (v[0] + v[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (v[0] - v[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    // odd part: y7, y5, y3, y1
    tmp0 = v[7];
    tmp1 = v[5];
    tmp2 = v[3];
    tmp3 = v[1];
    z1 = tmp0 + tmp3;
    int64_t z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * kFix1_175875602;
    tmp0 *= kFix0_298631336;
    tmp1 *= kFix2_053119869;
    tmp2 *= kFix3_072711026;
    tmp3 *= kFix1_501321110;
    z1 *= -kFix0_899976223;
    z2 *= -kFix2_562915447;
    z3 = z3 * -kFix1_961570560 + z5;
    z4 = z4 * -kFix0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = tmp10 + tmp3;
    o[7] = tmp10 - tmp3;
    o[1] = tmp11 + tmp2;
    o[6] = tmp11 - tmp2;
    o[2] = tmp12 + tmp1;
    o[5] = tmp12 - tmp1;
    o[3] = tmp13 + tmp0;
    o[4] = tmp13 - tmp0;
  }

  // libjpeg's post-IDCT range limit (jdmaster.c prepare_range_limit_table),
  // indexed by the centred value & 1023: x + 128 for x in [0, 128), 255 on
  // [128, 512), 0 on [512, 896), x − 896 on [896, 1024).
  struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
      for (int x = 0; x < 1024; ++x)
        t[x] = x < 128 ? static_cast<uint8_t>(x + 128) : x < 512 ? 255 : x < 896 ? 0
                                                               : static_cast<uint8_t>(x - 896);
    }
    uint8_t operator[](int v) const { return t[v & 1023]; }
  };
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
// gammas' product strays 5% from 1), ``eq16`` (16 → 8 bits).
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
    if (depth <= 8) {
      table8(to1, fp_reciprocal(file_gamma));
      table8(from1, fp_reciprocal(screen));
      table8(eq8, fp_reciprocal2(file_gamma, screen));
      return;
    }
    // the insignificant bits (sBIT), at least 16 − PNG_MAX_GAMMA_8 (11) as
    // png_set_strip_16 asks, at most 8
    shift = sig_bit > 0 && sig_bit < 16 ? 16 - sig_bit : 0;
    shift = std::min(std::max(shift, 5), 8);
    table16(&to1_16, fp_reciprocal(file_gamma));
    table16(&from1_16, fp_reciprocal(screen));
    // the 16→8 table inverts the file-to-screen gamma it is given: the
    // reciprocal of the reciprocal (fitted to cv2.imread's gray pixels over
    // every 16-bit value at gAMAs 5 to 2^31 − 1; png_product2 misses some)
    table16to8(&eq16, fp_reciprocal(fp_reciprocal2(file_gamma, screen)));
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
