// Grayscale image decoding on the host, without OpenCV, libjpeg or libpng.
//
// What ``cv2.imread(path, IMREAD_GRAYSCALE)`` returns, byte for byte:
//
// * JPEG (baseline SOF0 and extended sequential SOF1, 8-bit, Huffman-coded,
//   1 or 3 components): the Y plane as libjpeg computes it for an output
//   colour space of JCS_GRAYSCALE.  Every component's entropy-coded data is
//   decoded to stay in step; only Y goes through the inverse DCT, which is
//   libjpeg's ``jpeg_idct_islow`` (jidctint.c) with its range-limit table.
//   The EXIF orientation of APP1 is applied afterwards, as OpenCV does.
// * PNG rows after inflate (the caller inflates): the five filters undone,
//   then libpng's conversions as OpenCV requests them: gray bit depths below
//   8 expanded, 16-bit samples cut to their high byte, alpha dropped,
//   palette to RGB, and RGB to gray in libpng's 15-bit fixed point,
//   (9797 R + 19234 G + 3737 B) >> 15, truncated (16-bit: rounded at 16 bits
//   first).
//
// Integer arithmetic only.  A plain C interface for ctypes; each entry point
// returns 0, or -1 with a message naming what is not supported or what is
// wrong in ``msg``.

#include <algorithm>
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
};

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* data, size_t size) : d_(data), n_(size) {}

  // Parse the headers up to the first scan: size, components, orientation.
  void read_header() { run(false); }
  // Decode the whole file into the luma plane.
  void decode() { run(true); }

  int height() const { return height_; }
  int width() const { return width_; }
  int orientation() const { return orientation_; }
  const uint8_t* plane() const { return plane_.data(); }
  size_t stride() const { return stride_; }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  int height_ = 0, width_ = 0;
  int orientation_ = 1;
  bool saw_exif_ = false, saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  bool frame_ = false, luma_done_ = false;
  std::vector<Component> comps_;
  int hmax_ = 1, vmax_ = 1;
  uint16_t qt_[4][64] = {};  // natural order
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  int restart_interval_ = 0;
  std::vector<uint8_t> plane_;
  size_t stride_ = 0;

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
      if (m == 0xD9) {  // EOI
        if (full && !luma_done_) fail("truncated JPEG: no scan of the luma component");
        return;
      }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // no payload
      size_t len = u16(pos_);
      if (len < 2 || pos_ + len > n_) fail("truncated JPEG: marker segment past the end");
      const uint8_t* seg = d_ + pos_ + 2;
      size_t slen = len - 2;
      size_t next = pos_ + len;
      switch (m) {
        case 0xC0:
        case 0xC1:
          parse_sof(seg, slen);
          break;
        case 0xC2:
          fail("progressive JPEG (SOF2) is not supported");
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
          check_colour();
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
        if (full && luma_done_) return;  // a missing EOI after complete data
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
    if (nc == 4) fail("CMYK/YCCK JPEG (4 components) is not supported");
    if (nc != 1 && nc != 3) fail(std::to_string(nc) + "-component JPEG is not supported");
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
    if (comps_[0].h != hmax_ || comps_[0].v != vmax_)
      fail("JPEG whose luma is subsampled against a chroma component is not supported");
    frame_ = true;
  }

  // What libjpeg takes the colour space to be (jdapimin.c), for output to
  // gray: YCbCr (Y is the gray plane) or gray; RGB raises.
  void check_colour() const {
    if (comps_.size() != 3) return;
    bool rgb;
    if (saw_jfif_) {
      rgb = false;
    } else if (saw_adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
    }
    if (rgb) fail("RGB-coded JPEG (Adobe transform 0 or R,G,B component ids) is not supported");
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

  // One block's coefficients (natural order, int16 as libjpeg's JCOEF).
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

  // Returns the position after the scan's entropy-coded data.
  size_t scan(const uint8_t* s, size_t n, size_t data_start) {
    if (n < 1) fail("corrupt JPEG: SOS");
    int ns = s[0];
    if (ns < 1 || ns > 4 || n < 4 + 2 * static_cast<size_t>(ns)) fail("corrupt JPEG: SOS");
    int idx[4], td[4], ta[4];
    bool has_luma = false;
    for (int i = 0; i < ns; ++i) {
      int cs = s[1 + 2 * i];
      idx[i] = -1;
      for (size_t c = 0; c < comps_.size(); ++c)
        if (comps_[c].id == cs) idx[i] = static_cast<int>(c);
      if (idx[i] < 0) fail("corrupt JPEG: scan names an unknown component");
      td[i] = s[2 + 2 * i] >> 4;
      ta[i] = s[2 + 2 * i] & 15;
      if (td[i] > 3 || ta[i] > 3 || !dc_[td[i]].defined || !ac_[ta[i]].defined)
        fail("JPEG scan without its Huffman tables is not supported");
      if (idx[i] == 0) has_luma = true;
    }
    if (has_luma && luma_done_) fail("corrupt JPEG: two scans of the luma component");

    const int mcux = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    const int mcuy = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    if (has_luma) {
      if (!qt_defined_[comps_[0].tq]) fail("corrupt JPEG: luma quantisation table missing");
      stride_ = static_cast<size_t>(mcux) * hmax_ * 8;
      plane_.assign(stride_ * mcuy * vmax_ * 8, 0);
    }
    int16_t qt[64];
    for (int i = 0; i < 64; ++i) qt[i] = static_cast<int16_t>(qt_[comps_[0].tq][i]);

    BitReader br(d_, n_, data_start);
    int pred[4] = {0, 0, 0, 0};
    int16_t coef[64];
    long long total, per_row;
    if (ns == 1) {
      // a single-component scan: one block per MCU, over the component's
      // own extent (not padded to the interleaved MCU)
      const Component& c = comps_[idx[0]];
      int bw = ((width_ * c.h + hmax_ - 1) / hmax_ + 7) / 8;
      int bh = ((height_ * c.v + vmax_ - 1) / vmax_ + 7) / 8;
      per_row = bw;
      total = static_cast<long long>(bw) * bh;
    } else {
      per_row = mcux;
      total = static_cast<long long>(mcux) * mcuy;
    }
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
      }
      const long long my = m / per_row, mx = m % per_row;
      for (int i = 0; i < ns; ++i) {
        const Component& c = comps_[idx[i]];
        const int bx = ns == 1 ? 1 : c.h, by = ns == 1 ? 1 : c.v;
        for (int v = 0; v < by; ++v) {
          for (int h = 0; h < bx; ++h) {
            if (idx[i] == 0) {
              std::memset(coef, 0, sizeof(coef));
              decode_block(br, dc_[td[i]], ac_[ta[i]], pred[i], coef);
              const size_t row = static_cast<size_t>((my * by + v) * 8);
              const size_t col = static_cast<size_t>((mx * bx + h) * 8);
              idct_islow(coef, qt, plane_.data() + row * stride_ + col, stride_);
            } else {
              decode_block(br, dc_[td[i]], ac_[ta[i]], pred[i], nullptr);
            }
          }
        }
      }
    }
    if (br.overran()) fail("truncated or corrupt JPEG entropy-coded data");
    if (has_luma) luma_done_ = true;
    return br.next_marker();
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

void png_gray(const uint8_t* raw, size_t len, int h, int w, int depth, int color_type,
              const uint8_t* palette, uint8_t* out) {
  const int ch = png_channels(color_type);
  if (ch == 0) fail("corrupt PNG: bad colour type");
  const size_t bits = static_cast<size_t>(w) * ch * depth;
  const size_t rowbytes = (bits + 7) / 8;
  const int bpp = std::max(1, ch * depth / 8);
  if (len < static_cast<size_t>(h) * (rowbytes + 1)) fail("truncated PNG: too little image data");
  std::vector<uint8_t> prev(rowbytes, 0), cur(rowbytes, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = raw + static_cast<size_t>(y) * (rowbytes + 1);
    const int filter = src[0];
    ++src;
    uint8_t* c = cur.data();
    const uint8_t* p = prev.data();
    switch (filter) {
      case 0:
        std::memcpy(c, src, rowbytes);
        break;
      case 1:
        for (size_t i = 0; i < rowbytes; ++i)
          c[i] = static_cast<uint8_t>(src[i] + (i >= static_cast<size_t>(bpp) ? c[i - bpp] : 0));
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; ++i) c[i] = static_cast<uint8_t>(src[i] + p[i]);
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; ++i) {
          int a = i >= static_cast<size_t>(bpp) ? c[i - bpp] : 0;
          c[i] = static_cast<uint8_t>(src[i] + ((a + p[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; ++i) {
          bool left = i >= static_cast<size_t>(bpp);
          int a = left ? c[i - bpp] : 0, cc = left ? p[i - bpp] : 0;
          c[i] = static_cast<uint8_t>(src[i] + paeth(a, p[i], cc));
        }
        break;
      default:
        fail("corrupt PNG: filter type " + std::to_string(filter));
    }
    uint8_t* o = out + static_cast<size_t>(y) * w;
    if (color_type == 0 || color_type == 3) {
      for (int x = 0; x < w; ++x) {
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
          o[x] = rgb8_gray(rgb[0], rgb[1], rgb[2]);
        } else {
          o[x] = static_cast<uint8_t>(v);
        }
      }
    } else if (color_type == 4) {
      const int step = depth == 16 ? 4 : 2;
      for (int x = 0; x < w; ++x) o[x] = c[step * x];
    } else {
      if (depth == 8) {
        for (int x = 0; x < w; ++x) {
          const uint8_t* px = c + static_cast<size_t>(ch) * x;
          o[x] = rgb8_gray(px[0], px[1], px[2]);
        }
      } else {
        for (int x = 0; x < w; ++x) {
          const uint8_t* px = c + static_cast<size_t>(2 * ch) * x;
          o[x] = rgb16_gray((px[0] << 8) | px[1], (px[2] << 8) | px[3], (px[4] << 8) | px[5]);
        }
      }
    }
    cur.swap(prev);
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
    orient(dec.plane(), dec.stride(), dec.height(), dec.width(), dec.orientation(), out);
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

// Unfilter the inflated rows of a non-interlaced PNG [h, w] and convert them
// to gray into out (the oriented shape: [w, h] for orientations 5-8).
// ``palette`` holds 256 RGB entries (zeros past the PLTE chunk's).
int ssp_png_gray(const uint8_t* raw, size_t len, int h, int w, int depth, int color_type,
                 const uint8_t* palette, int orientation, uint8_t* out, char* msg, int cap) {
  try {
    if (orientation == 1) {
      png_gray(raw, len, h, w, depth, color_type, palette, out);
    } else {
      std::vector<uint8_t> plane(static_cast<size_t>(h) * w);
      png_gray(raw, len, h, w, depth, color_type, palette, plane.data());
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
