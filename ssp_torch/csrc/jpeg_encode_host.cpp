// A baseline JPEG encoder for 8-bit gray images, on the host, without
// OpenCV or libjpeg.
//
// It writes the file that ``cv2.imwrite(path, img, [IMWRITE_JPEG_QUALITY, q])``
// writes for a uint8 [H, W] image (OpenCV 5.0 on libjpeg-turbo 3.1, with
// its x86 SIMD code), byte for byte.  OpenCV's JpegEncoder asks libjpeg for
// ``jpeg_set_defaults`` and ``jpeg_set_quality(q, TRUE)`` on one gray
// component; so:
//
// * the markers: SOI; the JFIF APP0 (version 1.01, no units, density 1:1,
//   no thumbnail); DQT of table 0; SOF0 (8 bits, one component, id 1,
//   sampling 1x1, table 0); DHT of the DC and of the AC luminance table of
//   Annex K (the only two the scan uses); SOS (Ss 0, Se 63); the entropy
//   coded data; EOI.  No restarts, no optimised tables, not progressive;
// * the quantisation table: jcparam.c's luminance table scaled by
//   ``jpeg_quality_scaling`` (5000 / q below 50, 200 - 2q from 50), each
//   entry (base * scale + 50) / 100 clamped to [1, 255];
// * the samples: the image edge-replicated to whole 8x8 blocks (jcsample.c's
//   expand_right_edge, jcprepct.c's expand_bottom_edge), centred by 128;
// * the forward DCT: jfdctint.c's ``jpeg_fdct_islow`` (13-bit constants,
//   2 extra bits between the passes); libjpeg-turbo's AVX2 version computes
//   the same integers;
// * quantisation as jcdctmgr.c does it, by a reciprocal and a correction
//   (``compute_reciprocal``, ``quantize``): q = ((|x| + c) * recip) >> r,
//   the sign restored, for the divisor 8 * table entry;
// * Huffman coding as jchuff.c: DC differences from 0, AC run lengths with
//   ZRL and EOB, 0xFF stuffed with 0x00, the last byte padded with 1-bits.
//
// Integer arithmetic throughout.  A plain C interface for ctypes.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// jcparam.c's std_luminance_quant_tbl, in natural order
constexpr int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

// zigzag position -> natural position (jutils.c's jpeg_natural_order)
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K (jstdhuff.c): code counts by length 1..16, then the symbols
constexpr uint8_t kDcBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcVals[162] = {
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

// jchuff.c's jpeg_make_c_derived_tbl: the canonical code of each symbol
struct HuffTable {
  uint32_t code[256] = {};
  uint8_t size[256] = {};
  HuffTable(const uint8_t* bits, const uint8_t* vals) {
    uint32_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; len++) {
      for (int i = 0; i < bits[len - 1]; i++, k++) {
        code[vals[k]] = c++;
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c's compute_reciprocal for libjpeg-turbo's 16-bit DCTELEM:
// reciprocal, correction (rounding) and total shift of one divisor
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) b++;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  const uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {static_cast<uint32_t>(fq), c, r};
}

// jfdctint.c's jpeg_fdct_islow, in place on 64 centred samples
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (int32_t(1) << (n - 1))) >> n; }

void fdct_islow(int32_t* data) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8;     // along a row, then along a column
    const int stride = pass == 0 ? 8 : 1;   // to the next row / column
    const int odd = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
    for (int line = 0; line < 8; line++) {
      int32_t* d = data + line * stride;
      auto at = [d, step](int i) -> int32_t& { return d[i * step]; };
      const int32_t tmp0 = at(0) + at(7), tmp7 = at(0) - at(7);
      const int32_t tmp1 = at(1) + at(6), tmp6 = at(1) - at(6);
      const int32_t tmp2 = at(2) + at(5), tmp5 = at(2) - at(5);
      const int32_t tmp3 = at(3) + at(4), tmp4 = at(3) - at(4);
      const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        at(0) = (tmp10 + tmp11) * (1 << PASS1_BITS);
        at(4) = (tmp10 - tmp11) * (1 << PASS1_BITS);
      } else {
        at(0) = descale(tmp10 + tmp11, PASS1_BITS);
        at(4) = descale(tmp10 - tmp11, PASS1_BITS);
      }
      int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      at(2) = descale(z1 + tmp13 * FIX_0_765366865, odd);
      at(6) = descale(z1 + tmp12 * -FIX_1_847759065, odd);

      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int32_t z5 = (z3 + z4) * FIX_1_175875602;
      const int32_t t4 = tmp4 * FIX_0_298631336, t5 = tmp5 * FIX_2_053119869;
      const int32_t t6 = tmp6 * FIX_3_072711026, t7 = tmp7 * FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 = z3 * -FIX_1_961570560 + z5;
      z4 = z4 * -FIX_0_390180644 + z5;
      at(7) = descale(t4 + z1 + z3, odd);
      at(5) = descale(t5 + z2 + z4, odd);
      at(3) = descale(t6 + z2 + z3, odd);
      at(1) = descale(t7 + z1 + z4, odd);
    }
  }
}

// jchuff.c's bit buffer: whole bytes out as they fill, 0xFF stuffed
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;
  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((uint32_t(1) << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      const uint8_t byte = static_cast<uint8_t>(acc >> (nbits - 8));
      out.push_back(byte);
      if (byte == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() { put(0x7F, 7); nbits = 0; }  // pad the last byte with 1-bits
};

void marker(std::vector<uint8_t>& out, uint8_t m, size_t length) {
  out.insert(out.end(), {0xFF, m, static_cast<uint8_t>(length >> 8),
                         static_cast<uint8_t>(length & 0xFF)});
}

void dht(std::vector<uint8_t>& out, uint8_t index, const uint8_t* bits, const uint8_t* vals) {
  int count = 0;
  for (int i = 0; i < 16; i++) count += bits[i];
  marker(out, 0xC4, 2 + 1 + 16 + count);
  out.push_back(index);
  out.insert(out.end(), bits, bits + 16);
  out.insert(out.end(), vals, vals + count);
}

// jcparam.c's jpeg_quality_scaling and jpeg_add_quant_table (force_baseline)
void quant_table(int quality, int* table) {
  quality = quality <= 0 ? 1 : quality > 100 ? 100 : quality;
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long v = (kLumaQuant[i] * scale + 50) / 100;
    table[i] = static_cast<int>(v <= 0 ? 1 : v > 255 ? 255 : v);
  }
}

}  // namespace

extern "C" {

// The bytes of cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality]) of a
// uint8 gray [h, w] image into out[cap]; returns the length, or -1 if cap is
// too small (ssp_jpeg_encode_bound gives enough).
int64_t ssp_jpeg_encode_gray(const uint8_t* img, int h, int w, int quality, uint8_t* out,
                             int64_t cap) {
  int table[64];
  quant_table(quality, table);
  Divisor div[64];
  for (int i = 0; i < 64; i++) div[i] = reciprocal(static_cast<uint32_t>(table[i]) << 3);

  std::vector<uint8_t> buf;
  buf.reserve(1024 + static_cast<size_t>(h) * w / 2);
  buf.insert(buf.end(), {0xFF, 0xD8});
  marker(buf, 0xE0, 16);
  buf.insert(buf.end(), {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  marker(buf, 0xDB, 2 + 1 + 64);
  buf.push_back(0);
  for (int k = 0; k < 64; k++) buf.push_back(static_cast<uint8_t>(table[kNatural[k]]));
  marker(buf, 0xC0, 8 + 3);
  buf.insert(buf.end(), {8, static_cast<uint8_t>(h >> 8), static_cast<uint8_t>(h & 0xFF),
                         static_cast<uint8_t>(w >> 8), static_cast<uint8_t>(w & 0xFF), 1, 1,
                         0x11, 0});
  dht(buf, 0x00, kDcBits, kDcVals);
  dht(buf, 0x10, kAcBits, kAcVals);
  marker(buf, 0xDA, 2 + 1 + 2 + 3);
  buf.insert(buf.end(), {1, 1, 0x00, 0, 63, 0});

  static const HuffTable dc(kDcBits, kDcVals), ac(kAcBits, kAcVals);
  BitWriter bits{buf};
  int32_t last_dc = 0;
  int32_t block[64];
  const int bh = (h + 7) / 8, bw = (w + 7) / 8;
  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw; bx++) {
      for (int y = 0; y < 8; y++) {
        const uint8_t* row = img + static_cast<int64_t>(std::min(by * 8 + y, h - 1)) * w;
        for (int x = 0; x < 8; x++) block[y * 8 + x] = row[std::min(bx * 8 + x, w - 1)] - 128;
      }
      fdct_islow(block);
      for (int i = 0; i < 64; i++) {
        const int32_t v = block[i];
        const uint32_t mag = static_cast<uint32_t>(v < 0 ? -v : v);
        const int32_t q = static_cast<int32_t>(
            (static_cast<uint64_t>(mag + div[i].corr) * div[i].recip) >> div[i].shift);
        block[i] = v < 0 ? -q : q;
      }
      // DC: the difference from the previous block's, its category then its bits
      int32_t diff = block[0] - last_dc;
      last_dc = block[0];
      int32_t mag = diff < 0 ? -diff : diff;
      int nb = 0;
      while (mag >> nb) nb++;
      bits.put(dc.code[nb], dc.size[nb]);
      if (nb) bits.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nb);
      // AC: (run, size) symbols in zigzag order, ZRL for 16 zeros, EOB
      int run = 0;
      for (int k = 1; k < 64; k++) {
        const int32_t v = block[kNatural[k]];
        if (v == 0) {
          run++;
          continue;
        }
        for (; run > 15; run -= 16) bits.put(ac.code[0xF0], ac.size[0xF0]);
        mag = v < 0 ? -v : v;
        nb = 0;
        while (mag >> nb) nb++;
        const int sym = (run << 4) + nb;
        bits.put(ac.code[sym], ac.size[sym]);
        bits.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), nb);
        run = 0;
      }
      if (run > 0) bits.put(ac.code[0], ac.size[0]);
    }
  }
  bits.flush();
  buf.insert(buf.end(), {0xFF, 0xD9});
  if (static_cast<int64_t>(buf.size()) > cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

// A capacity that holds any image's file: the markers and, per 8x8 block, at
// most 64 codes of 26 bits, every byte stuffed.
int64_t ssp_jpeg_encode_bound(int h, int w) {
  return 1024 + static_cast<int64_t>((h + 7) / 8) * ((w + 7) / 8) * 64 * 26 * 2 / 8;
}

}  // extern "C"
