// OpenCV 5.0's SIFT and ORB detectors and descriptors on the host, without
// OpenCV: the classical baselines of the HPatches evaluation.
//
// Each routine follows OpenCV's portable code path (the one
// ``cv2.setUseOptimized(False)`` selects on x86-64: the SSE3 baseline of
// the universal intrinsics, 4 float lanes, no FMA, no IPP), operation for
// operation, in OpenCV's float and double choices and its order of
// summation, so the bytes are OpenCV's:
//
// * ``getGaussianKernel`` (the bit-exact double kernel, cast to float), the
//   separable float ``GaussianBlur`` with ``BORDER_REFLECT_101`` (a full row
//   pass summed left to right, then a symmetric column pass), and the float
//   kernel on 8-bit images (ORB blurs a sub-matrix of its pyramid, which
//   OpenCV does not hand to its fixed-point path);
// * ``resize``: ``INTER_LINEAR`` and ``INTER_NEAREST`` on float,
//   ``INTER_LINEAR_EXACT`` on 8-bit (8-bit fixed-point taps);
// * ``copyMakeBorder`` with ``BORDER_REFLECT_101``;
// * ``hal::exp32f`` (its table and polynomial), ``fastAtan2``
//   and ``magnitude32f``;
// * ``KeyPointsFilter``: ``runByImageBorder``, ``removeDuplicatedSorted``
//   and ``retainBest`` (``std::nth_element`` then ``std::partition``: with
//   libstdc++ the survivors among tied responses are OpenCV's);
// * SIFT (``nOctaveLayers`` 3, contrast 0.04, edge 10, sigma 1.6, the image
//   doubled first): the Gaussian and difference-of-Gaussian pyramids, the
//   scale-space extrema with their interpolation and orientation
//   histograms, the 4 x 4 x 8 descriptor clipped at 0.2 and saturated to
//   uchar (stored as float);
// * ORB (8 levels, scale 1.2, FAST-9 threshold 20, edge 31, patch 31,
//   WTA_K 2, Harris score): the bordered pyramid, FAST with non-maximum
//   suppression, the Harris response, the per-level budget, the intensity
//   centroid angle and rBRIEF on ``bit_pattern_31_`` (orb_pattern.h).
//
// The routines take OpenCV's arguments of those two detectors and no
// others.  Build without -ffast-math, without -march and without FMA
// contraction (kernels/_build.py): OpenCV's baseline code has no FMA.  A
// plain C interface for ctypes.

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cstddef>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "cv_common.h"
#include "orb_pattern.h"

namespace {

// ------------------------------------------------------------------ basics

using sspcv::cv_ceil;
using sspcv::cv_floor;
using sspcv::cv_round;
using sspcv::reflect101;
using sspcv::sat_u8;

template <typename T>
struct Img {
  int rows = 0, cols = 0;
  std::vector<T> d;
  Img() = default;
  Img(int r, int c) : rows(r), cols(c), d(static_cast<size_t>(r) * c) {}
  T* row(int r) { return d.data() + static_cast<size_t>(r) * cols; }
  const T* row(int r) const { return d.data() + static_cast<size_t>(r) * cols; }
  T at(int r, int c) const { return d[static_cast<size_t>(r) * cols + c]; }
};
using Mat32f = Img<float>;
using Mat8u = Img<uint8_t>;

// ------------------------------------------------------ Gaussian filtering

// getGaussianKernelBitExact for sigma > 0, in IEEE double.
std::vector<double> gaussian_kernel(int n, double sigma) {
  const double scale2 = -0.125 / (sigma * sigma);
  const int n2 = (n - 1) / 2;
  std::vector<double> values(static_cast<size_t>(n2 + 1)), res(static_cast<size_t>(n));
  double sum = 0.0;
  for (int i = 0, x = 1 - n; i < n2; i++, x += 2) {
    const double t = std::exp(static_cast<double>(x * x) * scale2);
    values[i] = t;
    sum += t;
  }
  sum *= 2.0;
  sum += 1.0;
  if ((n & 1) == 0) sum += 1.0;
  const double mul1 = 1.0 / sum;
  for (int i = 0; i < n2; i++) {
    const double t = values[i] * mul1;
    res[i] = t;
    res[n - 1 - i] = t;
  }
  res[n2] = 1.0 * mul1;
  if ((n & 1) == 0) res[n2 + 1] = res[n2];
  return res;
}

std::vector<float> gaussian_kernel_f32(int n, double sigma) {
  const std::vector<double> k = gaussian_kernel(n, sigma);
  return std::vector<float>(k.begin(), k.end());
}

// The kernel size GaussianBlur picks for Size() and sigma > 0 on float.
inline int gaussian_ksize_f32(double sigma) { return cv_round(sigma * 4 * 2 + 1) | 1; }

// The row pass of sepFilter2D: RowFilter (and RowVec_32f / RowVec_8u32f),
// s = k0 * S0, then s += k_j * S_j from left to right.
template <typename T>
void row_pass(const Img<T>& src, Mat32f& dst, const std::vector<float>& k) {
  const int n = static_cast<int>(k.size()), r = n / 2, w = src.cols;
  dst = Mat32f(src.rows, w);
  std::vector<int> xi(static_cast<size_t>(w + 2 * r));
  for (int i = 0; i < w + 2 * r; i++) xi[i] = reflect101(i - r, w);
  std::vector<float> buf(static_cast<size_t>(w + 2 * r));
  for (int y = 0; y < src.rows; y++) {
    const T* s = src.row(y);
    for (int i = 0; i < w + 2 * r; i++) buf[i] = static_cast<float>(s[xi[i]]);
    float* o = dst.row(y);
    for (int x = 0; x < w; x++) {
      const float* S = buf.data() + x;
      float acc = k[0] * S[0];
      for (int j = 1; j < n; j++) acc += k[j] * S[j];
      o[x] = acc;
    }
  }
}

// The symmetric column pass: SymmColumnFilter (and SymmColumnVec_32f /
// _32f8u), s = ky0 * S0 + 0, then s += ky_j * (S_j + S_-j).
template <typename Cast>
void column_pass_symm(const Mat32f& src, int rows_out, const std::vector<float>& k, Cast cast) {
  const int n = static_cast<int>(k.size()), r = n / 2, h = src.rows, w = src.cols;
  const float* ky = k.data() + r;
  std::vector<const float*> rp(static_cast<size_t>(2 * r + 1));
  for (int y = 0; y < rows_out; y++) {
    for (int j = -r; j <= r; j++) rp[j + r] = src.row(reflect101(y + j, h));
    const float* const* R = rp.data() + r;
    for (int x = 0; x < w; x++) {
      float acc = ky[0] * R[0][x] + 0.0f;
      for (int j = 1; j <= r; j++) acc += ky[j] * (R[j][x] + R[-j][x]);
      cast(y, x, acc);
    }
  }
}

// GaussianBlur(src, dst, Size(), sigma, sigma) on float.
void gaussian_blur_f32(const Mat32f& src, Mat32f& dst, double sigma) {
  const std::vector<float> k = gaussian_kernel_f32(gaussian_ksize_f32(sigma), sigma);
  Mat32f tmp;
  row_pass(src, tmp, k);
  Mat32f out(src.rows, src.cols);
  column_pass_symm(tmp, src.rows, k, [&](int y, int x, float v) { out.row(y)[x] = v; });
  dst = std::move(out);
}

// GaussianBlur of an 8-bit image through sepFilter2D's float path (the path
// of a sub-matrix without BORDER_ISOLATED): float kernel, float rows, the
// column sum rounded half to even and saturated.  ``src`` is the whole
// image; the result is written for every pixel.
void gaussian_blur_u8_float(const Mat8u& src, Mat8u& dst, int ksize, double sigma) {
  const std::vector<float> k = gaussian_kernel_f32(ksize, sigma);
  Mat32f tmp;
  row_pass(src, tmp, k);
  Mat8u out(src.rows, src.cols);
  column_pass_symm(tmp, src.rows, k,
                   [&](int y, int x, float v) { out.row(y)[x] = sat_u8(cv_round(v)); });
  dst = std::move(out);
}

// ------------------------------------------------------------------ resize

// resize(..., INTER_NEAREST) on float.
void resize_nearest_f32(const Mat32f& src, Mat32f& dst, int dw, int dh) {
  const double ifx = 1. / (static_cast<double>(dw) / src.cols);
  const double ify = 1. / (static_cast<double>(dh) / src.rows);
  std::vector<int> xo(static_cast<size_t>(dw));
  for (int x = 0; x < dw; x++) xo[x] = std::min(cv_floor(x * ifx), src.cols - 1);
  Mat32f out(dh, dw);
  for (int y = 0; y < dh; y++) {
    const float* s = src.row(std::min(cv_floor(y * ify), src.rows - 1));
    float* o = out.row(y);
    for (int x = 0; x < dw; x++) o[x] = s[xo[x]];
  }
  dst = std::move(out);
}

// The coordinates and float weights of resizeGeneric_'s INTER_LINEAR.
void linear_taps(int ssize, int dsize, std::vector<int>& ofs, std::vector<float>& a) {
  const double scale = 1. / (static_cast<double>(dsize) / ssize);
  ofs.assign(static_cast<size_t>(dsize), 0);
  a.assign(static_cast<size_t>(2 * dsize), 0.f);
  for (int d = 0; d < dsize; d++) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = cv_floor(f);
    f -= s;
    if (s < 0) f = 0, s = 0;
    if (s >= ssize - 1) f = 0, s = ssize - 1;
    ofs[d] = s;
    a[2 * d] = 1.f - f;
    a[2 * d + 1] = f;
  }
}

// resize(..., INTER_LINEAR) on float (HResizeLinear then VResizeLinear).
void resize_linear_f32(const Mat32f& src, Mat32f& dst, int dw, int dh) {
  std::vector<int> xo, yo;
  std::vector<float> ax, ay;
  linear_taps(src.cols, dw, xo, ax);
  linear_taps(src.rows, dh, yo, ay);
  Mat32f hrows(src.rows, dw);
  for (int y = 0; y < src.rows; y++) {
    const float* s = src.row(y);
    float* o = hrows.row(y);
    for (int x = 0; x < dw; x++) {
      const int sx = xo[x];
      o[x] = sx + 1 < src.cols ? s[sx] * ax[2 * x] + s[sx + 1] * ax[2 * x + 1]
                               : s[sx] * ax[2 * x];
    }
  }
  Mat32f out(dh, dw);
  for (int y = 0; y < dh; y++) {
    const float* s0 = hrows.row(yo[y]);
    const float* s1 = hrows.row(std::min(yo[y] + 1, src.rows - 1));
    const float b0 = ay[2 * y], b1 = ay[2 * y + 1];
    float* o = out.row(y);
    for (int x = 0; x < dw; x++) o[x] = s0[x] * b0 + s1[x] * b1;
  }
  dst = std::move(out);
}

// interpolationLinear of resize_bitExact: offsets and 8-bit fixed-point
// taps; [lo, hi) is the range of outputs with two source samples.
void linear_exact_taps(int ssize, int dsize, std::vector<int>& ofs, std::vector<uint32_t>& c,
                       int& lo, int& hi) {
  const double scale = 1.0 / (static_cast<double>(dsize) / ssize);
  ofs.assign(static_cast<size_t>(dsize), 0);
  c.assign(static_cast<size_t>(2 * dsize), 0);
  lo = 0;
  hi = dsize;
  for (int d = 0; d < dsize; d++) {
    const double f = scale * (static_cast<double>(d) + 0.5) - 0.5;
    const int i = cv_floor(f);
    if (i >= 0 && ssize > 1) {
      if (i < ssize - 1) {
        ofs[d] = i;
        const uint32_t c1 = static_cast<uint32_t>(cv_round((f - i) * 256.0));
        c[2 * d + 1] = c1;
        c[2 * d] = 256 - c1;
      } else {
        ofs[d] = ssize - 1;
        hi = std::min(hi, d);
      }
    } else {
      lo = std::max(lo, d + 1);
    }
  }
}

// resize(..., INTER_LINEAR_EXACT) on 8-bit: rows at 8 fractional bits, the
// column sum at 16, rounded half up; outside [lo, hi) the edge sample.
void resize_linear_exact_u8(const Mat8u& src, Mat8u& dst, int dw, int dh) {
  std::vector<int> xo, yo;
  std::vector<uint32_t> cx, cy;
  int xlo, xhi, ylo, yhi;
  linear_exact_taps(src.cols, dw, xo, cx, xlo, xhi);
  linear_exact_taps(src.rows, dh, yo, cy, ylo, yhi);
  auto hline = [&](int sy, uint32_t* o) {
    const uint8_t* s = src.row(sy);
    int x = 0;
    for (; x < xlo; x++) o[x] = static_cast<uint32_t>(s[0]) << 8;
    for (; x < xhi; x++) o[x] = cx[2 * x] * s[xo[x]] + cx[2 * x + 1] * s[xo[x] + 1];
    const uint32_t last = static_cast<uint32_t>(s[xo[dw - 1]]) << 8;
    for (; x < dw; x++) o[x] = last;
  };
  std::vector<uint32_t> l0(static_cast<size_t>(dw)), l1(static_cast<size_t>(dw));
  Mat8u out(dh, dw);
  for (int y = 0; y < dh; y++) {
    uint8_t* o = out.row(y);
    if (y < ylo || y >= yhi) {
      hline(y < ylo ? 0 : src.rows - 1, l0.data());
      for (int x = 0; x < dw; x++) o[x] = sat_u8(static_cast<int>((l0[x] + 128) >> 8));
      continue;
    }
    hline(yo[y], l0.data());
    hline(yo[y] + 1, l1.data());
    const uint32_t c0 = cy[2 * y], c1 = cy[2 * y + 1];
    for (int x = 0; x < dw; x++)
      o[x] = sat_u8(static_cast<int>((l0[x] * c0 + l1[x] * c1 + (1u << 15)) >> 16));
  }
  dst = std::move(out);
}

// copyMakeBorder(src, dst, b, b, b, b, BORDER_REFLECT_101)
void copy_make_border_u8(const Mat8u& src, Mat8u& dst, int b) {
  Mat8u out(src.rows + 2 * b, src.cols + 2 * b);
  for (int y = 0; y < out.rows; y++) {
    const uint8_t* s = src.row(reflect101(y - b, src.rows));
    uint8_t* o = out.row(y);
    for (int x = 0; x < out.cols; x++) o[x] = s[reflect101(x - b, src.cols)];
  }
  dst = std::move(out);
}

// -------------------------------------------------------- elementwise math

// hal::exp32f: 2^(x log2 e) split into a power of two, a 64-entry table of
// 2^(j/64) and a degree-4 polynomial (OpenCV's expTab_f and EXPPOLY).
constexpr double kExpA0 = .9670371139572337719125840413672004409288e-2;
constexpr double kExpPrescale = 1.4426950408889634073599246810019 * (1 << 6);
constexpr double kExpPostscale = 1. / (1 << 6);
constexpr double kExpMax = 3000. * (1 << 6);

struct ExpTable {
  float t[64];
  ExpTable() {
    for (int j = 0; j < 64; j++) t[j] = static_cast<float>(std::exp2(j / 64.0) * kExpA0);
  }
};

void exp32f(const float* x, float* y, int n) {
  static const ExpTable tab;
  const float A4 = static_cast<float>(1.000000000000002438532970795181890933776 / kExpA0);
  const float A3 = static_cast<float>(.6931471805521448196800669615864773144641 / kExpA0);
  const float A2 = static_cast<float>(.2402265109513301490103372422686535526573 / kExpA0);
  const float A1 = static_cast<float>(.5550339366753125211915322047004666939128e-1 / kExpA0);
  const float minval = static_cast<float>(-kExpMax / kExpPrescale);
  const float maxval = static_cast<float>(kExpMax / kExpPrescale);
  const float prescale = static_cast<float>(kExpPrescale);
  const float postscale = static_cast<float>(kExpPostscale);
  for (int i = 0; i < n; i++) {
    float x0 = std::min(std::max(x[i], minval), maxval) * prescale;
    const int xi = cv_round(x0);
    x0 = (x0 - static_cast<float>(xi)) * postscale;
    const int t = std::min(std::max((xi >> 6) + 127, 0), 255);
    const int32_t bits = t << 23;
    float scale;
    std::memcpy(&scale, &bits, sizeof(scale));
    const float p = (((x0 + A1) * x0 + A2) * x0 + A3) * x0 + A4;
    y[i] = tab.t[xi & 63] * scale * p;
  }
}

const float kAtanP1 = 0.9997878412794807f * static_cast<float>(180 / M_PI);
const float kAtanP3 = -0.3258083974640975f * static_cast<float>(180 / M_PI);
const float kAtanP5 = 0.1555786518463281f * static_cast<float>(180 / M_PI);
const float kAtanP7 = -0.04432655554792128f * static_cast<float>(180 / M_PI);

// fastAtan2 in degrees, [0, 360)
inline float fast_atan2(float y, float x) {
  const float ax = std::abs(x), ay = std::abs(y);
  float a;
  if (ax >= ay) {
    const float c = ay / (ax + static_cast<float>(DBL_EPSILON));
    const float c2 = c * c;
    a = (((kAtanP7 * c2 + kAtanP5) * c2 + kAtanP3) * c2 + kAtanP1) * c;
  } else {
    const float c = ax / (ay + static_cast<float>(DBL_EPSILON));
    const float c2 = c * c;
    a = 90.f - (((kAtanP7 * c2 + kAtanP5) * c2 + kAtanP3) * c2 + kAtanP1) * c;
  }
  if (x < 0) a = 180.f - a;
  if (y < 0) a = 360.f - a;
  return a;
}

// ---------------------------------------------------------------- KeyPoint

struct KeyPoint {
  float x, y, size, angle, response;
  int octave, class_id;
};

// KeyPointsFilter::retainBest
void retain_best(std::vector<KeyPoint>& kps, int n) {
  if (n < 0 || kps.size() <= static_cast<size_t>(n)) return;
  if (n == 0) {
    kps.clear();
    return;
  }
  std::nth_element(kps.begin(), kps.begin() + n - 1, kps.end(),
                   [](const KeyPoint& a, const KeyPoint& b) { return a.response > b.response; });
  const float amb = kps[n - 1].response;
  const auto end = std::partition(kps.begin() + n, kps.end(),
                                  [amb](const KeyPoint& k) { return k.response >= amb; });
  kps.resize(static_cast<size_t>(end - kps.begin()));
}

// KeyPointsFilter::removeDuplicatedSorted
void remove_duplicated_sorted(std::vector<KeyPoint>& kps) {
  const int n = static_cast<int>(kps.size());
  if (n < 2) return;
  std::sort(kps.begin(), kps.end(), [](const KeyPoint& a, const KeyPoint& b) {
    if (a.x != b.x) return a.x < b.x;
    if (a.y != b.y) return a.y < b.y;
    if (a.size != b.size) return a.size > b.size;
    if (a.angle != b.angle) return a.angle < b.angle;
    if (a.response != b.response) return a.response > b.response;
    if (a.octave != b.octave) return a.octave > b.octave;
    return a.class_id > b.class_id;
  });
  int i = 0;
  for (int j = 1; j < n; ++j) {
    const KeyPoint& a = kps[i];
    const KeyPoint& b = kps[j];
    if (a.x != b.x || a.y != b.y || a.size != b.size || a.angle != b.angle) kps[++i] = kps[j];
  }
  kps.resize(static_cast<size_t>(i + 1));
}

// KeyPointsFilter::runByImageBorder
void run_by_image_border(std::vector<KeyPoint>& kps, int w, int h, int b) {
  if (b <= 0) return;
  if (h <= b * 2 || w <= b * 2) {
    kps.clear();
    return;
  }
  const float x0 = static_cast<float>(b), y0 = static_cast<float>(b);
  const float x1 = static_cast<float>(w - b), y1 = static_cast<float>(h - b);
  kps.erase(std::remove_if(kps.begin(), kps.end(),
                           [&](const KeyPoint& k) {
                             return !(x0 <= k.x && k.x < x1 && y0 <= k.y && k.y < y1);
                           }),
            kps.end());
}

// -------------------------------------------------------------------- SIFT

constexpr int kSiftLayers = 3;
constexpr double kSiftContrast = 0.04;
constexpr double kSiftEdge = 10;
constexpr double kSiftSigma = 1.6;
constexpr int kSiftImgBorder = 5;
constexpr int kSiftMaxInterpSteps = 5;
constexpr int kSiftOriBins = 36;
constexpr float kSiftOriSigFctr = 1.5f;
constexpr float kSiftOriRadius = 4.5f;
constexpr float kSiftOriPeakRatio = 0.8f;
constexpr int kSiftDescrWidth = 4;
constexpr int kSiftDescrBins = 8;
constexpr float kSiftDescrSclFctr = 3.f;
constexpr float kSiftDescrMagThr = 0.2f;
constexpr float kSiftIntDescrFctr = 512.f;
constexpr float kSiftInitSigma = 0.5f;

struct Sift {
  std::vector<Mat32f> gpyr, dogpyr;
  int n_octaves = 0;

  const Mat32f& gauss(int o, int layer) const { return gpyr[o * (kSiftLayers + 3) + layer]; }
  const Mat32f& dog(int o, int layer) const { return dogpyr[o * (kSiftLayers + 2) + layer]; }

  void build(const Mat8u& img) {
    Mat32f gray(img.rows, img.cols);
    for (size_t i = 0; i < img.d.size(); i++) gray.d[i] = static_cast<float>(img.d[i]);
    const float sigma = static_cast<float>(kSiftSigma);
    const float sig_diff = std::sqrt(
        std::max(sigma * sigma - kSiftInitSigma * kSiftInitSigma * 4, 0.01f));
    Mat32f dbl, base;
    resize_linear_f32(gray, dbl, gray.cols * 2, gray.rows * 2);
    gaussian_blur_f32(dbl, base, sig_diff);

    n_octaves = cv_round(std::log(static_cast<double>(std::min(base.cols, base.rows))) /
                         std::log(2.) - 2) + 1;
    std::vector<double> sig(kSiftLayers + 3);
    sig[0] = kSiftSigma;
    const double k = std::pow(2., 1. / kSiftLayers);
    for (int i = 1; i < kSiftLayers + 3; i++) {
      const double sig_prev = std::pow(k, static_cast<double>(i - 1)) * kSiftSigma;
      const double sig_total = sig_prev * k;
      sig[i] = std::sqrt(sig_total * sig_total - sig_prev * sig_prev);
    }
    gpyr.assign(static_cast<size_t>(n_octaves * (kSiftLayers + 3)), Mat32f());
    for (int o = 0; o < n_octaves; o++) {
      for (int i = 0; i < kSiftLayers + 3; i++) {
        Mat32f& dst = gpyr[o * (kSiftLayers + 3) + i];
        if (o == 0 && i == 0) {
          dst = base;
        } else if (i == 0) {
          const Mat32f& src = gauss(o - 1, kSiftLayers);
          resize_nearest_f32(src, dst, src.cols / 2, src.rows / 2);
        } else {
          gaussian_blur_f32(gauss(o, i - 1), dst, sig[i]);
        }
      }
    }
    dogpyr.assign(static_cast<size_t>(n_octaves * (kSiftLayers + 2)), Mat32f());
    for (int o = 0; o < n_octaves; o++) {
      for (int i = 0; i < kSiftLayers + 2; i++) {
        const Mat32f& a = gauss(o, i);
        const Mat32f& b = gauss(o, i + 1);
        Mat32f& dst = dogpyr[o * (kSiftLayers + 2) + i];
        dst = Mat32f(a.rows, a.cols);
        for (size_t j = 0; j < a.d.size(); j++) dst.d[j] = b.d[j] - a.d[j];
      }
    }
  }

  // adjustLocalExtrema
  bool adjust(KeyPoint& kpt, int octv, int& layer, int& r, int& c) const {
    const float img_scale = 1.f / (255 * 1);
    const float deriv_scale = img_scale * 0.5f;
    const float second_deriv_scale = img_scale;
    const float cross_deriv_scale = img_scale * 0.25f;
    const float contrast = static_cast<float>(kSiftContrast);
    const float edge = static_cast<float>(kSiftEdge);
    float xi = 0, xr = 0, xc = 0, contr = 0;
    int i = 0;
    for (; i < kSiftMaxInterpSteps; i++) {
      const Mat32f& img = dog(octv, layer);
      const Mat32f& prev = dog(octv, layer - 1);
      const Mat32f& next = dog(octv, layer + 1);
      const float dD0 = (img.at(r, c + 1) - img.at(r, c - 1)) * deriv_scale;
      const float dD1 = (img.at(r + 1, c) - img.at(r - 1, c)) * deriv_scale;
      const float dD2 = (next.at(r, c) - prev.at(r, c)) * deriv_scale;
      const float v2 = img.at(r, c) * 2;
      const float dxx = (img.at(r, c + 1) + img.at(r, c - 1) - v2) * second_deriv_scale;
      const float dyy = (img.at(r + 1, c) + img.at(r - 1, c) - v2) * second_deriv_scale;
      const float dss = (next.at(r, c) + prev.at(r, c) - v2) * second_deriv_scale;
      const float dxy = (img.at(r + 1, c + 1) - img.at(r + 1, c - 1) - img.at(r - 1, c + 1) +
                         img.at(r - 1, c - 1)) * cross_deriv_scale;
      const float dxs = (next.at(r, c + 1) - next.at(r, c - 1) - prev.at(r, c + 1) +
                         prev.at(r, c - 1)) * cross_deriv_scale;
      const float dys = (next.at(r + 1, c) - next.at(r - 1, c) - prev.at(r + 1, c) +
                         prev.at(r - 1, c)) * cross_deriv_scale;
      // Matx33f::solve(DECOMP_LU): Cramer's rule (Matx_FastSolveOp<float, 3, 1>)
      const float a[3][3] = {{dxx, dxy, dxs}, {dxy, dyy, dys}, {dxs, dys, dss}};
      const float b[3] = {dD0, dD1, dD2};
      float X[3] = {0, 0, 0};
      float d = static_cast<float>(static_cast<double>(
          a[0][0] * (a[1][1] * a[2][2] - a[2][1] * a[1][2]) -
          a[0][1] * (a[1][0] * a[2][2] - a[2][0] * a[1][2]) +
          a[0][2] * (a[1][0] * a[2][1] - a[2][0] * a[1][1])));
      if (d != 0) {
        d = 1 / d;
        X[0] = d * (b[0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1]) -
                    a[0][1] * (b[1] * a[2][2] - a[1][2] * b[2]) +
                    a[0][2] * (b[1] * a[2][1] - a[1][1] * b[2]));
        X[1] = d * (a[0][0] * (b[1] * a[2][2] - a[1][2] * b[2]) -
                    b[0] * (a[1][0] * a[2][2] - a[1][2] * a[2][0]) +
                    a[0][2] * (a[1][0] * b[2] - b[1] * a[2][0]));
        X[2] = d * (a[0][0] * (a[1][1] * b[2] - b[1] * a[2][1]) -
                    a[0][1] * (a[1][0] * b[2] - b[1] * a[2][0]) +
                    b[0] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]));
      }
      xi = -X[2];
      xr = -X[1];
      xc = -X[0];
      if (std::abs(xi) < 0.5f && std::abs(xr) < 0.5f && std::abs(xc) < 0.5f) break;
      const float big = static_cast<float>(INT_MAX / 3);
      if (std::abs(xi) > big || std::abs(xr) > big || std::abs(xc) > big) return false;
      c += cv_round(xc);
      r += cv_round(xr);
      layer += cv_round(xi);
      if (layer < 1 || layer > kSiftLayers || c < kSiftImgBorder ||
          c >= img.cols - kSiftImgBorder || r < kSiftImgBorder || r >= img.rows - kSiftImgBorder)
        return false;
    }
    if (i >= kSiftMaxInterpSteps) return false;
    {
      const Mat32f& img = dog(octv, layer);
      const Mat32f& prev = dog(octv, layer - 1);
      const Mat32f& next = dog(octv, layer + 1);
      const float dD0 = (img.at(r, c + 1) - img.at(r, c - 1)) * deriv_scale;
      const float dD1 = (img.at(r + 1, c) - img.at(r - 1, c)) * deriv_scale;
      const float dD2 = (next.at(r, c) - prev.at(r, c)) * deriv_scale;
      float t = 0;
      t += dD0 * xc;
      t += dD1 * xr;
      t += dD2 * xi;
      contr = img.at(r, c) * img_scale + t * 0.5f;
      if (std::abs(contr) * kSiftLayers < contrast) return false;
      const float v2 = img.at(r, c) * 2.f;
      const float dxx = (img.at(r, c + 1) + img.at(r, c - 1) - v2) * second_deriv_scale;
      const float dyy = (img.at(r + 1, c) + img.at(r - 1, c) - v2) * second_deriv_scale;
      const float dxy = (img.at(r + 1, c + 1) - img.at(r + 1, c - 1) - img.at(r - 1, c + 1) +
                         img.at(r - 1, c - 1)) * cross_deriv_scale;
      const float tr = dxx + dyy;
      const float det = dxx * dyy - dxy * dxy;
      if (det <= 0 || tr * tr * edge >= (edge + 1) * (edge + 1) * det) return false;
    }
    kpt.x = (c + xc) * (1 << octv);
    kpt.y = (r + xr) * (1 << octv);
    kpt.octave = octv + (layer << 8) + (cv_round((xi + 0.5) * 255) << 16);
    kpt.size = static_cast<float>(kSiftSigma) *
               std::pow(2.f, (layer + xi) / kSiftLayers) * (1 << octv) * 2;
    kpt.response = std::abs(contr);
    kpt.angle = 0;
    kpt.class_id = -1;
    return true;
  }

  // calcOrientationHist
  static float orientation_hist(const Mat32f& img, int px, int py, int radius, float sigma,
                                float* hist) {
    const int n = kSiftOriBins;
    int len = (radius * 2 + 1) * (radius * 2 + 1);
    const float expf_scale = -1.f / (2.f * sigma * sigma);
    std::vector<float> X(len), Y(len), Ori(len), W(len), tbuf(n + 4, 0.f);
    float* temphist = tbuf.data() + 2;
    int k = 0;
    for (int i = -radius; i <= radius; i++) {
      const int y = py + i;
      if (y <= 0 || y >= img.rows - 1) continue;
      for (int j = -radius; j <= radius; j++) {
        const int x = px + j;
        if (x <= 0 || x >= img.cols - 1) continue;
        X[k] = img.at(y, x + 1) - img.at(y, x - 1);
        Y[k] = img.at(y - 1, x) - img.at(y + 1, x);
        W[k] = (i * i + j * j) * expf_scale;
        k++;
      }
    }
    len = k;
    exp32f(W.data(), W.data(), len);
    for (k = 0; k < len; k++) Ori[k] = fast_atan2(Y[k], X[k]);
    for (k = 0; k < len; k++) X[k] = std::sqrt(X[k] * X[k] + Y[k] * Y[k]);
    const float* Mag = X.data();
    const float nd360 = n / 360.f;
    for (k = 0; k < len; k++) {
      int bin = cv_round(nd360 * Ori[k]);
      if (bin >= n) bin -= n;
      if (bin < 0) bin += n;
      temphist[bin] += W[k] * Mag[k];
    }
    temphist[-1] = temphist[n - 1];
    temphist[-2] = temphist[n - 2];
    temphist[n] = temphist[0];
    temphist[n + 1] = temphist[1];
    // the 4-lane form: (t-2 + t2) / 16 + ((t-1 + t1) * 4 / 16 + t0 * 6 / 16)
    for (int i = 0; i < n; i++) {
      const float inner = (temphist[i - 1] + temphist[i + 1]) * (4.f / 16.f) +
                          temphist[i] * (6.f / 16.f);
      hist[i] = (temphist[i - 2] + temphist[i + 2]) * (1.f / 16.f) + inner;
    }
    float maxval = hist[0];
    for (int i = 1; i < n; i++) maxval = std::max(maxval, hist[i]);
    return maxval;
  }

  // findScaleSpaceExtremaT::process
  void process(int o, int layer0, int r, int c, std::vector<KeyPoint>& out) const {
    const int n = kSiftOriBins;
    float hist[kSiftOriBins];
    KeyPoint kpt;
    int r1 = r, c1 = c, layer = layer0;
    if (!adjust(kpt, o, layer, r1, c1)) return;
    const float scl_octv = kpt.size * 0.5f / (1 << o);
    const float omax = orientation_hist(gauss(o, layer), c1, r1,
                                        cv_round(kSiftOriRadius * scl_octv),
                                        kSiftOriSigFctr * scl_octv, hist);
    const float mag_thr = omax * kSiftOriPeakRatio;
    for (int j = 0; j < n; j++) {
      const int l = j > 0 ? j - 1 : n - 1;
      const int r2 = j < n - 1 ? j + 1 : 0;
      if (hist[j] > hist[l] && hist[j] > hist[r2] && hist[j] >= mag_thr) {
        float bin = j + 0.5f * (hist[l] - hist[r2]) / (hist[l] - 2 * hist[j] + hist[r2]);
        bin = bin < 0 ? n + bin : bin >= n ? bin - n : bin;
        kpt.angle = 360.f - ((360.f / n) * bin);
        if (std::abs(kpt.angle - 360.f) < FLT_EPSILON) kpt.angle = 0.f;
        out.push_back(kpt);
      }
    }
  }

  // findScaleSpaceExtrema
  void extrema(std::vector<KeyPoint>& kps) const {
    const int threshold = cv_floor(0.5 * kSiftContrast / kSiftLayers * 255 * 1);
    const float thr = static_cast<float>(threshold);
    kps.clear();
    for (int o = 0; o < n_octaves; o++) {
      for (int i = 1; i <= kSiftLayers; i++) {
        const Mat32f& img = dog(o, i);
        const Mat32f& prev = dog(o, i - 1);
        const Mat32f& next = dog(o, i + 1);
        const int step = img.cols;
        for (int r = kSiftImgBorder; r < img.rows - kSiftImgBorder; r++) {
          const float* cur = img.row(r);
          const float* pp = prev.row(r);
          const float* np = next.row(r);
          for (int c = kSiftImgBorder; c < img.cols - kSiftImgBorder; c++) {
            const float val = cur[c];
            if (std::abs(val) <= thr) continue;
            bool ok = true;
            const float* planes[3] = {cur, pp, np};
            for (int p = 0; p < 3 && ok; p++) {
              const float* q = planes[p];
              for (int dy = -1; dy <= 1 && ok; dy++) {
                for (int dx = -1; dx <= 1; dx++) {
                  if (p == 0 && dy == 0 && dx == 0) continue;
                  const float v = q[c + dy * step + dx];
                  if (val > 0 ? !(val >= v) : !(val <= v)) {
                    ok = false;
                    break;
                  }
                }
              }
            }
            if (ok) process(o, i, r, c, kps);
          }
        }
      }
    }
  }

  // calcSIFTDescriptor into dst[128]
  static void descriptor(const Mat32f& img, float ptx, float pty, float ori, float scl,
                         float* dst) {
    const int d = kSiftDescrWidth, n = kSiftDescrBins;
    const int px = cv_round(ptx), py = cv_round(pty);
    float cos_t = std::cos(ori * static_cast<float>(M_PI / 180));
    float sin_t = std::sin(ori * static_cast<float>(M_PI / 180));
    const float bins_per_rad = n / 360.f;
    const float exp_scale = -1.f / (d * d * 0.5f);
    const float hist_width = kSiftDescrSclFctr * scl;
    int radius = cv_round(hist_width * 1.4142135623730951f * (d + 1) * 0.5f);
    radius = std::min(radius, static_cast<int>(std::sqrt(
                                  static_cast<double>(img.cols) * img.cols +
                                  static_cast<double>(img.rows) * img.rows)));
    cos_t /= hist_width;
    sin_t /= hist_width;
    int len = (radius * 2 + 1) * (radius * 2 + 1);
    const int histlen = (d + 2) * (d + 2) * (n + 2);
    const int rows = img.rows, cols = img.cols;
    std::vector<float> X(len), Y(len), Ori(len), W(len), RBin(len), CBin(len);
    std::vector<float> hist(histlen, 0.f), raw(d * d * n);
    int k = 0;
    for (int i = -radius; i <= radius; i++) {
      for (int j = -radius; j <= radius; j++) {
        const float c_rot = j * cos_t - i * sin_t;
        const float r_rot = j * sin_t + i * cos_t;
        const float rbin = r_rot + d / 2 - 0.5f;
        const float cbin = c_rot + d / 2 - 0.5f;
        const int r = py + i, c = px + j;
        if (rbin > -1 && rbin < d && cbin > -1 && cbin < d && r > 0 && r < rows - 1 && c > 0 &&
            c < cols - 1) {
          X[k] = img.at(r, c + 1) - img.at(r, c - 1);
          Y[k] = img.at(r - 1, c) - img.at(r + 1, c);
          RBin[k] = rbin;
          CBin[k] = cbin;
          W[k] = (c_rot * c_rot + r_rot * r_rot) * exp_scale;
          k++;
        }
      }
    }
    len = k;
    for (k = 0; k < len; k++) Ori[k] = fast_atan2(Y[k], X[k]);
    for (k = 0; k < len; k++) Y[k] = std::sqrt(X[k] * X[k] + Y[k] * Y[k]);
    const float* Mag = Y.data();
    exp32f(W.data(), W.data(), len);
    for (k = 0; k < len; k++) {
      float rbin = RBin[k], cbin = CBin[k];
      float obin = (Ori[k] - ori) * bins_per_rad;
      const float mag = Mag[k] * W[k];
      const int r0 = cv_floor(rbin);
      const int c0 = cv_floor(cbin);
      int o0 = cv_floor(obin);
      rbin -= r0;
      cbin -= c0;
      obin -= o0;
      if (o0 < 0) o0 += n;
      if (o0 >= n) o0 -= n;
      const float v_r1 = mag * rbin, v_r0 = mag - v_r1;
      const float v_rc11 = v_r1 * cbin, v_rc10 = v_r1 - v_rc11;
      const float v_rc01 = v_r0 * cbin, v_rc00 = v_r0 - v_rc01;
      const float v_rco111 = v_rc11 * obin, v_rco110 = v_rc11 - v_rco111;
      const float v_rco101 = v_rc10 * obin, v_rco100 = v_rc10 - v_rco101;
      const float v_rco011 = v_rc01 * obin, v_rco010 = v_rc01 - v_rco011;
      const float v_rco001 = v_rc00 * obin, v_rco000 = v_rc00 - v_rco001;
      const int idx = ((r0 + 1) * (d + 2) + c0 + 1) * (n + 2) + o0;
      hist[idx] += v_rco000;
      hist[idx + 1] += v_rco001;
      hist[idx + (n + 2)] += v_rco010;
      hist[idx + (n + 3)] += v_rco011;
      hist[idx + (d + 2) * (n + 2)] += v_rco100;
      hist[idx + (d + 2) * (n + 2) + 1] += v_rco101;
      hist[idx + (d + 3) * (n + 2)] += v_rco110;
      hist[idx + (d + 3) * (n + 2) + 1] += v_rco111;
    }
    for (int i = 0; i < d; i++) {
      for (int j = 0; j < d; j++) {
        const int idx = ((i + 1) * (d + 2) + (j + 1)) * (n + 2);
        hist[idx] += hist[idx + n];
        hist[idx + 1] += hist[idx + n + 1];
        for (k = 0; k < n; k++) raw[(i * d + j) * n + k] = hist[idx + k];
      }
    }
    len = d * d * n;
    // the squared norm in 4 lanes, then SSE3's horizontal sums
    float lane[4] = {0.f, 0.f, 0.f, 0.f};
    for (k = 0; k < len; k++) lane[k & 3] = raw[k] * raw[k] + lane[k & 3];
    float nrm2 = (lane[0] + lane[1]) + (lane[2] + lane[3]);
    const float thr = std::sqrt(nrm2) * kSiftDescrMagThr;
    nrm2 = 0;
    for (int i = 0; i < len; i++) {
      const float val = std::min(raw[i], thr);
      raw[i] = val;
      nrm2 += val * val;
    }
    nrm2 = kSiftIntDescrFctr / std::max(std::sqrt(nrm2), FLT_EPSILON);
    for (k = 0; k < len; k++)
      dst[k] = std::min(std::max(static_cast<float>(cv_round(raw[k] * nrm2)), 0.f), 255.f);
  }

  // SIFT_Impl::detectAndCompute(image, noArray(), kps, desc)
  void detect_compute(const Mat8u& img, int nfeatures, std::vector<KeyPoint>& kps,
                      std::vector<float>& desc) {
    build(img);
    extrema(kps);
    remove_duplicated_sorted(kps);
    if (nfeatures > 0) retain_best(kps, nfeatures);
    const int first_octave = -1;
    for (KeyPoint& k : kps) {
      const float scale = 1.f / static_cast<float>(1 << -first_octave);
      k.octave = (k.octave & ~255) | ((k.octave + first_octave) & 255);
      k.x *= scale;
      k.y *= scale;
      k.size *= scale;
    }
    desc.assign(kps.size() * 128, 0.f);
    for (size_t i = 0; i < kps.size(); i++) {
      const KeyPoint& k = kps[i];
      int octave = k.octave & 255;
      const int layer = (k.octave >> 8) & 255;
      octave = octave < 128 ? octave : (-128 | octave);
      const float scale = octave >= 0 ? 1.f / (1 << octave) : static_cast<float>(1 << -octave);
      const float size = k.size * scale;
      const Mat32f& g = gpyr[(octave - first_octave) * (kSiftLayers + 3) + layer];
      float angle = 360.f - k.angle;
      if (std::abs(angle - 360.f) < FLT_EPSILON) angle = 0.f;
      descriptor(g, k.x * scale, k.y * scale, angle, size * 0.5f, desc.data() + i * 128);
    }
  }
};

// --------------------------------------------------------------------- ORB

constexpr int kOrbLevels = 8;
constexpr double kOrbScale = 1.2f;  // ORB::create takes the scale factor as float
constexpr int kOrbEdge = 31;
constexpr int kOrbPatch = 31;
constexpr int kOrbFastThreshold = 20;
constexpr float kHarrisK = 0.04f;

// FAST-9 (TYPE_9_16) with non-maximum suppression on ``img``; keypoints row
// by row, as FAST_t<16> emits them.
int corner_score(const uint8_t* ptr, const int* pixel, int threshold) {
  const int K = 8, N = K * 3 + 1;
  const int v = ptr[0];
  int d[N];
  for (int k = 0; k < N; k++) d[k] = static_cast<int16_t>(v - ptr[pixel[k]]);
  int a0 = threshold;
  for (int k = 0; k < 16; k += 2) {
    int a = std::min(d[k + 1], d[k + 2]);
    a = std::min(a, d[k + 3]);
    if (a <= a0) continue;
    a = std::min(a, d[k + 4]);
    a = std::min(a, d[k + 5]);
    a = std::min(a, d[k + 6]);
    a = std::min(a, d[k + 7]);
    a = std::min(a, d[k + 8]);
    a0 = std::max(a0, std::min(a, d[k]));
    a0 = std::max(a0, std::min(a, d[k + 9]));
  }
  int b0 = -a0;
  for (int k = 0; k < 16; k += 2) {
    int b = std::max(d[k + 1], d[k + 2]);
    b = std::max(b, d[k + 3]);
    b = std::max(b, d[k + 4]);
    b = std::max(b, d[k + 5]);
    if (b >= b0) continue;
    b = std::max(b, d[k + 6]);
    b = std::max(b, d[k + 7]);
    b = std::max(b, d[k + 8]);
    b0 = std::min(b0, std::max(b, d[k]));
    b0 = std::min(b0, std::max(b, d[k + 9]));
  }
  return -b0 - 1;
}

// ``base`` points at the first pixel of a rows x cols image of row pitch step.
void fast9(const uint8_t* base, int step, int rows, int cols, int threshold,
           std::vector<KeyPoint>& kps) {
  static const int off[16][2] = {{0, 3},  {1, 3},   {2, 2},   {3, 1},   {3, 0},  {3, -1},
                                 {2, -2}, {1, -3},  {0, -3},  {-1, -3}, {-2, -2}, {-3, -1},
                                 {-3, 0}, {-3, 1},  {-2, 2},  {-1, 3}};
  const int K = 8, N = 16 + K + 1;
  int pixel[25];
  for (int k = 0; k < 16; k++) pixel[k] = off[k][0] + off[k][1] * step;
  for (int k = 16; k < 25; k++) pixel[k] = pixel[k - 16];
  kps.clear();
  threshold = std::min(std::max(threshold, 0), 255);
  uint8_t tab[512];
  for (int i = -255; i <= 255; i++)
    tab[i + 255] = static_cast<uint8_t>(i < -threshold ? 1 : i > threshold ? 2 : 0);
  std::vector<uint8_t> sbuf(static_cast<size_t>(cols) * 3);
  std::vector<int> cbuf(static_cast<size_t>(cols + 1) * 3);
  uint8_t* buf[3] = {sbuf.data(), sbuf.data() + cols, sbuf.data() + 2 * cols};
  int* cpbuf[3] = {cbuf.data(), cbuf.data() + cols + 1, cbuf.data() + 2 * (cols + 1)};
  for (int i = 3; i < rows - 2; i++) {
    const uint8_t* ptr = base + static_cast<std::ptrdiff_t>(i) * step + 3;
    uint8_t* curr = buf[(i - 3) % 3];
    int* cornerpos = cpbuf[(i - 3) % 3] + 1;
    std::memset(curr, 0, static_cast<size_t>(cols));
    int ncorners = 0;
    if (i < rows - 3) {
      for (int j = 3; j < cols - 3; j++, ptr++) {
        const int v = ptr[0];
        const uint8_t* t = tab - v + 255;
        int d = t[ptr[pixel[0]]] | t[ptr[pixel[8]]];
        if (d == 0) continue;
        d &= t[ptr[pixel[2]]] | t[ptr[pixel[10]]];
        d &= t[ptr[pixel[4]]] | t[ptr[pixel[12]]];
        d &= t[ptr[pixel[6]]] | t[ptr[pixel[14]]];
        if (d == 0) continue;
        d &= t[ptr[pixel[1]]] | t[ptr[pixel[9]]];
        d &= t[ptr[pixel[3]]] | t[ptr[pixel[11]]];
        d &= t[ptr[pixel[5]]] | t[ptr[pixel[13]]];
        d &= t[ptr[pixel[7]]] | t[ptr[pixel[15]]];
        if (d & 1) {
          const int vt = v - threshold;
          int count = 0;
          for (int k = 0; k < N; k++) {
            if (ptr[pixel[k]] < vt) {
              if (++count > K) {
                cornerpos[ncorners++] = j;
                curr[j] = static_cast<uint8_t>(corner_score(ptr, pixel, threshold));
                break;
              }
            } else {
              count = 0;
            }
          }
        }
        if (d & 2) {
          const int vt = v + threshold;
          int count = 0;
          for (int k = 0; k < N; k++) {
            if (ptr[pixel[k]] > vt) {
              if (++count > K) {
                cornerpos[ncorners++] = j;
                curr[j] = static_cast<uint8_t>(corner_score(ptr, pixel, threshold));
                break;
              }
            } else {
              count = 0;
            }
          }
        }
      }
    }
    cornerpos[-1] = ncorners;
    if (i == 3) continue;
    const uint8_t* prev = buf[(i - 4 + 3) % 3];
    const uint8_t* pprev = buf[(i - 5 + 3) % 3];
    cornerpos = cpbuf[(i - 4 + 3) % 3] + 1;
    ncorners = cornerpos[-1];
    for (int k = 0; k < ncorners; k++) {
      const int j = cornerpos[k];
      const int score = prev[j];
      if (score > prev[j + 1] && score > prev[j - 1] && score > pprev[j - 1] &&
          score > pprev[j] && score > pprev[j + 1] && score > curr[j - 1] && score > curr[j] &&
          score > curr[j + 1])
        kps.push_back(KeyPoint{static_cast<float>(j), static_cast<float>(i - 1), 7.f, -1.f,
                               static_cast<float>(score), 0, -1});
    }
  }
}

struct OrbLevel {
  Mat8u ext;      // the level with its border (``border`` pixels on each side)
  int w = 0, h = 0;
  float scale = 1;
};

// false where OpenCV raises: a pyramid level of no pixels (a side of 1)
bool orb_detect_compute(const Mat8u& image, int nfeatures, std::vector<KeyPoint>& kps,
                        std::vector<uint8_t>& desc) {
  kps.clear();
  desc.clear();
  if (image.rows == 0 || image.cols == 0) return true;
  const int half_patch = kOrbPatch / 2;
  const int desc_patch = static_cast<int>(std::ceil(half_patch * std::sqrt(2.0)));
  const int border = std::max(kOrbEdge, std::max(desc_patch, 9 / 2)) + 1;
  std::vector<OrbLevel> lv(kOrbLevels);
  for (int l = 0; l < kOrbLevels; l++) {
    const float scale = static_cast<float>(std::pow(kOrbScale, static_cast<double>(l)));
    lv[l].scale = scale;
    lv[l].w = cv_round(image.cols / scale);
    lv[l].h = cv_round(image.rows / scale);
    if (lv[l].w == 0 || lv[l].h == 0) return false;
  }
  // the pyramid: each level resized from the one before, then bordered
  Mat8u prev = image;
  for (int l = 0; l < kOrbLevels; l++) {
    Mat8u cur;
    if (l == 0)
      cur = image;
    else
      resize_linear_exact_u8(prev, cur, lv[l].w, lv[l].h);
    copy_make_border_u8(cur, lv[l].ext, border);
    prev = std::move(cur);
  }
  // computeKeyPoints
  std::vector<int> per_level(kOrbLevels);
  const float factor = static_cast<float>(1.0 / kOrbScale);
  float ndesired = nfeatures * (1 - factor) /
                   (1 - static_cast<float>(std::pow(static_cast<double>(factor),
                                                    static_cast<double>(kOrbLevels))));
  int sum_features = 0;
  for (int l = 0; l < kOrbLevels - 1; l++) {
    per_level[l] = cv_round(ndesired);
    sum_features += per_level[l];
    ndesired *= factor;
  }
  per_level[kOrbLevels - 1] = std::max(nfeatures - sum_features, 0);
  std::vector<int> umax(half_patch + 2);
  const int vmax = cv_floor(half_patch * std::sqrt(2.f) / 2 + 1);
  const int vmin = cv_ceil(half_patch * std::sqrt(2.f) / 2);
  for (int v = 0; v <= vmax; ++v)
    umax[v] = cv_round(std::sqrt(static_cast<double>(half_patch) * half_patch - v * v));
  for (int v = half_patch, v0 = 0; v >= vmin; --v) {
    while (umax[v0] == umax[v0 + 1]) ++v0;
    umax[v] = v0;
    ++v0;
  }
  std::vector<KeyPoint> all, level_kps;
  std::vector<int> counters(kOrbLevels);
  for (int l = 0; l < kOrbLevels; l++) {
    const OrbLevel& L = lv[l];
    const uint8_t* base = L.ext.row(border) + border;
    fast9(base, L.ext.cols, L.h, L.w, kOrbFastThreshold, level_kps);
    run_by_image_border(level_kps, L.w, L.h, kOrbEdge);
    retain_best(level_kps, 2 * per_level[l]);
    counters[l] = static_cast<int>(level_kps.size());
    for (KeyPoint& k : level_kps) {
      k.octave = l;
      k.size = kOrbPatch * L.scale;
    }
    all.insert(all.end(), level_kps.begin(), level_kps.end());
  }
  if (all.empty()) return true;
  // HarrisResponses, block 7
  {
    const int block = 7, r = block / 2;
    const float scale = 1.f / ((1 << 2) * block * 255.f);
    const float scale_sq_sq = scale * scale * scale * scale;
    for (KeyPoint& k : all) {
      const OrbLevel& L = lv[k.octave];
      const int step = L.ext.cols;
      const int x0 = cv_round(k.x), y0 = cv_round(k.y);
      const uint8_t* ptr0 = L.ext.row(y0 - r + border) + (x0 - r + border);
      int a = 0, b = 0, c = 0;
      for (int i = 0; i < block; i++) {
        for (int j = 0; j < block; j++) {
          const uint8_t* p = ptr0 + i * step + j;
          const int Ix = (p[1] - p[-1]) * 2 + (p[-step + 1] - p[-step - 1]) +
                         (p[step + 1] - p[step - 1]);
          const int Iy = (p[step] - p[-step]) * 2 + (p[step - 1] - p[-step - 1]) +
                         (p[step + 1] - p[-step + 1]);
          a += Ix * Ix;
          b += Iy * Iy;
          c += Ix * Iy;
        }
      }
      k.response = (static_cast<float>(a) * b - static_cast<float>(c) * c -
                    kHarrisK * (static_cast<float>(a) + b) * (static_cast<float>(a) + b)) *
                   scale_sq_sq;
    }
  }
  {
    std::vector<KeyPoint> kept;
    int offset = 0;
    for (int l = 0; l < kOrbLevels; l++) {
      std::vector<KeyPoint> part(all.begin() + offset, all.begin() + offset + counters[l]);
      offset += counters[l];
      retain_best(part, per_level[l]);
      kept.insert(kept.end(), part.begin(), part.end());
    }
    all.swap(kept);
  }
  // ICAngles
  for (KeyPoint& k : all) {
    const OrbLevel& L = lv[k.octave];
    const int step = L.ext.cols;
    const uint8_t* center = L.ext.row(cv_round(k.y) + border) + cv_round(k.x) + border;
    int m_01 = 0, m_10 = 0;
    for (int u = -half_patch; u <= half_patch; ++u) m_10 += u * center[u];
    for (int v = 1; v <= half_patch; ++v) {
      int v_sum = 0;
      const int d = umax[v];
      for (int u = -d; u <= d; ++u) {
        const int val_plus = center[u + v * step], val_minus = center[u - v * step];
        v_sum += (val_plus - val_minus);
        m_10 += u * (val_plus + val_minus);
      }
      m_01 += v * v_sum;
    }
    k.angle = fast_atan2(static_cast<float>(m_01), static_cast<float>(m_10));
  }
  for (KeyPoint& k : all) {
    const float scale = lv[k.octave].scale;
    k.x = k.x * scale;
    k.y = k.y * scale;
  }
  kps = all;
  // the descriptors, on each level blurred with a 7 x 7, sigma 2 Gaussian
  for (int l = 0; l < kOrbLevels; l++) gaussian_blur_u8_float(lv[l].ext, lv[l].ext, 7, 2.0);
  const int dsize = 32;
  desc.assign(kps.size() * dsize, 0);
  for (size_t j = 0; j < kps.size(); j++) {
    const KeyPoint& k = kps[j];
    const OrbLevel& L = lv[k.octave];
    const int step = L.ext.cols;
    const float scale = 1.f / L.scale;
    float angle = k.angle;
    angle *= static_cast<float>(M_PI / 180.f);
    const float a = std::cos(angle), b = std::sin(angle);
    const uint8_t* center =
        L.ext.row(cv_round(k.y * scale) + border) + cv_round(k.x * scale) + border;
    const int* pattern = orb_pattern::kBitPattern31;
    uint8_t* out = desc.data() + j * dsize;
    auto value = [&](int idx) {
      const float px = static_cast<float>(pattern[2 * idx]);
      const float py = static_cast<float>(pattern[2 * idx + 1]);
      const float x = px * a - py * b;
      const float y = px * b + py * a;
      return static_cast<int>(center[cv_round(y) * step + cv_round(x)]);
    };
    for (int i = 0; i < dsize; ++i, pattern += 32) {
      int val = 0;
      for (int bit = 0; bit < 8; bit++) val |= (value(2 * bit) < value(2 * bit + 1)) << bit;
      out[i] = static_cast<uint8_t>(val);
    }
  }
  return true;
}

// A finished detection: keypoints and descriptors, handed to Python.
struct Features {
  std::vector<KeyPoint> kps;
  std::vector<float> fdesc;
  std::vector<uint8_t> udesc;
};

Mat8u wrap_u8(const uint8_t* img, int h, int w) {
  Mat8u m(h, w);
  if (h > 0 && w > 0) std::memcpy(m.d.data(), img, static_cast<size_t>(h) * w);
  return m;
}

}  // namespace

extern "C" {

// SIFT_create(nfeatures).detectAndCompute on an 8-bit h x w image; returns a
// handle (ssp_features_count / _copy / _free), or null where OpenCV raises
// (an empty image).
void* ssp_sift(const uint8_t* img, int h, int w, int nfeatures) {
  if (h <= 0 || w <= 0) return nullptr;
  Features* f = new Features;
  Sift s;
  s.detect_compute(wrap_u8(img, h, w), nfeatures, f->kps, f->fdesc);
  return f;
}

// ORB_create(nfeatures).detectAndCompute on an 8-bit h x w image; null where
// OpenCV raises (a side of one pixel).
void* ssp_orb(const uint8_t* img, int h, int w, int nfeatures) {
  Features* f = new Features;
  if (!orb_detect_compute(wrap_u8(img, std::max(h, 0), std::max(w, 0)), nfeatures, f->kps,
                          f->udesc)) {
    delete f;
    return nullptr;
  }
  return f;
}

int64_t ssp_features_count(void* handle) {
  return handle ? static_cast<int64_t>(static_cast<Features*>(handle)->kps.size()) : 0;
}

// kp: [n, 5] float (x, y, size, angle, response); octave: [n] int32;
// desc: [n, 128] float (SIFT) or [n, 32] uint8 (ORB).
void ssp_features_copy(void* handle, float* kp, int32_t* octave, void* desc) {
  const Features* f = static_cast<Features*>(handle);
  for (size_t i = 0; i < f->kps.size(); i++) {
    const KeyPoint& k = f->kps[i];
    float* o = kp + i * 5;
    o[0] = k.x;
    o[1] = k.y;
    o[2] = k.size;
    o[3] = k.angle;
    o[4] = k.response;
    octave[i] = k.octave;
  }
  if (!f->fdesc.empty()) std::memcpy(desc, f->fdesc.data(), f->fdesc.size() * sizeof(float));
  if (!f->udesc.empty()) std::memcpy(desc, f->udesc.data(), f->udesc.size());
}

void ssp_features_free(void* handle) { delete static_cast<Features*>(handle); }

// ---- the primitives alone, for their tests against OpenCV

// GaussianBlur(src, dst, Size(), sigma, sigma) on float
int ssp_cv_gaussian_blur_f32(const float* src, float* dst, int h, int w, double sigma) {
  Mat32f s(h, w), d;
  std::memcpy(s.d.data(), src, s.d.size() * sizeof(float));
  gaussian_blur_f32(s, d, sigma);
  std::memcpy(dst, d.d.data(), d.d.size() * sizeof(float));
  return 0;
}

// GaussianBlur(src, dst, Size(ksize, ksize), sigma, sigma) on 8-bit, float path
int ssp_cv_gaussian_blur_u8_float(const uint8_t* src, uint8_t* dst, int h, int w, int ksize,
                                  double sigma) {
  Mat8u d;
  gaussian_blur_u8_float(wrap_u8(src, h, w), d, ksize, sigma);
  std::memcpy(dst, d.d.data(), d.d.size());
  return 0;
}

// getGaussianKernel(n, sigma, CV_32F)
int ssp_cv_gaussian_kernel_f32(int n, double sigma, float* out) {
  const std::vector<float> k = gaussian_kernel_f32(n, sigma);
  std::copy(k.begin(), k.end(), out);
  return 0;
}

// resize on float: mode 0 INTER_LINEAR, 1 INTER_NEAREST
int ssp_cv_resize_f32(const float* src, int h, int w, float* dst, int dh, int dw, int mode) {
  Mat32f s(h, w), d;
  std::memcpy(s.d.data(), src, s.d.size() * sizeof(float));
  if (mode == 0)
    resize_linear_f32(s, d, dw, dh);
  else
    resize_nearest_f32(s, d, dw, dh);
  std::memcpy(dst, d.d.data(), d.d.size() * sizeof(float));
  return 0;
}

// resize(..., INTER_LINEAR_EXACT) on 8-bit
int ssp_cv_resize_linear_exact_u8(const uint8_t* src, int h, int w, uint8_t* dst, int dh,
                                  int dw) {
  Mat8u d;
  resize_linear_exact_u8(wrap_u8(src, h, w), d, dw, dh);
  std::memcpy(dst, d.d.data(), d.d.size());
  return 0;
}

// copyMakeBorder(..., b, b, b, b, BORDER_REFLECT_101) on 8-bit
int ssp_cv_copy_make_border_u8(const uint8_t* src, int h, int w, int b, uint8_t* dst) {
  Mat8u d;
  copy_make_border_u8(wrap_u8(src, h, w), d, b);
  std::memcpy(dst, d.d.data(), d.d.size());
  return 0;
}

// hal::exp32f
int ssp_cv_exp32f(const float* x, float* y, int n) {
  exp32f(x, y, n);
  return 0;
}

// phase(x, y, angleInDegrees=true): fastAtan2 per element
int ssp_cv_fast_atan2(const float* y, const float* x, float* out, int n) {
  for (int i = 0; i < n; i++) out[i] = fast_atan2(y[i], x[i]);
  return 0;
}

}  // extern "C"
