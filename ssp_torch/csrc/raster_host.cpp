// Drawing, blurring and the two small transform solves of the synthetic-shapes
// generator, on the host, without OpenCV.
//
// What the generator gets from OpenCV, byte for byte, at the arguments it
// passes (8-bit, one channel, LINE_8, shift 0), and the two colour calls of
// the drawing helpers:
//
// * ``line``: thickness 1 is an 8-connected Bresenham walk from the left end,
//   after the segment is clipped to the canvas.  A thicker line is first
//   clipped, in whole pixels, to the canvas grown by the thickness on each
//   side; then it is a quad in 16-bit fixed point (``XY_SHIFT``) filled as a
//   convex polygon, with a filled circle of radius (thickness + 1) / 2 on
//   each end;
// * ``fillConvexPoly``: two active edges stepped in fixed point, the outline
//   drawn first (for the quads of thick lines and for ellipses, by OpenCV's
//   fixed-point ``Line2`` walk);
// * ``fillPoly``: an edge table with an active list and even-odd spans from
//   ceil(x_left) to floor(x_right), the outline drawn first; an edge that
//   leaves the canvas runs along its segment as ``clipLine`` leaves it
//   (truncated to pixels, and vertical where the clip leaves one point);
// * ``circle`` (filled): the midpoint circle as horizontal spans, on one
//   channel or, for the visualisations, on 1-4 interleaved channels;
// * ``line`` with LINE_AA (the visualisations' match and track lines):
//   OpenCV's LineAA, 1 pixel wide, on 1-4 interleaved channels;
// * ``ellipse`` (filled, full arc): the angle rounded to whole degrees, the
//   outline sampled every 5..90 degrees from a float sine table (values of
//   sin rounded to 7 decimals), then filled as a convex polygon;
// * ``blur``: a box filter with reflected borders (BORDER_REFLECT_101), sums
//   in integers, the mean float(sum) * float(1 / k^2) in single precision,
//   rounded half to even; sums that fit 16 bits (k <= 15) go through
//   OpenCV's 23-bit fixed-point division instead;
// * ``GaussianBlur`` with sigma 0: OpenCV's bit-exact 8-bit path, taps of
//   8 fractional bits (error-diffused rounding of the double kernel, the
//   centre tap taking the remainder), a horizontal pass kept at 8 fractional
//   bits, a vertical pass at 16, rounded half up;
// * ``getAffineTransform`` and ``getPerspectiveTransform``: the 6x6 and 8x8
//   systems as OpenCV sets them up (the perspective products in float),
//   solved by OpenCV's LU with partial pivoting;
// * ``GaussianBlur`` with a sigma and kernel size 0 (the semantic labels'
//   smoothing): the size cvRound(6 sigma + 1) | 1, the taps from that sigma,
//   then the same fixed-point passes;
// * ``warpPerspective`` of a float32 or an 8-bit image, INTER_LINEAR,
//   BORDER_CONSTANT 0 (the sequence evaluation's frames, the synthetic
//   HPatches and KITTI corpora): the matrix inverted as OpenCV's
//   ``invert`` inverts a 3x3 (cofactors over the determinant, in double) and
//   rounded to float; each destination pixel's source point in float, the
//   per-row terms M1*y + M2 rounded twice, the column term one fused
//   multiply-add, one division by the homogeneous coordinate; the taps
//   blended by three fused lerps (no 1/32 grid: OpenCV 5.0 computes linear
//   warps in float, 8-bit ones too, rounded to nearest, ties to even, at the
//   end).  OpenCV runs the first 16 * floor(W / 16) columns of a row in its
//   vector loop and the rest in a scalar loop whose sums its compiler
//   contracted otherwise (x*M0 + y*M1 as one FMA, then + M2); both are
//   reproduced.
//
// Build without -ffast-math and without FMA contraction (kernels/_build.py):
// the double arithmetic must round as OpenCV's does.  A plain C interface
// for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "cv_common.h"

namespace {

constexpr int XY_SHIFT = 16;
constexpr int64_t XY_ONE = int64_t(1) << XY_SHIFT;

struct Canvas {
  uint8_t* data;
  int h, w;
  uint8_t* row(int y) const { return data + static_cast<int64_t>(y) * w; }
};

struct P {
  int64_t x, y;
};

using sspcv::reflect101;
using sspcv::round_even;
using sspcv::cv_round;
using sspcv::sat_u8;

inline void hline(const Canvas& c, int y, int x1, int x2, uint8_t color) {
  if (x2 >= x1) std::memset(c.row(y) + x1, color, static_cast<size_t>(x2 - x1 + 1));
}

// OpenCV's clipLine on a [0, w-1] x [0, h-1] box; false if nothing is left.
bool clip_line(int64_t w, int64_t h, P& p1, P& p2) {
  if (w <= 0 || h <= 0) return false;
  const int64_t right = w - 1, bottom = h - 1;
  int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += static_cast<int64_t>(static_cast<double>(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += static_cast<int64_t>(static_cast<double>(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += static_cast<int64_t>(static_cast<double>(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += static_cast<int64_t>(static_cast<double>(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// A one-pixel line between integer points (OpenCV's LineIterator, 8-connected,
// left to right, clipped to the canvas first).
void line_thin(const Canvas& c, P p1, P p2, uint8_t color) {
  if (p1.x < 0 || p1.x >= c.w || p2.x < 0 || p2.x >= c.w || p1.y < 0 || p1.y >= c.h ||
      p2.y < 0 || p2.y >= c.h) {
    if (!clip_line(c.w, c.h, p1, p2)) return;
  }
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  if (dx < 0) {
    dx = -dx;
    dy = -dy;
    std::swap(p1, p2);
  }
  int64_t sx = 1, sy = 1;
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  const bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int64_t err = dx - (dy + dy);
  const int64_t plus = dx + dx, minus = -(dy + dy);
  int64_t x = p1.x, y = p1.y;
  for (int64_t i = 0; i <= dx; i++) {
    c.row(static_cast<int>(y))[x] = color;
    const bool step = err < 0;
    err += minus + (step ? plus : 0);
    if (vert) {
      y += sy;
      if (step) x += sx;
    } else {
      x += sx;
      if (step) y += sy;
    }
  }
}

// A one-pixel line between points in XY_SHIFT fixed point (OpenCV's Line2).
void line_fixed(const Canvas& c, P p1, P p2, uint8_t color) {
  if (!clip_line(int64_t(c.w) << XY_SHIFT, int64_t(c.h) << XY_SHIFT, p1, p2)) return;
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  const int64_t j = dx < 0 ? -1 : 0;
  const int64_t ax = (dx ^ j) - j;
  const int64_t i = dy < 0 ? -1 : 0;
  const int64_t ay = (dy ^ i) - i;
  int64_t x_step, y_step;
  int ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    if (j) std::swap(p1, p2);
    x_step = XY_ONE;
    y_step = (dy * XY_ONE) / (ax | 1);
    ecount = static_cast<int>((p2.x - p1.x) >> XY_SHIFT);
  } else {
    dx = (dx ^ i) - i;
    if (i) std::swap(p1, p2);
    x_step = (dx * XY_ONE) / (ay | 1);
    y_step = XY_ONE;
    ecount = static_cast<int>((p2.y - p1.y) >> XY_SHIFT);
  }
  p1.x += XY_ONE >> 1;
  p1.y += XY_ONE >> 1;
  auto put = [&](int64_t x, int64_t y) {
    if (0 <= x && x < c.w && 0 <= y && y < c.h) c.row(static_cast<int>(y))[x] = color;
  };
  put((p2.x + (XY_ONE >> 1)) >> XY_SHIFT, (p2.y + (XY_ONE >> 1)) >> XY_SHIFT);
  if (ax > ay) {
    p1.x >>= XY_SHIFT;
    while (ecount >= 0) {
      put(p1.x, p1.y >> XY_SHIFT);
      p1.x++;
      p1.y += y_step;
      ecount--;
    }
  } else {
    p1.y >>= XY_SHIFT;
    while (ecount >= 0) {
      put(p1.x >> XY_SHIFT, p1.y);
      p1.x += x_step;
      p1.y++;
      ecount--;
    }
  }
}

// OpenCV's FillConvexPoly for LINE_8 with ``shift`` fractional bits.
void fill_convex(const Canvas& c, const P* v, int npts, uint8_t color, int shift) {
  struct Edge {
    int idx, di;
    int64_t x, dx;
    int ye;
  } edge[2];
  const int delta = (1 << shift) >> 1;
  int imin = 0, edges = npts;
  int64_t xmin, xmax, ymin, ymax;
  const int64_t delta1 = XY_ONE >> 1, delta2 = XY_ONE >> 1;
  P p0 = v[npts - 1];
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  xmin = xmax = v[0].x;
  ymin = ymax = v[0].y;
  for (int i = 0; i < npts; i++) {
    P p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    p.x <<= XY_SHIFT - shift;
    p.y <<= XY_SHIFT - shift;
    if (shift == 0) {
      line_thin(c, P{p0.x >> XY_SHIFT, p0.y >> XY_SHIFT}, P{p.x >> XY_SHIFT, p.y >> XY_SHIFT},
                color);
    } else {
      line_fixed(c, p0, p, color);
    }
    p0 = p;
  }
  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;
  if (npts < 3 || static_cast<int>(xmax) < 0 || static_cast<int>(ymax) < 0 ||
      static_cast<int>(xmin) >= c.w || static_cast<int>(ymin) >= c.h)
    return;
  ymax = std::min<int64_t>(ymax, c.h - 1);
  edge[0].idx = edge[1].idx = imin;
  int y = static_cast<int>(ymin);
  edge[0].ye = edge[1].ye = y;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -XY_ONE;
  edge[0].dx = edge[1].dx = 0;
  do {
    for (int i = 0; i < 2; i++) {
      if (y >= edge[i].ye) {
        int idx0 = edge[i].idx, di = edge[i].di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        for (; edges-- > 0;) {
          const int ty = static_cast<int>((v[idx].y + delta) >> shift);
          if (ty > y) {
            int64_t xs = v[idx0].x, xe = v[idx].x;
            if (shift != XY_SHIFT) {
              xs <<= XY_SHIFT - shift;
              xe <<= XY_SHIFT - shift;
            }
            edge[i].ye = ty;
            edge[i].dx = ((xe - xs) * 2 + (int64_t(ty) - y)) / (2 * (int64_t(ty) - y));
            edge[i].x = xs;
            edge[i].idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) {
        left = 1;
        right = 0;
      }
      int xx1 = static_cast<int>((edge[left].x + delta1) >> XY_SHIFT);
      int xx2 = static_cast<int>((edge[right].x + delta2) >> XY_SHIFT);
      if (xx2 >= 0 && xx1 < c.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= c.w) xx2 = c.w - 1;
        hline(c, y, xx1, xx2, color);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= static_cast<int>(ymax));
}

// OpenCV's Circle with fill: the midpoint walk, each step four spans, each
// span(y, x1, x2) inside a w x h canvas.
template <class Span>
void circle_spans(int w, int h, int cx, int cy, int radius, Span span) {
  int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  const bool inside = cx >= radius && cx < w - radius && cy >= radius && cy < h - radius;
  while (dx >= dy) {
    int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (inside) {
      span(y11, x11, x12);
      span(y12, x11, x12);
      span(y21, x21, x22);
      span(y22, x21, x22);
    } else if (x11 < w && x12 >= 0 && y21 < h && y22 >= 0) {
      x11 = std::max(x11, 0);
      x12 = std::min(x12, w - 1);
      if (static_cast<unsigned>(y11) < static_cast<unsigned>(h)) span(y11, x11, x12);
      if (static_cast<unsigned>(y12) < static_cast<unsigned>(h)) span(y12, x11, x12);
      if (x21 < w && x22 >= 0) {
        x21 = std::max(x21, 0);
        x22 = std::min(x22, w - 1);
        if (static_cast<unsigned>(y21) < static_cast<unsigned>(h)) span(y21, x21, x22);
        if (static_cast<unsigned>(y22) < static_cast<unsigned>(h)) span(y22, x21, x22);
      }
    }
    dy++;
    err += plus;
    plus += 2;
    const int mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

void circle_filled(const Canvas& c, int cx, int cy, int radius, uint8_t color) {
  circle_spans(c.w, c.h, cx, cy, radius,
               [&](int y, int x1, int x2) { hline(c, y, x1, x2, color); });
}

// An 8-bit canvas of 1 to 4 interleaved channels, for the colour drawing of
// the visualisations (``ssp_torch.utils.draw``).
struct ColorCanvas {
  uint8_t* data;
  int h, w, nch;
  uint8_t* at(int64_t x, int64_t y) const { return data + (y * w + x) * nch; }
};

// OpenCV's LineAA (antialiased, 1 pixel wide) between points in XY_SHIFT
// fixed point: after clipLine on the canvas grown to fixed point, a walk
// along the major axis that blends three pixels across the line with weights
// from FilterTable (indexed by the 5-bit fraction of the minor coordinate),
// scaled by a slope correction and by end-point corrections of the first two
// and last two steps.  Each channel blends twice by
// v += ((c - v) * a + 127) >> 8.
const int kSlopeCorr[] = {181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190,
                          192, 194, 196, 198, 201, 203, 206, 209, 211, 214, 218,
                          221, 224, 227, 231, 235, 238, 242, 246, 250, 254};
const int kFilter[] = {168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249,
                       252, 254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218,
                       210, 202, 194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105,
                       97,  89,  82,  75,  68,  62,  56,  50,  45,  40,  36,  32,  28,
                       25,  22,  19,  16,  14,  12,  11,  9,   8,   7,   5,   5};

void line_aa(const ColorCanvas& c, P pt1, P pt2, const uint8_t* color) {
  if (!clip_line(int64_t(c.w) << XY_SHIFT, int64_t(c.h) << XY_SHIFT, pt1, pt2)) return;
  int64_t dx = pt2.x - pt1.x, dy = pt2.y - pt1.y;
  int64_t j = dx < 0 ? -1 : 0;
  const int64_t ax = (dx ^ j) - j;
  int64_t i = dy < 0 ? -1 : 0;
  const int64_t ay = (dy ^ i) - i;
  int64_t x_step, y_step;
  int ecount, slope;
  const bool horizontal = ax > ay;
  if (horizontal) {
    dy = (dy ^ j) - j;
    if (j) std::swap(pt1, pt2);
    x_step = XY_ONE;
    y_step = (dy * XY_ONE) / (ax | 1);
    pt2.x += XY_ONE;
    ecount = static_cast<int>((pt2.x >> XY_SHIFT) - (pt1.x >> XY_SHIFT));
    j = -(pt1.x & (XY_ONE - 1));
    pt1.y += ((y_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
    slope = static_cast<int>((y_step >> (XY_SHIFT - 5)) & 0x3f);
    slope ^= (y_step < 0 ? 0x3f : 0);
    i = (pt1.x >> (XY_SHIFT - 7)) & 0x78;
    j = (pt2.x >> (XY_SHIFT - 7)) & 0x78;
  } else {
    dx = (dx ^ i) - i;
    if (i) std::swap(pt1, pt2);
    x_step = (dx * XY_ONE) / (ay | 1);
    y_step = XY_ONE;
    pt2.y += XY_ONE;
    ecount = static_cast<int>((pt2.y >> XY_SHIFT) - (pt1.y >> XY_SHIFT));
    j = -(pt1.y & (XY_ONE - 1));
    pt1.x += ((x_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
    slope = static_cast<int>((x_step >> (XY_SHIFT - 5)) & 0x3f);
    slope ^= (x_step < 0 ? 0x3f : 0);
    i = (pt1.y >> (XY_SHIFT - 7)) & 0x78;
    j = (pt2.y >> (XY_SHIFT - 7)) & 0x78;
  }
  slope = (slope & 0x20) ? 0x100 : kSlopeCorr[slope];
  int ep_table[9];
  {
    const int t0 = slope << 7;
    const int t1 = ((0x78 - static_cast<int>(i)) | 4) * slope;
    const int t2 = (static_cast<int>(j) | 4) * slope;
    ep_table[0] = 0;
    ep_table[8] = slope;
    ep_table[1] = ep_table[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff;
    ep_table[2] = (t1 >> 8) & 0x1ff;
    ep_table[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff;
    ep_table[5] = ((t1 + t0) >> 8) & 0x1ff;
    ep_table[6] = (t2 >> 8) & 0x1ff;
    ep_table[7] = ((t2 + t0) >> 8) & 0x1ff;
  }
  auto put = [&](int64_t x, int64_t y, int a) {
    uint8_t* t = c.at(x, y);
    for (int k = 0; k < c.nch; k++) {
      int v = t[k];
      v += ((color[k] - v) * a + 127) >> 8;
      v += ((color[k] - v) * a + 127) >> 8;
      t[k] = static_cast<uint8_t>(v);
    }
  };
  int scount = 0;
  if (horizontal) {
    int64_t x = pt1.x >> XY_SHIFT;
    for (; ecount >= 0; x++, pt1.y += y_step, scount++, ecount--) {
      if (static_cast<uint64_t>(x) >= static_cast<uint64_t>(c.w)) continue;
      const int64_t y = (pt1.y >> XY_SHIFT) - 1;
      const int ep_corr = ep_table[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                                   (((ecount >= 2) + 1) & (ecount | 2))];
      const int dist = static_cast<int>((pt1.y >> (XY_SHIFT - 5)) & 31);
      if (static_cast<uint64_t>(y) < static_cast<uint64_t>(c.h))
        put(x, y, (ep_corr * kFilter[dist + 32] >> 8) & 0xff);
      if (static_cast<uint64_t>(y + 1) < static_cast<uint64_t>(c.h))
        put(x, y + 1, (ep_corr * kFilter[dist] >> 8) & 0xff);
      if (static_cast<uint64_t>(y + 2) < static_cast<uint64_t>(c.h))
        put(x, y + 2, (ep_corr * kFilter[63 - dist] >> 8) & 0xff);
    }
  } else {
    int64_t y = pt1.y >> XY_SHIFT;
    for (; ecount >= 0; y++, pt1.x += x_step, scount++, ecount--) {
      if (static_cast<uint64_t>(y) >= static_cast<uint64_t>(c.h)) continue;
      const int64_t x = (pt1.x >> XY_SHIFT) - 1;
      const int ep_corr = ep_table[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                                   (((ecount >= 2) + 1) & (ecount | 2))];
      const int dist = static_cast<int>((pt1.x >> (XY_SHIFT - 5)) & 31);
      if (static_cast<uint64_t>(x) < static_cast<uint64_t>(c.w))
        put(x, y, (ep_corr * kFilter[dist + 32] >> 8) & 0xff);
      if (static_cast<uint64_t>(x + 1) < static_cast<uint64_t>(c.w))
        put(x + 1, y, (ep_corr * kFilter[dist] >> 8) & 0xff);
      if (static_cast<uint64_t>(x + 2) < static_cast<uint64_t>(c.w))
        put(x + 2, y, (ep_corr * kFilter[63 - dist] >> 8) & 0xff);
    }
  }
}

// OpenCV's ThickLine for LINE_8, shift 0, both caps.
void line_thick(const Canvas& c, P p0, P p1, int thickness, uint8_t color) {
  if (thickness <= 1) {
    line_thin(c, p0, p1, color);
    return;
  }
  // the end points are first clipped, in whole pixels, to the canvas grown by
  // the thickness on every side (which moves the line by the truncation)
  const int64_t m = thickness;
  p0 = P{p0.x + m, p0.y + m};
  p1 = P{p1.x + m, p1.y + m};
  if (!clip_line(c.w + 2 * m, c.h + 2 * m, p0, p1)) return;
  p0 = P{(p0.x - m) << XY_SHIFT, (p0.y - m) << XY_SHIFT};
  p1 = P{(p1.x - m) << XY_SHIFT, (p1.y - m) << XY_SHIFT};
  const double inv = 1.0 / XY_ONE;
  const double dx = (p0.x - p1.x) * inv, dy = (p1.y - p0.y) * inv;
  double r = dx * dx + dy * dy;
  const int odd = thickness & 1;
  const int64_t th = int64_t(thickness) << (XY_SHIFT - 1);
  if (std::fabs(r) > 2.220446049250313e-16) {
    r = (th + odd * XY_ONE * 0.5) / std::sqrt(r);
    const int64_t ddx = round_even(dy * r), ddy = round_even(dx * r);
    const P pt[4] = {{p0.x + ddx, p0.y + ddy},
                     {p0.x - ddx, p0.y - ddy},
                     {p1.x - ddx, p1.y - ddy},
                     {p1.x + ddx, p1.y + ddy}};
    fill_convex(c, pt, 4, color, XY_SHIFT);
  }
  const int rad = static_cast<int>((th + (XY_ONE >> 1)) >> XY_SHIFT);
  for (const P& p : {p0, p1}) {
    circle_filled(c, static_cast<int>((p.x + (XY_ONE >> 1)) >> XY_SHIFT),
                  static_cast<int>((p.y + (XY_ONE >> 1)) >> XY_SHIFT), rad, color);
  }
}

// OpenCV's fillPoly (CollectPolyEdges + FillEdgeCollection), LINE_8, shift 0.
struct PolyEdge {
  int y0, y1;
  int64_t x, dx;
  PolyEdge* next;
};

void fill_poly(const Canvas& c, const P* v, int count, uint8_t color) {
  std::vector<PolyEdge> edges;
  edges.reserve(count + 1);
  P pt0 = v[count - 1], pt1;
  pt0.x <<= XY_SHIFT;
  for (int i = 0; i < count; i++, pt0 = pt1) {
    pt1 = v[i];
    pt1.x <<= XY_SHIFT;
    P t0{(pt0.x + (XY_ONE >> 1)) >> XY_SHIFT, pt0.y};
    P t1{(pt1.x + (XY_ONE >> 1)) >> XY_SHIFT, pt1.y};
    line_thin(c, t0, t1, color);
    P pt0c = pt0, pt1c = pt1;
    if (t0.x < 0 || t0.x >= c.w || t1.x < 0 || t1.x >= c.w || t0.y < 0 || t0.y >= c.h ||
        t1.y < 0 || t1.y >= c.h) {
      // the edge runs along the clipped segment, whatever clipLine returns
      // (a segment clipped to one point gives a vertical edge)
      clip_line(c.w, c.h, t0, t1);
      pt0c = P{t0.x << XY_SHIFT, t0.y};
      pt1c = P{t1.x << XY_SHIFT, t1.y};
    }
    if (pt0.y == pt1.y) continue;
    PolyEdge e;
    e.dx = pt1c.y != pt0c.y ? (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y) : 0;
    if (pt0.y < pt1.y) {
      e.y0 = static_cast<int>(pt0.y);
      e.y1 = static_cast<int>(pt1.y);
      e.x = pt0c.x + (pt0.y - pt0c.y) * e.dx;
    } else {
      e.y0 = static_cast<int>(pt1.y);
      e.y1 = static_cast<int>(pt0.y);
      e.x = pt1c.x + (pt1.y - pt1c.y) * e.dx;
    }
    e.next = nullptr;
    edges.push_back(e);
  }

  const int total = static_cast<int>(edges.size());
  if (total < 2) return;
  int y_max = INT32_MIN, y_min = INT32_MAX;
  int64_t x_max = -1, x_min = INT64_MAX;
  for (const PolyEdge& e1 : edges) {
    const int64_t x1 = e1.x + (e1.y1 - e1.y0) * e1.dx;
    y_min = std::min(y_min, e1.y0);
    y_max = std::max(y_max, e1.y1);
    x_min = std::min(x_min, e1.x);
    x_max = std::max(x_max, e1.x);
    x_min = std::min(x_min, x1);
    x_max = std::max(x_max, x1);
  }
  if (y_max < 0 || y_min >= c.h || x_max < 0 || x_min >= (int64_t(c.w) << XY_SHIFT)) return;
  std::sort(edges.begin(), edges.end(), [](const PolyEdge& a, const PolyEdge& b) {
    return a.y0 - b.y0 ? a.y0 < b.y0 : a.x - b.x ? a.x < b.x : a.dx < b.dx;
  });
  PolyEdge tmp;
  tmp.y0 = INT32_MAX;
  edges.push_back(tmp);
  int i = 0;
  tmp.next = nullptr;
  PolyEdge* e = &edges[0];
  y_max = std::min(y_max, c.h);
  for (int y = e->y0; y < y_max; y++) {
    PolyEdge *last, *prelast, *keep_prelast;
    int draw = 0;
    const bool clipline = y < 0;
    prelast = &tmp;
    last = tmp.next;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          int x1, x2;
          if (keep_prelast->x > prelast->x) {
            x1 = static_cast<int>((prelast->x + XY_ONE - 1) >> XY_SHIFT);
            x2 = static_cast<int>(keep_prelast->x >> XY_SHIFT);
          } else {
            x1 = static_cast<int>((keep_prelast->x + XY_ONE - 1) >> XY_SHIFT);
            x2 = static_cast<int>(prelast->x >> XY_SHIFT);
          }
          if (x1 < c.w && x2 >= 0) {
            if (x1 < 0) x1 = 0;
            if (x2 >= c.w) x2 = c.w - 1;
            hline(c, y, x1, x2, color);
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    keep_prelast = nullptr;
    do {
      prelast = &tmp;
      last = tmp.next;
      PolyEdge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        PolyEdge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != tmp.next && keep_prelast != &tmp);
  }
}

// OpenCV's sine table: sin of 0..450 degrees, rounded to 7 decimals, as float
// (a function-local static: built once, safely, by the first thread).
struct SinTable {
  float v[451];
  SinTable() {
    for (int d = 0; d <= 450; d++) {
      const long double r = static_cast<long double>(d) * 3.14159265358979323846264338L / 180.0L;
      v[d] = static_cast<float>(std::nearbyint(static_cast<double>(std::sin(r) * 1e7L)) / 1e7);
    }
  }
};

float sin_table(int deg) {
  static const SinTable table;
  return table.v[deg];
}

// OpenCV's ellipse2Poly (double centre and axes, whole degrees).
void ellipse_poly(double cx, double cy, double aw, double ah, int angle, int arc_start,
                  int arc_end, int delta, std::vector<double>& pts) {
  while (angle < 0) angle += 360;
  while (angle > 360) angle -= 360;
  if (arc_start > arc_end) std::swap(arc_start, arc_end);
  while (arc_start < 0) {
    arc_start += 360;
    arc_end += 360;
  }
  while (arc_end > 360) {
    arc_end -= 360;
    arc_start -= 360;
  }
  if (arc_end - arc_start > 360) {
    arc_start = 0;
    arc_end = 360;
  }
  const int a = angle + (angle < 0 ? 360 : 0);
  const float beta = sin_table(a), alpha = sin_table(450 - a);
  pts.clear();
  for (int i = arc_start; i < arc_end + delta; i += delta) {
    int ang = i;
    if (ang > arc_end) ang = arc_end;
    if (ang < 0) ang += 360;
    const double x = aw * sin_table(450 - ang);
    const double y = ah * sin_table(ang);
    pts.push_back(cx + x * alpha - y * beta);
    pts.push_back(cy + x * beta + y * alpha);
  }
  if (pts.size() == 2) {
    pts.assign({cx, cy, cx, cy});
  }
}

void ellipse_filled(const Canvas& c, int cx, int cy, int ax, int ay, double angle_deg,
                    uint8_t color) {
  const int angle = static_cast<int>(round_even(angle_deg));
  const P center{int64_t(cx) << XY_SHIFT, int64_t(cy) << XY_SHIFT};
  int64_t aw = std::abs(int64_t(ax) << XY_SHIFT), ah = std::abs(int64_t(ay) << XY_SHIFT);
  int delta = static_cast<int>((std::max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT);
  delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
  std::vector<double> d;
  ellipse_poly(static_cast<double>(center.x), static_cast<double>(center.y),
               static_cast<double>(aw), static_cast<double>(ah), angle, 0, 360, delta, d);
  std::vector<P> v;
  P prev{INT64_MIN, INT64_MIN};
  for (size_t i = 0; i < d.size(); i += 2) {
    P pt;
    pt.x = round_even(d[i] / XY_ONE) << XY_SHIFT;
    pt.y = round_even(d[i + 1] / XY_ONE) << XY_SHIFT;
    pt.x += round_even(d[i] - pt.x);
    pt.y += round_even(d[i + 1] - pt.y);
    if (pt.x != prev.x || pt.y != prev.y) {
      v.push_back(pt);
      prev = pt;
    }
  }
  if (v.size() == 1) v.assign(2, center);
  fill_convex(c, v.data(), static_cast<int>(v.size()), color, XY_SHIFT);
}

void box_blur(const uint8_t* src, uint8_t* dst, int h, int w, int k) {
  const int r = k / 2;
  // horizontal running sums
  std::vector<int32_t> rows(static_cast<size_t>(h) * w);
  std::vector<int> idx(static_cast<size_t>(w + 2 * r));
  for (int i = 0; i < w + 2 * r; i++) idx[i] = reflect101(i - r, w);
  for (int y = 0; y < h; y++) {
    const uint8_t* s = src + static_cast<int64_t>(y) * w;
    int32_t* o = rows.data() + static_cast<int64_t>(y) * w;
    int32_t acc = 0;
    for (int i = 0; i < k; i++) acc += s[idx[i]];
    o[0] = acc;
    for (int x = 1; x < w; x++) {
      acc += s[idx[x + k - 1]] - s[idx[x - 1]];
      o[x] = acc;
    }
  }
  std::vector<int> yidx(static_cast<size_t>(h + 2 * r));
  for (int i = 0; i < h + 2 * r; i++) yidx[i] = reflect101(i - r, h);
  std::vector<int32_t> acc(static_cast<size_t>(w), 0);
  const bool small = 255 * k * k <= 65535;
  const double scale = 1.0 / (static_cast<double>(k) * k);
  const float fscale = static_cast<float>(scale);
  // OpenCV's ColumnSum<ushort, uchar>: division by k^2 in 23-bit fixed point
  const int d = static_cast<int>(round_even(1.0 / scale));
  double scalef = static_cast<double>(1 << 23) / d;
  int div_scale = static_cast<int>(std::floor(scalef));
  scalef -= div_scale;
  int div_delta = d / 2;
  if (scalef < 0.5) {
    div_delta++;
  } else {
    div_scale++;
  }
  for (int i = 0; i < k; i++) {
    const int32_t* s = rows.data() + static_cast<int64_t>(yidx[i]) * w;
    for (int x = 0; x < w; x++) acc[x] += s[x];
  }
  for (int y = 0; y < h; y++) {
    uint8_t* o = dst + static_cast<int64_t>(y) * w;
    for (int x = 0; x < w; x++) {
      int64_t v;
      if (small) {
        v = ((static_cast<uint32_t>(acc[x]) + div_delta) * static_cast<uint32_t>(div_scale)) >> 23;
      } else {
        v = static_cast<int64_t>(std::nearbyint(static_cast<float>(acc[x]) * fscale));
      }
      o[x] = sat_u8(v);
    }
    if (y + 1 < h) {
      const int32_t* add = rows.data() + static_cast<int64_t>(yidx[y + k]) * w;
      const int32_t* sub = rows.data() + static_cast<int64_t>(yidx[y]) * w;
      for (int x = 0; x < w; x++) acc[x] += add[x] - sub[x];
    }
  }
}

// OpenCV's getGaussianKernelBitExact: n (odd) taps of a bell of the given
// sigma, normalised to sum 1, in double.
std::vector<double> gaussian_bell(int n, double sigma) {
  std::vector<double> kd(static_cast<size_t>(n));
  const double scale2 = -0.125 / (sigma * sigma);
  const int n2 = (n - 1) / 2;
  std::vector<double> values(static_cast<size_t>(n2 + 1));
  double sum = 0.0;
  for (int i = 0, x = 1 - n; i < n2; i++, x += 2) {
    const double t = std::exp(static_cast<double>(x * x) * scale2);
    values[i] = t;
    sum += t;
  }
  sum *= 2.0;
  sum += 1.0;
  const double mul1 = 1.0 / sum;
  for (int i = 0; i < n2; i++) {
    const double t = values[i] * mul1;
    kd[i] = t;
    kd[n - 1 - i] = t;
  }
  kd[n2] = 1.0 * mul1;
  return kd;
}

// OpenCV's bit-exact Gaussian taps for 8-bit images: 8 fractional bits.
// ``sigma`` > 0 sets the bell; else it follows from n (the tables of 3..9).
std::vector<uint32_t> gaussian_taps(int n, double sigma) {
  std::vector<double> kd(static_cast<size_t>(n));
  if (n == 1) {
    kd = {1.0};
  } else if (sigma > 0.0) {
    kd = gaussian_bell(n, sigma);
  } else if (n == 3) {
    kd = {0.25, 0.5, 0.25};
  } else if (n == 5) {
    kd = {0.0625, 0.25, 0.375, 0.25, 0.0625};
  } else if (n == 7) {
    kd = {0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125};
  } else if (n == 9) {
    kd = {4.0 / 256, 13.0 / 256, 30.0 / 256, 51.0 / 256, 60.0 / 256,
          51.0 / 256, 30.0 / 256, 13.0 / 256, 4.0 / 256};
  } else {
    kd = gaussian_bell(n, static_cast<double>(n) * 0.15 + 0.35);
  }
  // error-diffused rounding to 8 fractional bits; the centre takes the rest
  std::vector<uint32_t> taps(static_cast<size_t>(n));
  const int n2 = n / 2;
  double err = 0.0;
  int64_t total = 0;
  for (int i = 0; i < n2; i++) {
    const double adj = kd[i] * 256.0 + err;
    const int64_t v0 = round_even(adj);
    err = adj - static_cast<double>(v0);
    taps[i] = taps[n - 1 - i] = static_cast<uint32_t>(v0);
    total += v0;
  }
  taps[n2] = static_cast<uint32_t>(256 - 2 * total);
  return taps;
}

void gaussian_blur(const uint8_t* src, uint8_t* dst, int h, int w, int n, double sigma) {
  const std::vector<uint32_t> t = gaussian_taps(n, sigma);
  const int r = n / 2;
  // horizontal pass at 8 fractional bits: at most 255 * 256, exact in 16 bits
  // (the taps are symmetric: one product per pair)
  std::vector<uint16_t> mid(static_cast<size_t>(h) * w);
  std::vector<uint16_t> row(static_cast<size_t>(w + 2 * r));
  for (int y = 0; y < h; y++) {
    const uint8_t* s = src + static_cast<int64_t>(y) * w;
    for (int i = 0; i < w + 2 * r; i++) row[i] = s[reflect101(i - r, w)];
    uint16_t* o = mid.data() + static_cast<int64_t>(y) * w;
    const uint16_t tc = static_cast<uint16_t>(t[r]);
    const uint16_t* c = row.data() + r;
    for (int x = 0; x < w; x++) o[x] = static_cast<uint16_t>(tc * c[x]);
    for (int k = 0; k < r; k++) {
      const uint16_t tk = static_cast<uint16_t>(t[k]);
      const uint16_t* lo = row.data() + k;
      const uint16_t* hi = row.data() + (n - 1 - k);
      for (int x = 0; x < w; x++) o[x] = static_cast<uint16_t>(o[x] + tk * (lo[x] + hi[x]));
    }
  }
  // vertical pass at 16 fractional bits: at most 255 * 2^16, exact in 32 bits
  std::vector<uint32_t> acc(static_cast<size_t>(w));
  for (int y = 0; y < h; y++) {
    const uint32_t tc = t[r];
    const uint16_t* c = mid.data() + static_cast<int64_t>(y) * w;
    for (int x = 0; x < w; x++) acc[x] = tc * c[x];
    for (int k = 0; k < r; k++) {
      const uint32_t tk = t[k];
      const uint16_t* lo = mid.data() + static_cast<int64_t>(reflect101(y + k - r, h)) * w;
      const uint16_t* hi = mid.data() + static_cast<int64_t>(reflect101(y + r - k, h)) * w;
      for (int x = 0; x < w; x++) acc[x] += tk * (static_cast<uint32_t>(lo[x]) + hi[x]);
    }
    uint8_t* o = dst + static_cast<int64_t>(y) * w;
    for (int x = 0; x < w; x++) o[x] = static_cast<uint8_t>(std::min<uint32_t>((acc[x] + (1u << 15)) >> 16, 255u));
  }
}

// OpenCV's LUImpl (partial pivoting) on an m x m system with one right side.
bool lu_solve(double* a, double* b, int m) {
  const double eps = 2.220446049250313e-16 * 100;
  for (int i = 0; i < m; i++) {
    int k = i;
    for (int j = i + 1; j < m; j++)
      if (std::fabs(a[j * m + i]) > std::fabs(a[k * m + i])) k = j;
    if (std::fabs(a[k * m + i]) < eps) return false;
    if (k != i) {
      for (int j = i; j < m; j++) std::swap(a[i * m + j], a[k * m + j]);
      std::swap(b[i], b[k]);
    }
    const double d = -1.0 / a[i * m + i];
    for (int j = i + 1; j < m; j++) {
      const double alpha = a[j * m + i] * d;
      for (int q = i + 1; q < m; q++) a[j * m + q] += alpha * a[i * m + q];
      b[j] += alpha * b[i];
    }
  }
  for (int i = m - 1; i >= 0; i--) {
    double s = b[i];
    for (int q = i + 1; q < m; q++) s -= a[i * m + q] * b[q];
    b[i] = s / a[i * m + i];
  }
  return true;
}

// OpenCV's invert() of a 3x3 (DECOMP_LU takes this closed form for n = 3).
bool invert3(const double* m, double* t) {
  auto a = [m](int i, int j) { return m[i * 3 + j]; };
  double d = a(0, 0) * (a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)) -
             a(0, 1) * (a(1, 0) * a(2, 2) - a(1, 2) * a(2, 0)) +
             a(0, 2) * (a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0));
  if (d == 0.0) return false;
  d = 1.0 / d;
  t[0] = (a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)) * d;
  t[1] = (a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2)) * d;
  t[2] = (a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)) * d;
  t[3] = (a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2)) * d;
  t[4] = (a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0)) * d;
  t[5] = (a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)) * d;
  t[6] = (a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)) * d;
  t[7] = (a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1)) * d;
  t[8] = (a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)) * d;
  return true;
}

// The bilinear sample of an image (float or 8-bit, taken as float) at
// (sx, sy), taps outside it 0.
template <typename T>
float linear_tap(const T* src, int h, int w, float sx, float sy) {
  const float fx = std::floor(sx), fy = std::floor(sy);
  // no tap inside (NaN too): the border value
  if (!(fx >= -1.0f && fx <= float(w - 1) && fy >= -1.0f && fy <= float(h - 1))) return 0.0f;
  const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
  auto at = [&](int y, int x) {
    return (x >= 0 && x < w && y >= 0 && y < h) ? static_cast<float>(src[static_cast<size_t>(y) * w + x])
                                                : 0.0f;
  };
  const float a = sx - fx, b = sy - fy;
  const float p00 = at(y0, x0), p01 = at(y0, x0 + 1), p10 = at(y0 + 1, x0),
              p11 = at(y0 + 1, x0 + 1);
  const float top = std::fma(a, p01 - p00, p00), bot = std::fma(a, p11 - p10, p10);
  return std::fma(b, bot - top, top);
}

inline float store(float v, float*) { return v; }
// an 8-bit destination: the float blend rounded to nearest, ties to even, and
// saturated (OpenCV's v_round and v_pack_u; saturate_cast in the scalar loop)
inline uint8_t store(float v, uint8_t*) { return sat_u8(cv_round(v)); }

// warpPerspective, INTER_LINEAR, BORDER_CONSTANT 0, of a float32 or 8-bit
// image (module comment); -1 for a singular H.
template <typename T>
int warp_perspective(const T* src, int sh, int sw, T* dst, int dh, int dw, const double* H) {
  double inv[9];
  if (!invert3(H, inv)) return -1;
  float m[9];
  for (int i = 0; i < 9; i++) m[i] = static_cast<float>(inv[i]);
  const int vec_end = dw / 16 * 16;
  for (int y = 0; y < dh; y++) {
    const float yf = static_cast<float>(y);
    const float rx = m[1] * yf + m[2], ry = m[4] * yf + m[5], rw = m[7] * yf + m[8];
    T* row = dst + static_cast<size_t>(y) * dw;
    for (int x = 0; x < dw; x++) {
      const float xf = static_cast<float>(x);
      float X, Y, Z;
      if (x < vec_end) {
        X = std::fma(m[0], xf, rx);
        Y = std::fma(m[3], xf, ry);
        Z = std::fma(m[6], xf, rw);
      } else {
        X = std::fma(xf, m[0], yf * m[1]) + m[2];
        Y = std::fma(xf, m[3], yf * m[4]) + m[5];
        Z = std::fma(xf, m[6], yf * m[7]) + m[8];
      }
      row[x] = store(linear_tap(src, sh, sw, X / Z, Y / Z), row);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// cv::warpPerspective(src, dst, H, (dw, dh), INTER_LINEAR) of a float32 [sh, sw]
// image into dst [dh, dw]; H row-major, source to destination.  Returns -1
// (dst untouched) for a singular H.
int ssp_warp_perspective(const float* src, int sh, int sw, float* dst, int dh, int dw,
                         const double* H) {
  return warp_perspective(src, sh, sw, dst, dh, dw, H);
}

// The same of an 8-bit image.
int ssp_warp_perspective_u8(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw,
                            const double* H) {
  return warp_perspective(src, sh, sw, dst, dh, dw, H);
}

int ssp_line(uint8_t* img, int h, int w, int64_t x1, int64_t y1, int64_t x2, int64_t y2,
             int color, int thickness) {
  line_thick(Canvas{img, h, w}, P{x1, y1}, P{x2, y2}, thickness, static_cast<uint8_t>(color));
  return 0;
}

int ssp_fill_convex_poly(uint8_t* img, int h, int w, const int32_t* xy, int n, int color) {
  if (n <= 0) return 0;
  std::vector<P> v(static_cast<size_t>(n));
  for (int i = 0; i < n; i++) v[i] = P{xy[2 * i], xy[2 * i + 1]};
  fill_convex(Canvas{img, h, w}, v.data(), n, static_cast<uint8_t>(color), 0);
  return 0;
}

int ssp_fill_poly(uint8_t* img, int h, int w, const int32_t* xy, int n, int color) {
  if (n <= 0) return 0;
  std::vector<P> v(static_cast<size_t>(n));
  for (int i = 0; i < n; i++) v[i] = P{xy[2 * i], xy[2 * i + 1]};
  fill_poly(Canvas{img, h, w}, v.data(), n, static_cast<uint8_t>(color));
  return 0;
}

int ssp_line_aa(uint8_t* img, int h, int w, int nch, int64_t x1, int64_t y1, int64_t x2,
                int64_t y2, const uint8_t* color) {
  line_aa(ColorCanvas{img, h, w, nch}, P{x1 * XY_ONE, y1 * XY_ONE}, P{x2 * XY_ONE, y2 * XY_ONE},
          color);
  return 0;
}

int ssp_circle_filled_color(uint8_t* img, int h, int w, int nch, int cx, int cy, int radius,
                            const uint8_t* color) {
  const ColorCanvas c{img, h, w, nch};
  circle_spans(w, h, cx, cy, radius, [&](int y, int x1, int x2) {
    for (int x = x1; x <= x2; x++) std::memcpy(c.at(x, y), color, static_cast<size_t>(nch));
  });
  return 0;
}

int ssp_circle_filled(uint8_t* img, int h, int w, int cx, int cy, int radius, int color) {
  circle_filled(Canvas{img, h, w}, cx, cy, radius, static_cast<uint8_t>(color));
  return 0;
}

int ssp_ellipse_filled(uint8_t* img, int h, int w, int cx, int cy, int ax, int ay, double angle,
                       int color) {
  ellipse_filled(Canvas{img, h, w}, cx, cy, ax, ay, angle, static_cast<uint8_t>(color));
  return 0;
}

int ssp_box_blur(const uint8_t* src, uint8_t* dst, int h, int w, int k) {
  box_blur(src, dst, h, w, k);
  return 0;
}

int ssp_gaussian_blur(const uint8_t* src, uint8_t* dst, int h, int w, int n) {
  gaussian_blur(src, dst, h, w, n, 0.0);
  return 0;
}

// cv::GaussianBlur(src, dst, Size(0, 0), sigma) of an 8-bit image: the kernel
// size cvRound(sigma * 3 * 2 + 1) | 1, the taps from sigma.
int ssp_gaussian_blur_sigma(const uint8_t* src, uint8_t* dst, int h, int w, double sigma) {
  gaussian_blur(src, dst, h, w, cv_round(sigma * 3 * 2 + 1) | 1, sigma);
  return 0;
}

// src, dst: 3 (x, y) float pairs; out: the 2 x 3 matrix, row-major.
int ssp_affine_transform(const float* src, const float* dst, double* out) {
  double a[36], b[6];
  for (int i = 0; i < 3; i++) {
    const int j = i * 12, k = i * 12 + 6;
    a[j] = a[k + 3] = src[2 * i];
    a[j + 1] = a[k + 4] = src[2 * i + 1];
    a[j + 2] = a[k + 5] = 1;
    a[j + 3] = a[j + 4] = a[j + 5] = 0;
    a[k] = a[k + 1] = a[k + 2] = 0;
    b[i * 2] = dst[2 * i];
    b[i * 2 + 1] = dst[2 * i + 1];
  }
  if (!lu_solve(a, b, 6)) {
    std::fill(out, out + 6, 0.0);
    return 0;
  }
  std::copy(b, b + 6, out);
  return 0;
}

// src, dst: 4 (x, y) float pairs; out: the 3 x 3 matrix, row-major.
int ssp_perspective_transform(const float* src, const float* dst, double* out) {
  double a[64], b[8];
  for (int i = 0; i < 4; i++) {
    const float sx = src[2 * i], sy = src[2 * i + 1], dx = dst[2 * i], dy = dst[2 * i + 1];
    double* r0 = a + i * 8;
    double* r1 = a + (i + 4) * 8;
    r0[0] = r1[3] = sx;
    r0[1] = r1[4] = sy;
    r0[2] = r1[5] = 1;
    r0[3] = r0[4] = r0[5] = r1[0] = r1[1] = r1[2] = 0;
    r0[6] = -sx * dx;
    r0[7] = -sy * dx;
    r1[6] = -sx * dy;
    r1[7] = -sy * dy;
    b[i] = dx;
    b[i + 4] = dy;
  }
  if (!lu_solve(a, b, 8)) {
    std::fill(out, out + 9, 0.0);
    return 0;
  }
  std::copy(b, b + 8, out);
  out[8] = 1.0;
  return 0;
}

}  // extern "C"
