// The small pieces of OpenCV's core that the host libraries share
// (raster_host.cpp, features_host.cpp): borderInterpolate with
// BORDER_REFLECT_101, cvRound / cvFloor / cvCeil, and saturate_cast<uchar>.
// Rounding uses the current rounding mode (to nearest, ties to even), as
// OpenCV's SSE2 cvRound does.

#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace sspcv {

// borderInterpolate(p, len, BORDER_REFLECT_101)
inline int reflect101(int p, int len) {
  if (len == 1) return 0;
  while (p < 0 || p >= len) p = p < 0 ? -p : 2 * len - 2 - p;
  return p;
}

inline int cv_round(double v) { return static_cast<int>(std::lrint(v)); }
inline int cv_round(float v) { return static_cast<int>(std::lrintf(v)); }
// cvRound into 64 bits, for fixed-point coordinates that outgrow int
inline int64_t round_even(double v) { return static_cast<int64_t>(std::nearbyint(v)); }

inline int cv_floor(double v) {
  const int i = static_cast<int>(v);
  return i - (i > v);
}
inline int cv_floor(float v) {
  const int i = static_cast<int>(v);
  return i - (i > v);
}
inline int cv_ceil(float v) {
  const int i = static_cast<int>(v);
  return i + (i < v);
}

// saturate_cast<uchar> of an integer
template <typename T>
inline uint8_t sat_u8(T v) {
  return static_cast<uint8_t>(std::min<T>(std::max<T>(v, T(0)), T(255)));
}

}  // namespace sspcv
