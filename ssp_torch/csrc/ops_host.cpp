// Host-side ops of the port (its own copy of ``ssp/native/ops.cpp``): the
// exact greedy NMS of the evaluation protocol, a bilinear inverse warp for
// dataset tooling and two-way nearest-neighbour matching.  No device code
// calls these; ``ssp_torch/native/__init__.py`` loads them through ctypes.
//
// Built by ``ssp_torch/kernels/_build.py`` with the system g++ and its
// GXX_FLAGS (-O2, no contraction into FMA): the arithmetic is the source's,
// operation for operation, so the plain numpy versions beside the wrappers
// reproduce it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Exact greedy grid NMS (MagicLeap semantics): visit points by descending
// score; keep a point iff no previously kept point lies within Chebyshev
// distance <= dist.  Points with a score below min_score or not above 0 are
// never visited.  scores: [H*W] row-major; keep_out: [H*W] uint8 (1 = kept).
// Returns the number kept.  The order of tied scores is std::sort's, which is
// not stable: the same as ssp/native/ops.cpp's with the same library.
int64_t ssp_greedy_nms(const float* scores, int64_t H, int64_t W, int64_t dist,
                       float min_score, uint8_t* keep_out) {
  const int64_t n = H * W;
  std::vector<int64_t> idx;
  idx.reserve(n / 16);
  for (int64_t i = 0; i < n; ++i) {
    if (scores[i] >= min_score && scores[i] > 0.f) idx.push_back(i);
  }
  std::sort(idx.begin(), idx.end(),
            [scores](int64_t a, int64_t b) { return scores[a] > scores[b]; });

  std::memset(keep_out, 0, n);
  std::vector<uint8_t> suppressed(n, 0);
  int64_t kept = 0;
  for (int64_t i : idx) {
    if (suppressed[i]) continue;
    keep_out[i] = 1;
    ++kept;
    const int64_t y = i / W, x = i % W;
    const int64_t y0 = std::max<int64_t>(0, y - dist);
    const int64_t y1 = std::min<int64_t>(H - 1, y + dist);
    const int64_t x0 = std::max<int64_t>(0, x - dist);
    const int64_t x1 = std::min<int64_t>(W - 1, x + dist);
    for (int64_t yy = y0; yy <= y1; ++yy) {
      std::memset(&suppressed[yy * W + x0], 1, x1 - x0 + 1);
    }
  }
  return kept;
}

// Bilinear inverse warp with zero padding in normalised [-1, 1]
// align-corners coordinates, in double.  img: [H*W]; Hm: the 3x3 row-major
// output -> input map; out: [H*W].
void ssp_inv_warp_bilinear(const float* img, int64_t H, int64_t W, const double* Hm,
                           float* out) {
  const double sx = (W - 1) / 2.0, sy = (H - 1) / 2.0;
  for (int64_t py = 0; py < H; ++py) {
    const double ny = py / sy - 1.0;
    for (int64_t px = 0; px < W; ++px) {
      const double nx = px / sx - 1.0;
      const double w = Hm[6] * nx + Hm[7] * ny + Hm[8];
      const double u = (Hm[0] * nx + Hm[1] * ny + Hm[2]) / w;
      const double v = (Hm[3] * nx + Hm[4] * ny + Hm[5]) / w;
      const double fx = (u + 1.0) * sx;
      const double fy = (v + 1.0) * sy;
      const int64_t x0 = static_cast<int64_t>(std::floor(fx));
      const int64_t y0 = static_cast<int64_t>(std::floor(fy));
      const double wx = fx - x0, wy = fy - y0;
      double acc = 0.0;
      for (int dy = 0; dy <= 1; ++dy) {
        for (int dx = 0; dx <= 1; ++dx) {
          const int64_t xx = x0 + dx, yy = y0 + dy;
          if (xx < 0 || xx >= W || yy < 0 || yy >= H) continue;
          const double wgt = (dx ? wx : 1.0 - wx) * (dy ? wy : 1.0 - wy);
          acc += wgt * img[yy * W + xx];
        }
      }
      out[py * W + px] = static_cast<float>(acc);
    }
  }
}

// Two-way nearest-neighbour matching of unit-norm descriptors by float dot
// products summed in index order.  d1: [n1*D], d2: [n2*D]; out_idx: [n1] the
// nearest of set 2 (the first of equal similarities); out_dist: [n1]
// sqrt(2 - 2 sim); out_mutual: [n1] 1 iff point i is also the nearest of set
// 1 to out_idx[i] (the first i of equal similarities).
void ssp_nn_match_two_way(const float* d1, int64_t n1, const float* d2, int64_t n2, int64_t D,
                          int32_t* out_idx, float* out_dist, uint8_t* out_mutual) {
  std::vector<int32_t> best2(n2, -1);
  std::vector<float> best2_sim(n2, -2.f);
  std::vector<float> best1_sim(n1, -2.f);
  for (int64_t i = 0; i < n1; ++i) {
    const float* a = d1 + i * D;
    int32_t arg = -1;
    float best = -2.f;
    for (int64_t j = 0; j < n2; ++j) {
      const float* b = d2 + j * D;
      float s = 0.f;
      for (int64_t k = 0; k < D; ++k) s += a[k] * b[k];
      if (s > best) { best = s; arg = static_cast<int32_t>(j); }
      if (s > best2_sim[j]) { best2_sim[j] = s; best2[j] = static_cast<int32_t>(i); }
    }
    out_idx[i] = arg;
    best1_sim[i] = best;
  }
  for (int64_t i = 0; i < n1; ++i) {
    const float sim = std::min(std::max(best1_sim[i], -1.f), 1.f);
    out_dist[i] = std::sqrt(std::max(2.f - 2.f * sim, 0.f));
    out_mutual[i] = (out_idx[i] >= 0 && best2[out_idx[i]] == i) ? 1 : 0;
  }
}

}  // extern "C"
