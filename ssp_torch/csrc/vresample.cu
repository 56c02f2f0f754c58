// 1-D bilinear resample along one axis of a batch of fp32 images, zero
// padding: the two passes of the two-pass projective warp.
//
//   out[n, o, l] = sum_i max(0, 1 - |r - i|) * img[m(n), i, l],   r = coordinate of (n, o, l)
//
// with `o` the index along the resampled axis, `l` the index of the line
// (the other axis) and L the source length along the axis.  The hat sum has
// at most two non-zero terms, rows floor(r) (weight 1 - f) and floor(r) + 1
// (weight f), each dropped when outside [0, L - 1].  So:
//
//   * r in (-1, L):  two taps, gathered directly;
//   * anything else, +-inf and NaN included (every comparison with NaN is
//     false): 0 is written and no tap is read.  The range test is made on
//     the float, before any conversion to int, which is undefined for
//     values an int cannot hold.  A "killed" coordinate (-10) is one such r.
//
// Two kernels share the body.  `vresample_kernel` reads r from a
// coordinate array of the output's shape.  `vresample_coef_kernel`
// rebuilds r from 20 scalars per warp (a bilinear-rational numerator and
// denominator, a divide-free kill test, four keep bounds, a clip to
// [-64, L + 64]) and reads no coordinate array.  Its coordinate arithmetic
// uses the round-to-nearest intrinsics one operation at a time, so nvcc
// contracts nothing to FMA and the coordinates are bit-for-bit those of the
// same formula written as separate fp32 tensor operations: a contracted
// product would move a coordinate by parts in 1e7 and could flip the kill
// test of a pixel on the boundary.
//
// AXIS selects the layout without any transposed copy: with AXIS 0 an image
// is [L, C], a thread's line is its column and tap i sits at i * C + l
// (neighbouring threads read neighbouring addresses); with AXIS 1 an image
// is [R, L], the line is the row and tap i sits at l * L + i (the taps of
// one output row fall in a few cache lines).
//
// Batching: N outputs, M images, N % M == 0; output n reads image
// n / (N / M).  M = 1 shares one image among all warps, M = N gives each its
// own, without expanding anything.
//
// What bounds it: bytes.  Per output pixel 4 B of coordinate (none for the
// coef kernel), 4 B written, and two taps that neighbours share.  One thread
// per output pixel, x fastest, so coordinate reads and output writes are
// fully coalesced; the taps come through L1/L2.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int AXIS>
__device__ __forceinline__ float hat2(const float* __restrict__ img, float r, int L,
                                      int line, int C) {
  if (!(r > -1.0f && r < float(L))) return 0.0f;
  const float fl = floorf(r);
  const float f = r - fl;
  const int i0 = int(fl);  // in [-1, L - 1]
  const size_t step = AXIS == 0 ? size_t(C) : size_t(1);
  const float* base = img + (AXIS == 0 ? size_t(line) : size_t(line) * L);
  const float v0 = i0 >= 0 ? __ldg(base + size_t(i0) * step) : 0.0f;
  const float v1 = i0 + 1 < L ? __ldg(base + size_t(i0 + 1) * step) : 0.0f;
  return (1.0f - f) * v0 + f * v1;
}

// out, coords: [N, Ro, Co]; img: [M, L, Co] (AXIS 0) or [M, Ro, L] (AXIS 1)
template <int AXIS>
__global__ void vresample_kernel(const float* __restrict__ img,
                                 const float* __restrict__ coords,
                                 float* __restrict__ out, int N, int per_img,
                                 int Ro, int Co, int L) {
  const int pix = blockIdx.x * THREADS + threadIdx.x;
  if (pix >= Ro * Co) return;
  const int y = pix / Co, x = pix - y * Co;
  const int line = AXIS == 0 ? x : y;
  const size_t img_sz = AXIS == 0 ? size_t(L) * Co : size_t(Ro) * L;
  const size_t out_sz = size_t(Ro) * Co;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const float r = coords[n * out_sz + pix];
    out[n * out_sz + pix] = hat2<AXIS>(img + (n / per_img) * img_sz, r, L, line, Co);
  }
}

// img, out: [*, R, C]; coefs: [N, 20].  The resampled axis has length
// L = R (AXIS 0) or C (AXIS 1); the line axis has the other length.
template <int AXIS>
__global__ void vresample_coef_kernel(const float* __restrict__ img,
                                      const float* __restrict__ coefs,
                                      float* __restrict__ out, int N, int per_img,
                                      int R, int C) {
  const int pix = blockIdx.x * THREADS + threadIdx.x;
  if (pix >= R * C) return;
  const int y = pix / C, x = pix - y * C;
  const int L = AXIS == 0 ? R : C;
  const int n_lines = AXIS == 0 ? C : R;
  const int o = AXIS == 0 ? y : x;
  const int line = AXIS == 0 ? x : y;
  const float io = float(o), il = float(line);
  const float half_o = (L - 1) / 2.0f, half_l = (n_lines - 1) / 2.0f;
  const float Lo = __fsub_rn(__fdiv_rn(io, half_o), 1.0f);
  const float Ll = __fsub_rn(__fdiv_rn(il, half_l), 1.0f);
  const size_t sz = size_t(R) * C;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const float* c = coefs + size_t(n) * 20;
    // q(k) = c[k] + c[k+1]*Ll + (c[k+2] + c[k+3]*Ll)*Lo, each op rounded
    auto q = [&](int k) {
      const float p0 = __fadd_rn(__ldg(c + k), __fmul_rn(__ldg(c + k + 1), Ll));
      const float p1 = __fadd_rn(__ldg(c + k + 2), __fmul_rn(__ldg(c + k + 3), Ll));
      return __fadd_rn(p0, __fmul_rn(p1, Lo));
    };
    float den = q(4);
    if (fabsf(den) < 1e-8f) den = 1e-8f;
    float r = __fmul_rn(__fadd_rn(__fdiv_rn(q(0), den), 1.0f), half_o);
    const bool keep = fabsf(q(8)) <= __fmul_rn(1.5f, fabsf(q(12))) &&
                      io >= __ldg(c + 16) && io < __ldg(c + 17) &&
                      il >= __ldg(c + 18) && il < __ldg(c + 19);
    // fmaxf returns its other operand for a NaN, so a NaN coordinate clips
    // to -64 and yields 0, as every out-of-range coordinate does
    r = keep ? fminf(fmaxf(r, -64.0f), float(L) + 64.0f) : -10.0f;
    out[n * sz + pix] = hat2<AXIS>(img + (n / per_img) * sz, r, L, line, C);
  }
}

dim3 grid_for(int pixels, int N) {
  return dim3((pixels + THREADS - 1) / THREADS, N < 65535 ? N : 65535);
}

}  // namespace

extern "C" int ssp_vresample_launch(const void* img, const void* coords, void* out,
                                    int N, int M, int Ro, int Co, int L, int axis,
                                    void* stream) {
  if (N <= 0 || M <= 0 || N % M || Ro <= 0 || Co <= 0 || L <= 0 || (axis != 0 && axis != 1))
    return int(cudaErrorInvalidValue);
  const dim3 grid = grid_for(Ro * Co, N);
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(img);
  auto b = static_cast<const float*>(coords);
  auto c = static_cast<float*>(out);
  if (axis == 0)
    vresample_kernel<0><<<grid, THREADS, 0, s>>>(a, b, c, N, N / M, Ro, Co, L);
  else
    vresample_kernel<1><<<grid, THREADS, 0, s>>>(a, b, c, N, N / M, Ro, Co, L);
  return int(cudaGetLastError());
}

extern "C" int ssp_vresample_coef_launch(const void* img, const void* coefs, void* out,
                                         int N, int M, int R, int C, int axis,
                                         void* stream) {
  if (N <= 0 || M <= 0 || N % M || R < 2 || C < 2 || (axis != 0 && axis != 1))
    return int(cudaErrorInvalidValue);
  const dim3 grid = grid_for(R * C, N);
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(img);
  auto b = static_cast<const float*>(coefs);
  auto c = static_cast<float*>(out);
  if (axis == 0)
    vresample_coef_kernel<0><<<grid, THREADS, 0, s>>>(a, b, c, N, N / M, R, C);
  else
    vresample_coef_kernel<1><<<grid, THREADS, 0, s>>>(a, b, c, N, N / M, R, C);
  return int(cudaGetLastError());
}
