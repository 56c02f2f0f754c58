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
// coef kernel), 4 B written, and two taps that neighbours share.  In both
// kernels neighbouring threads own neighbouring x, so coordinate reads and
// output writes are fully coalesced; the taps come through L1/L2.  The coef
// kernel trades the coordinate's bytes for arithmetic, which has to be kept
// small to stay under the memory time: see the note above it.

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
//
// With Lo, Ll the normalised indices along the resampled axis and the line,
//   q(k) = p0(k) + p1(k)*Lo,  p0(k) = c[k] + c[k+1]*Ll,  p1(k) = c[k+2] + c[k+3]*Ll,
// so everything but the last multiply-add of each q is constant along a
// row or a column of the image.  A block owns a COEF_TX x COEF_TY tile of
// one warp; a thread owns one column x of the tile and walks down its rows,
// COEF_LANES rows apart, so neighbouring threads stay on neighbouring
// addresses for either axis.  What is constant along the column (AXIS 0:
// Ll and the eight p values; AXIS 1: Lo) is computed once per thread into
// registers; what is constant along a row (AXIS 0: Lo; AXIS 1: the eight p
// values) once per block into a shared-memory table that a warp reads as a
// broadcast.  The 20 coefficients reach shared memory once per block.  The
// keep bounds are tested first: a tile wholly outside them is zero-filled
// without any arithmetic, a pixel outside them costs two comparisons, and
// the divide-free kill test comes before the one division that is left per
// pixel.  Each operation that remains is the same rounded operation on the
// same operands as before the hoisting, so the coordinates are still those
// of `coef_coords` bit for bit.
constexpr int COEF_TX = 64;
constexpr int COEF_TY = 64;
constexpr int COEF_LANES = THREADS / COEF_TX;

__device__ __forceinline__ float normalised(int i, float half) {
  return __fsub_rn(__fdiv_rn(float(i), half), 1.0f);
}

template <int AXIS>
__global__ void __launch_bounds__(THREADS)
vresample_coef_kernel(const float* __restrict__ img, const float* __restrict__ coefs,
                      float* __restrict__ out, int per_img, int R, int C, int tiles_x,
                      int tiles_y) {
  __shared__ float cs[20];
  __shared__ __align__(16) float row_tab[COEF_TY][AXIS == 0 ? 1 : 8];

  const int tiles = tiles_x * tiles_y;
  const int n = blockIdx.x / tiles, tile = blockIdx.x - n * tiles;
  const int x_first = (tile % tiles_x) * COEF_TX, y_first = (tile / tiles_x) * COEF_TY;
  const int tx = threadIdx.x % COEF_TX, ty = threadIdx.x / COEF_TX;
  const int x = x_first + tx;
  const int x_last = min(x_first + COEF_TX, C) - 1, y_last = min(y_first + COEF_TY, R) - 1;
  const size_t sz = size_t(R) * C;
  float* o_img = out + n * sz;

  if (threadIdx.x < 20) cs[threadIdx.x] = __ldg(coefs + size_t(n) * 20 + threadIdx.x);
  __syncthreads();

  // keep bounds: [cs[16], cs[17]) along the resampled axis, [cs[18], cs[19])
  // along the line; rows are the resampled axis for AXIS 0, the line for AXIS 1
  const float ylo = cs[AXIS == 0 ? 16 : 18], yhi = cs[AXIS == 0 ? 17 : 19];
  const float xlo = cs[AXIS == 0 ? 18 : 16], xhi = cs[AXIS == 0 ? 19 : 17];
  if (float(y_last) < ylo || float(y_first) >= yhi || float(x_last) < xlo ||
      float(x_first) >= xhi) {  // the same for every thread of the block
    if (x < C)
      for (int y = y_first + ty; y <= y_last; y += COEF_LANES) o_img[size_t(y) * C + x] = 0.0f;
    return;
  }

  const int L = AXIS == 0 ? R : C;
  const float half_o = (L - 1) / 2.0f, half_l = ((AXIS == 0 ? C : R) - 1) / 2.0f;
  if (threadIdx.x < COEF_TY) {
    const int y = y_first + threadIdx.x;
    if (AXIS == 0) {
      row_tab[threadIdx.x][0] = normalised(y, half_o);
    } else {
      const float Ll = normalised(y, half_l);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        row_tab[threadIdx.x][2 * k] = __fadd_rn(cs[4 * k], __fmul_rn(cs[4 * k + 1], Ll));
        row_tab[threadIdx.x][2 * k + 1] = __fadd_rn(cs[4 * k + 2], __fmul_rn(cs[4 * k + 3], Ll));
      }
    }
  }
  __syncthreads();
  if (x >= C) return;

  // p[2k], p[2k+1] = p0, p1 of quadruple k (num, den, kill num, kill den)
  float p[8], Lo = 0.0f;
  if (AXIS == 0) {
    const float Ll = normalised(x, half_l);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p[2 * k] = __fadd_rn(cs[4 * k], __fmul_rn(cs[4 * k + 1], Ll));
      p[2 * k + 1] = __fadd_rn(cs[4 * k + 2], __fmul_rn(cs[4 * k + 3], Ll));
    }
  } else {
    Lo = normalised(x, half_o);
  }
  const bool col_keep = float(x) >= xlo && float(x) < xhi;
  const float* src = img + (n / per_img) * sz;

#pragma unroll 4
  for (int yy = ty; yy < COEF_TY; yy += COEF_LANES) {
    const int y = y_first + yy;
    if (y > y_last) break;
    float v = 0.0f;
    if (col_keep && float(y) >= ylo && float(y) < yhi) {
      if (AXIS == 0) {
        Lo = row_tab[yy][0];
      } else {
        const float4 lo = *reinterpret_cast<const float4*>(&row_tab[yy][0]);
        const float4 hi = *reinterpret_cast<const float4*>(&row_tab[yy][4]);
        p[0] = lo.x, p[1] = lo.y, p[2] = lo.z, p[3] = lo.w;
        p[4] = hi.x, p[5] = hi.y, p[6] = hi.z, p[7] = hi.w;
      }
      const float kill_num = __fadd_rn(p[4], __fmul_rn(p[5], Lo));
      const float kill_den = __fadd_rn(p[6], __fmul_rn(p[7], Lo));
      // a NaN fails the comparison and the pixel stays 0, as a killed one does
      if (fabsf(kill_num) <= __fmul_rn(1.5f, fabsf(kill_den))) {
        const float num = __fadd_rn(p[0], __fmul_rn(p[1], Lo));
        float den = __fadd_rn(p[2], __fmul_rn(p[3], Lo));
        if (fabsf(den) < 1e-8f) den = 1e-8f;
        float r = __fmul_rn(__fadd_rn(__fdiv_rn(num, den), 1.0f), half_o);
        // fmaxf returns its other operand for a NaN, so a NaN coordinate
        // clips to -64 and yields 0, as every out-of-range coordinate does
        r = fminf(fmaxf(r, -64.0f), float(L) + 64.0f);
        v = hat2<AXIS>(src, r, L, AXIS == 0 ? x : y, C);
      }
    }
    o_img[size_t(y) * C + x] = v;
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
  const int tiles_x = (C + COEF_TX - 1) / COEF_TX, tiles_y = (R + COEF_TY - 1) / COEF_TY;
  if (size_t(N) * tiles_x * tiles_y > size_t(0x7fffffff)) return int(cudaErrorInvalidValue);
  const unsigned blocks = unsigned(N) * tiles_x * tiles_y;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(img);
  auto b = static_cast<const float*>(coefs);
  auto c = static_cast<float*>(out);
  if (axis == 0)
    vresample_coef_kernel<0><<<blocks, THREADS, 0, s>>>(a, b, c, N / M, R, C, tiles_x, tiles_y);
  else
    vresample_coef_kernel<1><<<blocks, THREADS, 0, s>>>(a, b, c, N / M, R, C, tiles_x, tiles_y);
  return int(cudaGetLastError());
}
