// Iterated local-max suppression (SuperPoint NMS) with optional border
// zeroing, [B,H,W] fp32 -> [B,H,W] fp32.
//
// Replaces the TPU kernel ssp/kernels/nms_pallas.py::nms_pallas; computes
// exactly ssp/postprocess/nms.py::simple_nms followed by zero_border.
//
// Bound on an H100: memory.  The function reads the heatmap once and
// writes it once (2 x 19.7 MB at 480x640x16, ~12 us at 3.35 TB/s), and its
// arithmetic is max/compare only.  The design keeps the whole suppression
// chain in shared memory so each pixel crosses HBM once each way:
//
//   * a block owns a CORE_H x core_w core and loads it with a halo of
//     radius * (2 * iterations - 1) pixels on every side -- the receptive
//     field of the chain of 2 * iterations - 1 window maxes -- reading
//     -inf outside the image, which is the reduce_window padding of the
//     reference;
//   * window max k of the chain is needed only k * radius pixels inside
//     the loaded tile (the next max reads radius further out), so each
//     pass and the elementwise steps between passes run on a region that
//     shrinks by radius per pass, and no window is ever clipped;
//   * every (2r+1)^2 window max is separable: a row pass into a scratch
//     plane, then a column pass; a warp walks 32 neighbouring cells of one
//     row, so every shared-memory access is conflict-free;
//   * cells outside the image never become maxima and never suppress;
//   * only the core is written, with the border band zeroed against the
//     true H and W;
//   * core_w is the widest of 128, 64, 32 whose tile fits a block's shared
//     memory (128 at radius 4: the tile is 2.95x the core, 72 x 168 cells).
//
// max and == are exact, so the result is bit-identical to the reference.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CORE_H = 32;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int TX = 32, TY = 16;  // block = TX x TY threads
constexpr int NTHREADS = TX * TY;

// A rectangle of the loaded tile, in tile coordinates: rows [y0, y1),
// columns [x0, x1).
struct Rect {
  int y0, y1, x0, x1;
  __device__ Rect shrink(int m) const { return {y0 + m, y1 - m, x0 + m, x1 - m}; }
};

// Calls f(i, y, x) for every cell of r, i = y * ew + x, spread over the block.
template <typename F>
__device__ __forceinline__ void for_cells(const Rect& r, int ew, F f) {
  for (int y = r.y0 + threadIdx.y; y < r.y1; y += TY)
    for (int x = r.x0 + threadIdx.x; x < r.x1; x += TX) f(y * ew + x, y, x);
}

// dst = (2r+1)^2 window max of src on region `out`; src must be valid on
// `out` grown by r; tmp is scratch.
__device__ void window_max(const float* src, float* tmp, float* dst, const Rect& out,
                           int ew, int r) {
  const Rect rows{out.y0 - r, out.y1 + r, out.x0, out.x1};
  for_cells(rows, ew, [&](int i, int, int) {
    float m = src[i - r];
    for (int d = 1 - r; d <= r; ++d) m = fmaxf(m, src[i + d]);
    tmp[i] = m;
  });
  __syncthreads();
  for_cells(out, ew, [&](int i, int, int) {
    float m = tmp[i - r * ew];
    for (int d = 1 - r; d <= r; ++d) m = fmaxf(m, tmp[i + d * ew]);
    dst[i] = m;
  });
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS, 1)
nms_kernel(const float* __restrict__ in, float* __restrict__ out, int H, int W,
           int radius, int iterations, int border, int halo, int core_w) {
  extern __shared__ float sm[];
  const int eh = CORE_H + 2 * halo, ew = core_w + 2 * halo, n = eh * ew;
  const int ty0 = blockIdx.y * CORE_H - halo;  // image row of tile row 0
  const int tx0 = blockIdx.x * core_w - halo;  // image column of tile column 0
  // the image, in tile coordinates
  const Rect img{max(0, -ty0), min(eh, H - ty0), max(0, -tx0), min(ew, W - tx0)};
  auto inside = [&](int y, int x) { return y >= img.y0 && y < img.y1 && x >= img.x0 && x < img.x1; };

  float* S = sm;       // scores, -inf outside the image
  float* T = S + n;    // row-pass scratch
  float* X = T + n;    // window max
  float* P = X + n;    // suppressed scores / mask as float
  unsigned char* M = reinterpret_cast<unsigned char*>(P + n);  // max mask
  unsigned char* U = M + n;                                     // suppressed

  const float* src = in + size_t(blockIdx.z) * H * W;
  const Rect tile{0, eh, 0, ew};
  for_cells(tile, ew, [&](int i, int y, int x) {
    S[i] = inside(y, x) ? src[size_t(ty0 + y) * W + tx0 + x] : -INFINITY;
  });
  __syncthreads();

  Rect reg = tile.shrink(radius);
  window_max(S, T, X, reg, ew, radius);
  for_cells(reg, ew, [&](int i, int y, int x) { M[i] = inside(y, x) && S[i] == X[i]; });
  __syncthreads();

  for (int it = 1; it < iterations; ++it) {
    for_cells(reg, ew, [&](int i, int, int) { P[i] = M[i] ? 1.f : 0.f; });
    __syncthreads();
    reg = reg.shrink(radius);
    window_max(P, T, X, reg, ew, radius);
    for_cells(reg, ew, [&](int i, int y, int x) {
      const bool supp = X[i] > 0.f;
      U[i] = supp;
      P[i] = inside(y, x) ? (supp ? 0.f : S[i]) : -INFINITY;
    });
    __syncthreads();
    reg = reg.shrink(radius);
    window_max(P, T, X, reg, ew, radius);
    for_cells(reg, ew, [&](int i, int y, int x) {
      M[i] = M[i] || (inside(y, x) && P[i] == X[i] && !U[i]);
    });
    __syncthreads();
  }

  // reg is now the core
  float* dst = out + size_t(blockIdx.z) * H * W;
  for_cells(reg, ew, [&](int i, int y, int x) {
    const int iy = ty0 + y, ix = tx0 + x;
    if (iy >= H || ix >= W) return;
    const bool keep = M[i] && iy >= border && iy < H - border && ix >= border &&
                      ix < W - border;
    dst[size_t(iy) * W + ix] = keep ? S[i] : 0.f;
  });
}

size_t smem_bytes(int halo, int core_w) {
  return size_t(CORE_H + 2 * halo) * (core_w + 2 * halo) * (4 * sizeof(float) + 2);
}

}  // namespace

extern "C" int ssp_nms_launch(const void* in, void* out, int B, int H, int W,
                              int radius, int iterations, int border,
                              void* stream) {
  const int halo = radius * (2 * iterations - 1);
  int core_w = 128;
  while (core_w > 32 && smem_bytes(halo, core_w) > SMEM_MAX) core_w /= 2;
  const size_t smem = smem_bytes(halo, core_w);
  if (smem > SMEM_MAX) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((W + core_w - 1) / core_w, (H + CORE_H - 1) / CORE_H, B);
  nms_kernel<<<grid, dim3(TX, TY), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), H, W, radius,
      iterations, border, halo, core_w);
  return int(cudaGetLastError());
}
