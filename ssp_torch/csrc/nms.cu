// Iterated local-max suppression (SuperPoint NMS) with optional border
// zeroing, [B,H,W] fp32 -> [B,H,W] fp32.
//
// Replaces the TPU kernel ssp/kernels/nms_pallas.py::nms_pallas; computes
// exactly ssp/postprocess/nms.py::simple_nms followed by zero_border, ties
// included, on any finite input.
//
// Bound on an H100: memory.  The function reads the heatmap once and
// writes it once (2 x 19.7 MB at 16x480x640, ~12 us at 3.35 TB/s); its
// arithmetic is max and compare.  So the whole chain of 2 * iterations - 1
// window maxes runs on a shared-memory tile whose halo is the chain's
// receptive field, and what limits the kernel is shared-memory traffic and
// the halo work.  The design:
//
//   * persistent blocks (one per SM) walk the (image, tile row, tile
//     column) tiles; the next tile's scores are requested with cp.async
//     (16 bytes a copy when W % 4 == 0, else 4) while the current tile's
//     chain runs; cells outside the image are stored as -inf, the
//     reduce_window padding of the reference;
//   * the max mask M and the suppressed mask U are bit words, bit i of word
//     w the tile column 32w + i; dilating a mask by r is a column OR of
//     2r + 1 words and a row OR of funnel shifts by -r..r;
//   * no plane holds a window max or the suppressed scores: the row pass
//     of a window max reads the scores and, in later rounds, zeroes the
//     cells of U on the fly; the column pass compares its max with the
//     centre at once and keeps one bit per cell (__ballot_sync builds the
//     word);
//   * a thread keeps a run of 8 outputs in registers: the row pass loads
//     its 8 + 2r inputs as float4, the column pass walks 8 rows of one
//     column, and both take the 9-tap max as the max of a suffix and a
//     prefix (van Herk / Gil-Werman: 22 max operations for 8 outputs at
//     r = 4).  A warp's row-pass lanes are 8 rows x 4 runs and the row
//     pitch is an odd number of 16-byte units, so each quarter warp's
//     float4 accesses fall into 8 distinct bank groups; the column pass
//     reads 32 neighbouring cells of a row;
//   * window max k of the chain is needed only k * radius rows inside the
//     tile, so each stage runs on a band that shrinks by radius per stage
//     (columns are computed over the whole tile width; what lies outside
//     the valid band never reaches the core).
//
// Shared memory, for a core of core_h x core_w cells, halo h = radius *
// (2 * iterations - 1) rows and h rounded up to 4 columns (hw): tile
// th x tw = (core_h + 2h) x (core_w + 2hw), pitch tw + 4 floats,
// words = ceil(tw / 32):
//
//   S0, S1  scores of the current and the next tile   2 x th x pitch fp32
//   T       row-pass scratch                          th x pitch fp32
//   M, U    max mask, suppressed mask                 2 x th x words u32
//
// each plane with 32 floats of slack before and after, for the reads of
// the edge runs.  At radius 4 and 3 iterations the core is 64 x 128 and
// the tile 104 x 168 (2.13x the core): 220,416 bytes of the 232,448 a
// block may use.  The core is chosen in ssp_torch/kernels/nms.py
// (`geometry`) and checked here against this layout.
//
// max and == are exact, so the result is bit-identical to the reference.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 512, NWARPS = NTHREADS / 32;
constexpr int RUN = 8;       // outputs a thread keeps in registers
constexpr int SLACK = 32;    // floats before and after each plane
constexpr int SMEM_MAX = 232448;
constexpr int RADIUS_MAX = 8;

struct Geom {
  int H, W, iterations, border, vec;
  int core_h, core_w, halo, halo_w;
  int th, tw, pitch, words, plane;  // plane: th * pitch + 2 * SLACK floats
  int tiles_x, tiles_y, tiles;
};

struct Tile {
  int img, y0, x0;  // image row and column of tile cell (0, 0)
};

__device__ __forceinline__ Tile tile_at(int t, const Geom& g) {
  const int per_img = g.tiles_x * g.tiles_y;
  const int img = t / per_img, rem = t - img * per_img;
  const int ty = rem / g.tiles_x;
  return {img, ty * g.core_h - g.halo, (rem - ty * g.tiles_x) * g.core_w - g.halo_w};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// bits [lo, hi) of a word, both clamped to [0, 32]
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  lo = min(max(lo, 0), 32);
  hi = min(max(hi, 0), 32);
  return hi > lo ? uint32_t((1ull << hi) - (1ull << lo)) : 0u;
}

// the bits of word w of tile row y that lie inside the image
__device__ __forceinline__ uint32_t inside_bits(int y, int w, const Tile& t, const Geom& g) {
  const int iy = t.y0 + y;
  if (iy < 0 || iy >= g.H) return 0u;
  return bit_range(-t.x0 - 32 * w, g.W - t.x0 - 32 * w);
}

// o[i] = max(v[OFF + i .. OFF + i + 2R]), i < N
template <int R, int N, int OFF, int NV>
__device__ __forceinline__ void window_max(const float (&v)[NV], float (&o)[N]) {
  static_assert(OFF + N + 2 * R <= NV, "window inputs");
  if constexpr (R == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = v[OFF + i];
  } else if constexpr (N <= 2 * R) {
    // every window holds inputs N - 1 and N: the max of a suffix of the
    // first N inputs and of a prefix of the rest
    float suf[N], pre[2 * R];
    suf[N - 1] = v[OFF + N - 1];
#pragma unroll
    for (int i = N - 2; i >= 0; --i) suf[i] = fmaxf(v[OFF + i], suf[i + 1]);
    pre[0] = v[OFF + N];
#pragma unroll
    for (int j = 1; j < 2 * R; ++j) pre[j] = fmaxf(pre[j - 1], v[OFF + N + j]);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = fmaxf(suf[i], pre[i + 2 * R - N]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float m = v[OFF + i];
#pragma unroll
      for (int d = 1; d <= 2 * R; ++d) m = fmaxf(m, v[OFF + i + d]);
      o[i] = m;
    }
  }
}

// The next tile's scores into S, as cp.async copies; -inf outside the image.
__device__ void load_tile(float* S, const float* in, const Tile& t, const Geom& g) {
  const float* src = in + size_t(t.img) * g.H * g.W;
  if (g.vec) {  // W % 4 == 0 and t.x0 % 4 == 0: a copy lies wholly inside or outside
    const int q = g.tw / 4, n = g.th * q;
    for (int i = threadIdx.x; i < n; i += NTHREADS) {
      const int y = i / q, x = (i - y * q) * 4;
      const int iy = t.y0 + y, ix = t.x0 + x;
      float* dst = S + y * g.pitch + x;
      if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
        cp_async16(dst, src + size_t(iy) * g.W + ix);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
  } else {
    const int n = g.th * g.tw;
    for (int i = threadIdx.x; i < n; i += NTHREADS) {
      const int y = i / g.tw, x = i - y * g.tw;
      const int iy = t.y0 + y, ix = t.x0 + x;
      float* dst = S + y * g.pitch + x;
      if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
        cp_async4(dst, src + size_t(iy) * g.W + ix);
      else
        *dst = -INFINITY;
    }
  }
}

// T = the row max over columns x - R .. x + R, on rows [y0, y1) and every
// column, of S or (SUPP) of S with the cells of U set to 0.
template <int R, bool SUPP>
__device__ void row_pass(const float* S, const uint32_t* U, float* T, int y0, int y1,
                         const Geom& g) {
  constexpr int R4 = (R + 3) / 4 * 4, NV = RUN + 2 * R4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int runs = g.tw / RUN, col_groups = (runs + 3) / 4;
  const int groups = (y1 - y0 + 7) / 8 * col_groups;
  for (int gi = warp; gi < groups; gi += NWARPS) {
    const int y = y0 + gi / col_groups * 8 + (lane & 7);
    const int run = gi % col_groups * 4 + (lane >> 3);
    if (y >= y1 || run >= runs) continue;
    const int x0 = run * RUN;
    const float* src = S + y * g.pitch + x0 - R4;
    float v[NV];
#pragma unroll
    for (int j = 0; j < NV; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(src + j);
      v[j] = f.x, v[j + 1] = f.y, v[j + 2] = f.z, v[j + 3] = f.w;
    }
    if constexpr (SUPP) {
      const int base = x0 - R4 + 32;  // > 0; word (base >> 5) - 1 holds column x0 - R4
      const int w = base >> 5;
      const uint32_t lo = w >= 1 ? U[y * g.words + w - 1] : 0u;
      const uint32_t hi = w < g.words ? U[y * g.words + w] : 0u;
      const uint64_t bits = ((uint64_t(hi) << 32) | lo) >> (base & 31);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if ((bits >> j) & 1) v[j] = 0.f;
    }
    float o[RUN];
    window_max<R, RUN, R4 - R>(v, o);
    float4* dst = reinterpret_cast<float4*>(T + y * g.pitch + x0);
    dst[0] = make_float4(o[0], o[1], o[2], o[3]);
    dst[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
}

// On rows [y0, y1) (y1 - y0 >= RUN): whether the centre (S, or with SUPP S
// with the cells of U set to 0) equals the column max of T over rows
// y - R .. y + R, inside the image.  M = those bits, or (SUPP)
// M |= those bits & ~U.
template <int R, bool SUPP>
__device__ void col_pass(const float* S, const float* T, const uint32_t* U, uint32_t* M,
                         int y0, int y1, const Tile& t, const Geom& g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int items = (y1 - y0 + RUN - 1) / RUN * g.words;
  for (int it = warp; it < items; it += NWARPS) {
    const int w = it % g.words;
    // the last run ends at y1 (it may overlap the one before: same bits)
    const int ya = min(y0 + it / g.words * RUN, y1 - RUN);
    const int x = w * 32 + lane;
    float v[RUN + 2 * R];
#pragma unroll
    for (int j = 0; j < RUN + 2 * R; ++j) v[j] = T[(ya - R + j) * g.pitch + x];
    float o[RUN];
    window_max<R, RUN, 0>(v, o);
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      const int y = ya + i;
      float c = S[y * g.pitch + x];
      uint32_t u = 0;
      if constexpr (SUPP) {
        u = U[y * g.words + w];
        if ((u >> lane) & 1) c = 0.f;
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, c == o[i]) & inside_bits(y, w, t, g);
      if (lane == i) {
        if constexpr (SUPP)
          M[y * g.words + w] |= bits & ~u;
        else
          M[y * g.words + w] = bits;
      }
    }
  }
}

// U = M dilated over the (2R+1)^2 window, on rows [y0, y1), inside the image
template <int R>
__device__ void dilate(const uint32_t* M, uint32_t* U, int y0, int y1, const Tile& t,
                       const Geom& g) {
  const int n = (y1 - y0) * g.words;
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    const int y = y0 + i / g.words, w = i % g.words;
    uint32_t a = 0, b = 0, c = 0;  // column ORs of words w - 1, w, w + 1
#pragma unroll
    for (int d = -R; d <= R; ++d) {
      const uint32_t* row = M + (y + d) * g.words;
      b |= row[w];
      if (w > 0) a |= row[w - 1];
      if (w + 1 < g.words) c |= row[w + 1];
    }
    uint32_t u = b;
#pragma unroll
    for (int d = 1; d <= R; ++d) u |= __funnelshift_r(b, c, d) | __funnelshift_l(a, b, d);
    U[y * g.words + w] = u & inside_bits(y, w, t, g);
  }
}

// the core: S where M is set and outside the border band, else 0
__device__ void store_core(const float* S, const uint32_t* M, float* out, const Tile& t,
                           const Geom& g) {
  float* dst = out + size_t(t.img) * g.H * g.W;
  const int step = g.vec ? 4 : 1, q = g.core_w / step, n = g.core_h * q;
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    const int y = g.halo + i / q, x = g.halo_w + (i % q) * step;
    const int iy = t.y0 + y, ix = t.x0 + x;
    if (iy >= g.H || ix >= g.W) continue;
    const bool row_ok = iy >= g.border && iy < g.H - g.border;
    const uint32_t m = M[y * g.words + (x >> 5)] >> (x & 31);
    auto keep = [&](int k, float s) {
      const bool k_ok = row_ok && ((m >> k) & 1) && ix + k >= g.border && ix + k < g.W - g.border;
      return k_ok ? s : 0.f;
    };
    if (g.vec) {
      const float4 s = *reinterpret_cast<const float4*>(S + y * g.pitch + x);
      *reinterpret_cast<float4*>(dst + size_t(iy) * g.W + ix) =
          make_float4(keep(0, s.x), keep(1, s.y), keep(2, s.z), keep(3, s.w));
    } else {
      dst[size_t(iy) * g.W + ix] = keep(0, S[y * g.pitch + x]);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(NTHREADS, 1)
nms_kernel(const float* __restrict__ in, float* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) float sm[];
  float* T = sm + 2 * g.plane + SLACK;
  uint32_t* M = reinterpret_cast<uint32_t*>(sm + 3 * g.plane);
  uint32_t* U = M + g.th * g.words;

  int t = blockIdx.x;
  if (t < g.tiles) load_tile(sm + SLACK, in, tile_at(t, g), g);
  cp_async_commit();
  for (int b = 0; t < g.tiles; t += gridDim.x, b ^= 1) {
    const float* S = sm + b * g.plane + SLACK;
    const int next = t + gridDim.x;
    if (next < g.tiles) load_tile(sm + (b ^ 1) * g.plane + SLACK, in, tile_at(next, g), g);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const Tile tile = tile_at(t, g);
    row_pass<R, false>(S, U, T, 0, g.th, g);
    __syncthreads();
    col_pass<R, false>(S, T, U, M, R, g.th - R, tile, g);
    __syncthreads();
    int lo = R;  // M is valid on rows [lo, th - lo)
    for (int i = 1; i < g.iterations; ++i) {
      dilate<R>(M, U, lo + R, g.th - lo - R, tile, g);
      __syncthreads();
      row_pass<R, true>(S, U, T, lo + R, g.th - lo - R, g);
      __syncthreads();
      col_pass<R, true>(S, T, U, M, lo + 2 * R, g.th - lo - 2 * R, tile, g);
      __syncthreads();
      lo += 2 * R;
    }
    store_core(S, M, out, tile, g);
    __syncthreads();  // S and M are free for the next tile
  }
}

template <int R>
cudaError_t launch(const float* in, float* out, const Geom& g, int smem, int sms,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(nms_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  nms_kernel<R><<<min(g.tiles, sms), NTHREADS, smem, stream>>>(in, out, g);
  return cudaGetLastError();
}

}  // namespace

// in, out [B,H,W] fp32.  core_h x core_w, pitch and smem_bytes come from
// ssp_torch.kernels.nms.geometry; the launch is refused (cudaErrorInvalidValue)
// if they do not describe the layout above.  vec: W % 4 == 0 and `in` 16-byte
// aligned.  One launch on `stream`.
extern "C" int ssp_nms_launch(const void* in, void* out, int B, int H, int W, int radius,
                              int iterations, int border, int core_h, int core_w, int pitch,
                              int smem_bytes, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || radius < 0 || radius > RADIUS_MAX || iterations < 1 ||
      border < 0 || core_h < RUN || core_w < 32 || core_w % 32 != 0)
    return int(cudaErrorInvalidValue);
  Geom g;
  g.H = H, g.W = W, g.iterations = iterations, g.border = border, g.vec = vec != 0;
  g.core_h = core_h, g.core_w = core_w;
  g.halo = radius * (2 * iterations - 1);
  g.halo_w = (g.halo + 3) / 4 * 4;
  g.th = core_h + 2 * g.halo, g.tw = core_w + 2 * g.halo_w;
  g.pitch = pitch, g.words = (g.tw + 31) / 32;
  g.plane = g.th * pitch + 2 * SLACK;
  const long long smem = 4LL * (3LL * g.plane + 2LL * g.th * g.words);
  g.tiles_x = (W + core_w - 1) / core_w, g.tiles_y = (H + core_h - 1) / core_h;
  const long long tiles = (long long)B * g.tiles_x * g.tiles_y;
  if (pitch < g.tw || pitch % 4 != 0 || smem != smem_bytes || smem > SMEM_MAX ||
      tiles > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  g.tiles = int(tiles);

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const float* x = static_cast<const float*>(in);
  float* y = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 0: return int(launch<0>(x, y, g, smem_bytes, sms, st));
    case 1: return int(launch<1>(x, y, g, smem_bytes, sms, st));
    case 2: return int(launch<2>(x, y, g, smem_bytes, sms, st));
    case 3: return int(launch<3>(x, y, g, smem_bytes, sms, st));
    case 4: return int(launch<4>(x, y, g, smem_bytes, sms, st));
    case 5: return int(launch<5>(x, y, g, smem_bytes, sms, st));
    case 6: return int(launch<6>(x, y, g, smem_bytes, sms, st));
    case 7: return int(launch<7>(x, y, g, smem_bytes, sms, st));
    default: return int(launch<8>(x, y, g, smem_bytes, sms, st));
  }
}
