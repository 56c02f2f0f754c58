// Fused SuperPoint stem: 3x3 conv 1->64 -> folded BN -> ReLU -> 3x3 conv
// 64->64 -> folded BN -> ReLU (-> 2x2 max), fp32 [B, H, W, 1] in, bf16 NHWC
// out, SAME padding.
//
// Replaces the TPU kernels ssp/kernels/stem_pallas_v2.py::stem_pallas_packed
// (POOL) and ssp/kernels/stem_pallas.py::stem_pallas (no pool).
//
// Bound on an H100: tensor-core operations.  At 16x480x640 the second conv
// is 0.36 TFLOP of bf16 work (0.37 ms at 989 TFLOP/s) against 0.18 GB of
// HBM traffic (0.05 ms).  With only 64 output channels every 64x64x16
// product also reads 2 KB of weights from shared memory, and its
// activations come from there too: the loop lives on the tensor cores and
// the shared-memory port together, and whatever else a block does has to
// run beside it, not before it.
//
// Design:
//   * Persistent blocks, one per SM (the grid is the SM count), that walk
//     over 16x16-pixel output tiles of all images.  The second conv's
//     weights (72 KB) and the first conv's (8 KB) reach shared memory once
//     per block, as linear copies of images that the host has already laid
//     out and swizzled.
//   * Three warpgroups, each a pipeline of its own over every third tile of
//     the block, with its own input and intermediate buffers and no barrier
//     shared with the others.  They drift out of phase, so that one's loads,
//     first conv and epilogue run beside another's main loop; all their
//     products go through the one queue of the tensor cores in order.  (A
//     producer warpgroup for the first conv and two consumers for the second
//     were tried first: the producer's few products each waited behind the
//     consumers' deep batches in that queue, 8,700 clocks a tile against the
//     consumers' 4,500, and held the kernel at 0.77 ms; with mma.sync in the
//     producer it was 11,600 clocks and 1.05 ms.)
//   * Per tile a warpgroup stores the 20x20 input it had prefetched into
//     registers (bf16), starts the next tile's loads, and runs the first conv
//     on the tensor cores: K = 9 taps padded to 16, A gathered from the input
//     tile into registers, one wgmma m64n64k16 per 64 pixels, two
//     accumulators in turn, then scale, bias, ReLU and bf16 into an 18x18x64
//     intermediate tile in shared memory (0, not ReLU(bias), outside the
//     image: the second conv's SAME padding reads zeros there).
//   * The second conv is wgmma.mma_async m64n64k16 (bf16 -> fp32), 36
//     products per 64 pixels, B one tap's [64 out][64 in] slice read through
//     a matrix descriptor, A in registers, loaded with ldmatrix.x4 from the
//     intermediate tile.  A warp's 16 rows of a 64-pixel M tile are 8 columns
//     of two image rows: rows g and g + 8 of a thread are the two rows of a
//     pool window and the window's other column sits 4 lanes away, so the
//     2x2 max is one register max and one shuffle.  An ldmatrix register is
//     then one image row of 8 pixels by 8 channels, and a warp's two M tiles
//     sit one above the other: per horizontal tap and 16 channels it loads
//     six image rows once and composes from them the A operands of six
//     products (two M tiles x three vertical taps), half the loads of one
//     per product.  The next step's rows are loaded while this step's
//     products run.
//
// Shared-memory layouts:
//   * weights, 9 x 8192 B, each tap 1024-byte aligned: element (tap, out n,
//     in k) at byte  tap*8192 + n*128 + (((k >> 3) ^ (n & 7)) << 4) + (k & 7)*2,
//     the K-major 128-byte-swizzle layout of a wgmma descriptor (rows of 128
//     B, 8-row groups 1024 B apart, 16-byte chunks XORed with the row); the
//     first conv's weights are one more such slice, its k the tap (9 of 64
//     columns used, the rest 0), so both convs share one descriptor form;
//   * intermediate, 324 pixels x 144 B: 64 channels padded to 72, so the
//     eight 16-byte rows of an ldmatrix phase and the first conv's 4-byte
//     stores fall in distinct banks.
//
// Numerics follow the TPU kernels: input rounded to bf16, bf16 weights, fp32
// accumulation, fp32 scale then bias (a separate multiply and add, not an
// FMA), bf16 intermediate, bf16 output.  Any H and W (even for the pool),
// any B.
//
// Where the time goes at 16x480x640 (H100 80GB HBM3, 700 W; 0.685 ms, 54% of
// the tensor-core bound), from builds with one phase taken out: the main loop
// alone runs in 0.40 ms, 92% of the bound; taking out the first conv saves
// 0.19 ms, taking out the second conv's epilogue 0.10 ms.  The phases of the
// three warpgroups overlap far less than their instruction counts allow (one
// warpgroup alone takes 1.24 ms, two 0.79, three 0.68), and neither a deeper
// queue of first-conv products nor fewer epilogue instructions moved it.
//
// Not yet done: finding what keeps one warpgroup's first conv and epilogue
// from running under another's main loop (a fourth warpgroup does not fit the
// shared memory); the epilogue stores 4 bytes per thread (a transposing
// shuffle would make them 16); the input tile arrives by plain loads, not by
// TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int C = 64;                  // channels of the intermediate and the output
constexpr int TH = 16, TW = 16;        // output tile (before pooling)
constexpr int MH = TH + 2, MW = TW + 2;  // intermediate tile, 1-px halo
constexpr int XH = TH + 4, XW = TW + 4;  // input tile, 2-px halo
constexpr int LD = C + 8;              // intermediate row stride in bf16
constexpr int MID_PIX = MH * MW;       // 324
constexpr int MID_MTILES64 = 6;        // first-conv M tiles of 64 pixels
constexpr int XS_ELEMS = XH * XW;      // 400
constexpr int WGS = 3;                 // warpgroups, each with its own buffers
constexpr int WG = 128;
constexpr int NTHREADS = WG * WGS;
constexpr int FETCH = (XS_ELEMS + WG - 1) / WG;  // input values per thread

constexpr int W2_TAP_BYTES = C * C * 2;
constexpr int W2_BYTES = 9 * W2_TAP_BYTES;
constexpr int W1_BYTES = W2_TAP_BYTES;  // the first conv's [64 out][9 taps of 64] image
constexpr int MID_BYTES = MID_PIX * LD * 2;
constexpr int XS_BYTES = XS_ELEMS * 2;  // one input tile, bf16
constexpr int AFF_BYTES = 4 * C * 4;    // scale1, bias1, scale2, bias2
// 1024 spare bytes: the weights start at the next multiple of 1024
constexpr int SMEM_BYTES =
    1024 + W2_BYTES + W1_BYTES + WGS * (MID_BYTES + XS_BYTES) + AFF_BYTES;

static_assert(MID_MTILES64 * 64 >= MID_PIX, "the M tiles cover the intermediate tile");
static_assert(TH == 16 && TW == 16, "a pass is 8 rows of 16 pixels: two M tiles");
static_assert(MID_BYTES % 16 == 0 && XS_BYTES % 16 == 0 && W2_TAP_BYTES % 1024 == 0,
              "alignment of the buffers");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block on sm_90");

constexpr int BAR_WG = 1;  // + warpgroup: its own named barrier (0 is __syncthreads)
constexpr int BAR_START = BAR_WG + WGS;  // + warpgroup: the next one may start

struct Tile {
  int img, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y) {
  const int per_img = tiles_x * tiles_y;
  const int img = t / per_img, rem = t - img * per_img;
  const int ty = rem / tiles_x;
  return {img, ty * TH, (rem - ty * tiles_x) * TW};
}

// One warpgroup's pipeline over the tiles first + (wg + WGS*i) * stride.
template <bool POOL>
__device__ __forceinline__ void pipeline(const float* __restrict__ x, const float* aff,
                                         uint32_t w1_addr, uint32_t w2_addr,
                                         __nv_bfloat16* mid, unsigned short* xs,
                                         __nv_bfloat16* __restrict__ out, int H, int W,
                                         int tiles_x, int tiles_y, int first, int stride,
                                         int n_mine, int wg) {
  const int wtid = threadIdx.x - wg * WG;
  const int cw = wtid >> 5, lane = wtid & 31, g = lane >> 2, t4 = lane & 3;
  const uint64_t desc1 = weight_desc(w1_addr), desc2 = weight_desc(w2_addr);
  const uint32_t mid_addr = smem_u32(mid);
  // (s, s', b, b') of the channels 8*nt + 2*t4, + 1 at [nt * 4 + t4], per conv
  const float4* aff1 = reinterpret_cast<const float4*>(aff);
  const float4* aff2 = reinterpret_cast<const float4*>(aff + 2 * C);

  // first conv: this lane's A columns are the taps k = 2*t4, 2*t4 + 1 (and 8 for
  // t4 == 0; 9-15 are zero), as offsets in the input tile
  const int o0 = ((2 * t4) / 3) * XW + (2 * t4) % 3;
  const int o1 = ((2 * t4 + 1) / 3) * XW + (2 * t4 + 1) % 3;
  const int o8 = 2 * XW + 2;

  // second conv: a pass is 8 image rows of the tile, two M tiles.  This warp's
  // 16 rows of M tile j are columns wx + 0..7 of image rows wy + 2*j (rows 0-7)
  // and wy + 2*j + 1 (rows 8-15), so its two M tiles and their three vertical
  // taps read six consecutive image rows wy .. wy + 5 of the intermediate tile.
  const int wy = 4 * (cw >> 1), wx = 8 * (cw & 1);
  // ldmatrix.x4: lanes 8i..8i+7 give the row addresses of matrix i; matrices
  // 0/1 are two consecutive image rows at channels 0-7 of the k step, 2/3 at 8-15
  const int mat = lane >> 3, r = lane & 7;
  const uint32_t a_lane =
      mid_addr + uint32_t((((wy + (mat & 1)) * MW + wx + r) * LD + (mat >> 1) * 8) * 2);

  float v[FETCH];
  auto fetch = [&](int t) {
    const Tile tl = tile_at(t, tiles_x, tiles_y);
    const float* xi = x + size_t(tl.img) * H * W;
#pragma unroll
    for (int j = 0; j < FETCH; ++j) {
      const int i = wtid + j * WG;
      const int y = tl.y0 - 2 + i / XW, xx = tl.x0 - 2 + i % XW;
      v[j] = (i < XS_ELEMS && y >= 0 && y < H && xx >= 0 && xx < W)
                 ? __ldg(xi + size_t(y) * W + xx) : 0.f;
    }
  };
  if (wg < n_mine) fetch(first + wg * stride);
  for (int it = wg; it < n_mine; it += WGS) {
    const Tile tl = tile_at(first + it * stride, tiles_x, tiles_y);
    // ---- 1. the prefetched input tile, rounded to bf16 ---------------------
#pragma unroll
    for (int j = 0; j < FETCH; ++j) {
      const int i = wtid + j * WG;
      if (i < XS_ELEMS) xs[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v[j]));
    }
    // the input is stored, and every warp is done with the last tile's buffers
    bar_sync(BAR_WG + wg, WG);
    if (it + WGS < n_mine) fetch(first + (it + WGS) * stride);

    // ---- 2. first conv -> intermediate tile ----------------------------------
    // M tiles of 64 intermediate pixels (this warp holds rows 16*cw + g, + 8),
    // three accumulators in turn: tiles T + 1 and T + 2 are in the tensor
    // cores' queue while tile T goes through the epilogue
    float acc[3][32];
    auto enqueue = [&](int T) {
      const int m0 = T * 64 + cw * 16 + g, m1 = m0 + 8;
      // rows past the tile compute from pixel 0 and are dropped
      const int pa = m0 < MID_PIX ? (m0 / MW) * XW + m0 % MW : 0;
      const int pb = m1 < MID_PIX ? (m1 / MW) * XW + m1 % MW : 0;
      uint32_t a[4];
      a[0] = uint32_t(xs[pa + o0]) | (uint32_t(xs[pa + o1]) << 16);
      a[1] = uint32_t(xs[pb + o0]) | (uint32_t(xs[pb + o1]) << 16);
      a[2] = t4 == 0 ? uint32_t(xs[pa + o8]) : 0u;
      a[3] = t4 == 0 ? uint32_t(xs[pb + o8]) : 0u;
      wgmma_fence();
      wgmma_m64n64k16<false>(acc[T % 3], a, desc1);
      wgmma_commit();
    };
    enqueue(0);
    enqueue(1);
#pragma unroll
    for (int T = 0; T < MID_MTILES64; ++T) {
      if (T + 2 < MID_MTILES64) {
        enqueue(T + 2);
        wgmma_wait<2>();
      } else if (T + 1 < MID_MTILES64) {
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) fence_operand(acc[T % 3][e]);
      if (T * 64 + cw * 16 >= MID_PIX) continue;  // all of this warp's rows are past the tile
      bool keep[2], inside[2];
      __nv_bfloat16* row[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = T * 64 + cw * 16 + g + 8 * h;
        const int y = tl.y0 - 1 + m / MW, xx = tl.x0 - 1 + m % MW;
        keep[h] = m < MID_PIX;
        inside[h] = y >= 0 && y < H && xx >= 0 && xx < W;
        row[h] = mid + m * LD + 2 * t4;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 sb = aff1[nt * 4 + t4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float r0 = affine_relu(acc[T % 3][4 * nt + 2 * h], sb.x, sb.z);
          const float r1 = affine_relu(acc[T % 3][4 * nt + 2 * h + 1], sb.y, sb.w);
          if (keep[h])
            *reinterpret_cast<__nv_bfloat162*>(row[h] + nt * 8) =
                inside[h] ? __floats2bfloat162_rn(r0, r1) : __floats2bfloat162_rn(0.f, 0.f);
        }
      }
    }
    bar_sync(BAR_WG + wg, WG);  // the intermediate tile is complete
    // Warpgroups that start together stay in step, all in the first conv, then
    // all sharing the tensor cores in the main loop.  So each goes into its
    // first main loop when the one before it has left its own (16x480x640:
    // 0.70 ms without this, 0.68 ms with it).
    if (it == wg && wg > 0) bar_sync(BAR_START + wg - 1, 2 * WG);

    // ---- 3. second conv and epilogue, 8 image rows at a time -----------------
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      if (tl.y0 + 8 * pass >= H) break;  // the same for the whole warpgroup
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[0][e] = acc[1][e] = 0.f;
      const uint32_t a_pass = a_lane + uint32_t(8 * pass * MW * LD * 2);
      // One step is a horizontal tap dx and 16 of the 64 input channels: the
      // six image rows are loaded once (rows[i] holds rows 2i and 2i + 1, low
      // and high half of the channels) and feed six products, the two M
      // tiles times the three vertical taps.
      uint32_t rows[2][3][4];
      auto load_rows = [&](uint32_t (&rr)[3][4], int step) {
        const uint32_t at = a_pass + uint32_t(((step / 4) * LD + (step % 4) * 16) * 2);
#pragma unroll
        for (int i = 0; i < 3; ++i) ldmatrix_x4(rr[i], at + uint32_t(i * 2 * MW * LD * 2));
      };
      load_rows(rows[0], 0);
#pragma unroll
      for (int s = 0; s < 12; ++s) {
        const int dx = s / 4, kc = s % 4;
        const uint32_t(&rr)[3][4] = rows[s & 1];
        wgmma_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const uint64_t desc = desc2 + uint64_t(((dy * 3 + dx) * W2_TAP_BYTES + kc * 32) >> 4);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (dy == 1) {  // image rows 2j + 1 and 2j + 2
              const uint32_t a[4] = {rr[j][1], rr[j + 1][0], rr[j][3], rr[j + 1][2]};
              wgmma_m64n64k16(acc[j], a, desc);
            } else {        // image rows 2j + dy and 2j + dy + 1: one loaded pair
              wgmma_m64n64k16(acc[j], rr[j + dy / 2], desc);
            }
          }
        }
        wgmma_commit();
        if (s + 1 < 12) {
          // the products of step s - 1 have read the registers loaded next
          wgmma_wait<1>();
          load_rows(rows[(s + 1) & 1], s + 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) fence_operand(acc[j][e]);

#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int y = tl.y0 + 8 * pass + wy + 2 * j;  // rows g; rows g + 8 are y + 1
        const int xx = tl.x0 + wx + g;
        float e[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float4 sb = aff2[nt * 4 + t4];
          e[nt][0] = affine_relu(acc[j][4 * nt + 0], sb.x, sb.z);
          e[nt][1] = affine_relu(acc[j][4 * nt + 1], sb.y, sb.w);
          e[nt][2] = affine_relu(acc[j][4 * nt + 2], sb.x, sb.z);
          e[nt][3] = affine_relu(acc[j][4 * nt + 3], sb.y, sb.w);
        }
        if constexpr (POOL) {
          // rounding is monotonic, so the max over the window's two columns may
          // be taken after it, on the packed pair: one shuffle, not two
          __nv_bfloat162 p[8];
          uint32_t other[8];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            p[nt] = __floats2bfloat162_rn(fmaxf(e[nt][0], e[nt][2]), fmaxf(e[nt][1], e[nt][3]));
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)  // column xx ^ 1
            other[nt] = __shfl_xor_sync(0xffffffffu, *reinterpret_cast<uint32_t*>(&p[nt]), 4);
          // H and W are even, so a window is inside the image or outside it
          if ((g & 1) == 0 && y < H && xx < W) {
            __nv_bfloat16* o =
                out + ((size_t(tl.img) * (H / 2) + y / 2) * (W / 2) + xx / 2) * C + 2 * t4;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
              *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) =
                  __hmax2(p[nt], *reinterpret_cast<__nv_bfloat162*>(&other[nt]));
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (y + h >= H || xx >= W) continue;
            __nv_bfloat16* o = out + ((size_t(tl.img) * H + y + h) * W + xx) * C + 2 * t4;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
              *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) =
                  __floats2bfloat162_rn(e[nt][2 * h], e[nt][2 * h + 1]);
          }
        }
      }
    }
    if (it == wg && wg + 1 < WGS && wg + 1 < n_mine) bar_arrive(BAR_START + wg, 2 * WG);
  }
}

template <bool POOL>
__global__ void __launch_bounds__(NTHREADS, 1)
stem_kernel(const float* __restrict__ x, const uint4* __restrict__ w1_image,
            const float* __restrict__ s1, const float* __restrict__ b1,
            const uint4* __restrict__ w2_image, const float* __restrict__ s2,
            const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int H, int W,
            int tiles_x, int tiles_y, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* w1s = smem + W2_BYTES;
  unsigned char* mid_base = w1s + W1_BYTES;
  unsigned char* xs_base = mid_base + WGS * MID_BYTES;
  float* aff = reinterpret_cast<float*>(xs_base + WGS * XS_BYTES);

  // once per block: the two swizzled weight images as they are, and the four
  // vectors as (s, s', b, b') per channel pair, one 16-byte load in an epilogue
  for (int i = threadIdx.x; i < W2_BYTES / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(smem)[i] = __ldg(w2_image + i);
  for (int i = threadIdx.x; i < W1_BYTES / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(w1s)[i] = __ldg(w1_image + i);
  if (threadIdx.x < C) {
    const int pair = threadIdx.x >> 1, odd = threadIdx.x & 1;
    aff[4 * pair + odd] = s1[threadIdx.x];
    aff[4 * pair + 2 + odd] = b1[threadIdx.x];
    aff[2 * C + 4 * pair + odd] = s2[threadIdx.x];
    aff[2 * C + 4 * pair + 2 + odd] = b2[threadIdx.x];
  }
  // wgmma reads the weights through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int first = blockIdx.x, stride = gridDim.x;
  const int n_mine = (n_tiles - first + stride - 1) / stride;
  // the warpgroup index through a shuffle, so that the compiler knows it to be
  // the same for a whole warp: it serialises wgmma on a path it takes for divergent
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / WG, 0);
  pipeline<POOL>(x, aff, smem_u32(w1s), smem_u32(smem),
                 reinterpret_cast<__nv_bfloat16*>(mid_base + wg * MID_BYTES),
                 reinterpret_cast<unsigned short*>(xs_base + wg * XS_BYTES), out, H, W, tiles_x,
                 tiles_y, first, stride, n_mine, wg);
}

template <bool POOL>
int launch(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
           const void* s2, const void* b2, void* out, int B, int H, int W, void* stream) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  if (B <= 0 || H <= 0 || W <= 0 || size_t(B) * tiles_x * tiles_y > size_t(0x7fffffff))
    return int(cudaErrorInvalidValue);
  const int n_tiles = B * tiles_x * tiles_y;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  auto kernel = stem_kernel<POOL>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  kernel<<<n_tiles < sms ? n_tiles : sms, NTHREADS, SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint4*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const uint4*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), H, W, tiles_x, tiles_y,
      n_tiles);
  return int(cudaGetLastError());
}

}  // namespace

// x [B,H,W] fp32; w1 and w2 the 8,192- and 73,728-byte swizzled images described
// above (ssp_torch.kernels.stem.swizzle_w1, swizzle_w2); scales and biases fp32
// [64]; out [B,H/2,W/2,64] (pool) or [B,H,W,64] bf16.
extern "C" int ssp_stem_launch(const void* x, const void* w1, const void* s1,
                               const void* b1, const void* w2, const void* s2,
                               const void* b2, void* out, int B, int H, int W,
                               int pool, void* stream) {
  return pool ? launch<true>(x, w1, s1, b1, w2, s2, b2, out, B, H, W, stream)
              : launch<false>(x, w1, s1, b1, w2, s2, b2, out, B, H, W, stream);
}
