// SuperPoint's down1: 3x3 conv 64->64 -> folded BN -> ReLU -> 3x3 conv 64->64
// -> folded BN -> ReLU (-> 2x2 max), bf16 NHWC in and out, SAME padding, as
// two launches of one kernel: "3x3 conv 64->64 -> scale*x + bias -> ReLU
// (-> 2x2 max)".
//
// Replaces the TPU kernel ssp/kernels/down1_pallas.py::down1_pallas_packed.
//
// Bound on an H100: tensor-core operations.  At 16x240x320 the two convs are
// 0.18 TFLOP of bf16 work (0.18 ms at 989 TFLOP/s); the function moves 0.2 GB
// (0.06 ms at 3.35 TB/s).  The bf16 intermediate makes a round trip through
// device memory between the launches, 2 x 157 MB at that size (0.09 ms),
// which each launch's loads hide under its products.
//
// Why two launches: a fused kernel would hold both convs' weight images
// (2 x 72 KB) and, per warpgroup, an input tile with a 2-px halo (57 KB) and
// the intermediate tile (46 KB), more than a block's shared memory even for
// one warpgroup; and the stem showed that the overlap of several
// warpgroups, each with a tile of its own, is most of what a conv of 64
// channels gains (stem.cu).  One conv's weights leave room for three.
//
// Design (the stem's second conv, stem.cu, with a load in place of its
// first conv):
//   * Persistent blocks, one per SM, that walk over 16x16-pixel output tiles
//     of all images.  The conv's weights, a 73,728-byte image that the host
//     has laid out and swizzled (ssp_torch.kernels.stem.swizzle_w2), reach
//     shared memory once per block, as a linear copy.
//   * Three warpgroups, each a pipeline of its own over every third tile of
//     the block with its own 18x18x64 input tile (the 1-px halo, zeros
//     outside the image: the SAME padding of both convs, so launch 2 reads
//     0 there, not ReLU(bias)).  They share no barrier and drift out of
//     phase, so that one's epilogue runs beside another's products.
//   * The input tile arrives by cp.async, 16 bytes a copy, zero-filled
//     outside the image.  A tile is read in two passes of 8 output rows:
//     pass 0 reads tile rows 0-9, pass 1 rows 8-17.  So the next tile's rows
//     0-7 are requested as soon as pass 0's products have read theirs, and
//     rows 8-17 when pass 1's have, each before that pass's epilogue, which
//     works from registers.
//   * The conv is wgmma.mma_async m64n64k16 (bf16 -> fp32), 36 products per
//     64 pixels, B one tap's [64 out][64 in] slice through a matrix
//     descriptor, A in registers from ldmatrix.x4: per horizontal tap and
//     16 channels a warp loads six image rows once and composes from them
//     the A operands of six products (two M tiles x three vertical taps).
//     A warp's 16 rows of an M tile are 8 columns of two image rows, so the
//     2x2 max is one register max and one shuffle.
//
// Shared-memory layouts: the weights as in stem.cu (element (tap, out n,
// in k) at byte tap*8192 + n*128 + (((k >> 3) ^ (n & 7)) << 4) + (k & 7)*2);
// an input tile is 324 pixels x 144 B, 64 channels padded to 72, so the eight
// 16-byte rows of an ldmatrix phase fall in distinct banks.
//
// Time at 16x240x320 (NVIDIA H100 80GB HBM3, 700.00 W): 0.3366 ms for both
// launches, 54% of the tensor-core bound (ssp_torch/bench_kernels.py; the
// fused mma.sync kernel it replaces took 0.8155 ms).
//
// Numerics follow the TPU kernel: bf16 input and weights, fp32 accumulation,
// fp32 scale then bias (a separate multiply and add, not an FMA), ReLU, the
// intermediate rounded to bf16 (the TPU kernel rounds the second conv's
// input there, down1_pallas.py:78), bf16 output.  Any H and W (even for the
// pool), any B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int C = 64;                  // channels in and out
constexpr int TH = 16, TW = 16;        // output tile (before pooling)
constexpr int XH = TH + 2, XW = TW + 2;  // input tile, 1-px halo
constexpr int LD = C + 8;              // input tile row stride in bf16
constexpr int XS_PIX = XH * XW;        // 324
constexpr int WGS = 3;                 // warpgroups, each with its own input tile
constexpr int WG = 128;
constexpr int NTHREADS = WG * WGS;

constexpr int W_TAP_BYTES = C * C * 2;
constexpr int W_BYTES = 9 * W_TAP_BYTES;
constexpr int XS_BYTES = XS_PIX * LD * 2;  // 46,656
constexpr int AFF_BYTES = 2 * C * 4;       // scale, bias
// 1024 spare bytes: the weights start at the next multiple of 1024
constexpr int SMEM_BYTES = 1024 + W_BYTES + WGS * XS_BYTES + AFF_BYTES;

static_assert(TH == 16 && TW == 16, "a pass is 8 rows of 16 pixels: two M tiles");
static_assert(XS_BYTES % 16 == 0 && W_TAP_BYTES % 1024 == 0, "alignment of the buffers");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block on sm_90");

constexpr int BAR_WG = 1;  // + warpgroup: its own named barrier (0 is __syncthreads)
constexpr int BAR_START = BAR_WG + WGS;  // + warpgroup: the next one may start

// 16 bytes from global to shared memory; zeros where `valid` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Tile {
  int img, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y) {
  const int per_img = tiles_x * tiles_y;
  const int img = t / per_img, rem = t - img * per_img;
  const int ty = rem / tiles_x;
  return {img, ty * TH, (rem - ty * tiles_x) * TW};
}

// Rows [row0, row1) of tile t's input tile into xs, as one cp.async group.
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ x, uint32_t xs_addr,
                                          int t, int row0, int row1, int H, int W,
                                          int tiles_x, int tiles_y, int wtid) {
  const Tile tl = tile_at(t, tiles_x, tiles_y);
  const __nv_bfloat16* xi = x + size_t(tl.img) * H * W * C;
  for (int i = row0 * XW * 8 + wtid; i < row1 * XW * 8; i += WG) {
    const int p = i >> 3, q = i & 7;
    const int y = tl.y0 - 1 + p / XW, xx = tl.x0 - 1 + p % XW;
    const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
    cp_async16(xs_addr + uint32_t((p * LD + q * 8) * 2),
               inside ? xi + (size_t(y) * W + xx) * C + q * 8 : x, inside);
  }
  cp_async_commit();
}

template <bool POOL>
__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ w_image,
               const float* __restrict__ scale, const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int H, int W, int tiles_x, int tiles_y,
               int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* xs_base = smem + W_BYTES;
  float* aff = reinterpret_cast<float*>(xs_base + WGS * XS_BYTES);

  const int first = blockIdx.x, stride = gridDim.x;
  const int n_mine = (n_tiles - first + stride - 1) / stride;
  // the warpgroup index through a shuffle, so that the compiler knows it to be
  // the same for a whole warp: it serialises wgmma on a path it takes for divergent
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / WG, 0);
  const int wtid = threadIdx.x - wg * WG;
  const uint32_t xs_addr = smem_u32(xs_base + wg * XS_BYTES);

  // the first tile's input is requested before the weights are copied
  if (wg < n_mine) load_rows(x, xs_addr, first + wg * stride, 0, XH, H, W, tiles_x, tiles_y, wtid);

  // once per block: the swizzled weight image as it is, and scale and bias as
  // (s, s', b, b') per channel pair, one 16-byte load in an epilogue
  for (int i = threadIdx.x; i < W_BYTES / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(smem)[i] = __ldg(w_image + i);
  if (threadIdx.x < C) {
    const int pair = threadIdx.x >> 1, odd = threadIdx.x & 1;
    aff[4 * pair + odd] = scale[threadIdx.x];
    aff[4 * pair + 2 + odd] = bias[threadIdx.x];
  }
  // wgmma reads the weights through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int cw = wtid >> 5, lane = wtid & 31, g = lane >> 2, t4 = lane & 3;
  const uint64_t desc0 = weight_desc(smem_u32(smem));
  // (s, s', b, b') of the channels 8*nt + 2*t4, + 1 at [nt * 4 + t4]
  const float4* aff4 = reinterpret_cast<const float4*>(aff);
  // A pass is 8 output rows of the tile, two M tiles.  This warp's 16 rows of
  // M tile j are columns wx + 0..7 of output rows wy + 2*j (rows 0-7) and
  // wy + 2*j + 1 (rows 8-15), so its two M tiles and their three vertical taps
  // read six consecutive rows wy .. wy + 5 of the pass's input rows.
  const int wy = 4 * (cw >> 1), wx = 8 * (cw & 1);
  // ldmatrix.x4: lanes 8i..8i+7 give the row addresses of matrix i; matrices
  // 0/1 are two consecutive image rows at channels 0-7 of the k step, 2/3 at 8-15
  const int mat = lane >> 3, r = lane & 7;
  const uint32_t a_lane =
      xs_addr + uint32_t((((wy + (mat & 1)) * XW + wx + r) * LD + (mat >> 1) * 8) * 2);

  for (int it = wg; it < n_mine; it += WGS) {
    const Tile tl = tile_at(first + it * stride, tiles_x, tiles_y);
    const bool has_next = it + WGS < n_mine;
    cp_async_wait_all();
    bar_sync(BAR_WG + wg, WG);  // the tile's input has arrived for every thread

#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const bool active = tl.y0 + 8 * pass < H;  // the same for the whole warpgroup
      float acc[2][32];
      if (active) {
        // Warpgroups that start together stay in step, all loading, then all
        // in the products.  So each goes into its first products when the one
        // before it has left the first pass of its own.
        if (it == wg && pass == 0 && wg > 0) bar_sync(BAR_START + wg - 1, 2 * WG);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[0][e] = acc[1][e] = 0.f;
        const uint32_t a_pass = a_lane + uint32_t(8 * pass * XW * LD * 2);
        // One step is a horizontal tap dx and 16 of the 64 input channels: the
        // six image rows are loaded once (rows[i] holds rows 2i and 2i + 1, low
        // and high half of the channels) and feed six products, the two M
        // tiles times the three vertical taps.
        uint32_t rows[2][3][4];
        auto load_a = [&](uint32_t (&rr)[3][4], int step) {
          const uint32_t at = a_pass + uint32_t(((step / 4) * LD + (step % 4) * 16) * 2);
#pragma unroll
          for (int i = 0; i < 3; ++i) ldmatrix_x4(rr[i], at + uint32_t(i * 2 * XW * LD * 2));
        };
        load_a(rows[0], 0);
#pragma unroll
        for (int s = 0; s < 12; ++s) {
          const int dx = s / 4, kc = s % 4;
          const uint32_t(&rr)[3][4] = rows[s & 1];
          wgmma_fence();
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const uint64_t desc =
                desc0 + uint64_t(((dy * 3 + dx) * W_TAP_BYTES + kc * 32) >> 4);
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
            load_a(rows[(s + 1) & 1], s + 1);
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 32; ++e) fence_operand(acc[j][e]);
        if (it == wg && pass == 0 && wg + 1 < WGS && wg + 1 < n_mine)
          bar_arrive(BAR_START + wg, 2 * WG);
      }

      // every warp is done with this pass's input rows: the next tile's may come
      bar_sync(BAR_WG + wg, WG);
      if (has_next)
        load_rows(x, xs_addr, first + (it + WGS) * stride, pass == 0 ? 0 : 8,
                  pass == 0 ? 8 : XH, H, W, tiles_x, tiles_y, wtid);
      if (!active) continue;

      // ---- epilogue: scale, bias, ReLU (, 2x2 max), bf16 --------------------
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int y = tl.y0 + 8 * pass + wy + 2 * j;  // rows g; rows g + 8 are y + 1
        const int xx = tl.x0 + wx + g;
        float e[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float4 sb = aff4[nt * 4 + t4];
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
  }
}

template <bool POOL>
cudaError_t launch(const void* x, const void* w, const void* s, const void* b, void* out,
                   int B, int H, int W, int sms, cudaStream_t stream) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int n_tiles = B * tiles_x * tiles_y;
  auto kernel = conv3x3_kernel<POOL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles < sms ? n_tiles : sms, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(w),
      static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(out), H, W, tiles_x, tiles_y, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// x [B,H,W,64] bf16; wa and wb the 73,728-byte swizzled images described above
// (ssp_torch.kernels.stem.swizzle_w2); scales and biases fp32 [64]; mid
// [B,H,W,64] bf16 scratch for the intermediate; out [B,H/2,W/2,64] (pool) or
// [B,H,W,64] bf16.  Two launches on `stream`: conv a into mid, conv b into out.
extern "C" int ssp_down1_launch(const void* x, const void* wa, const void* sa,
                                const void* ba, const void* wb, const void* sb,
                                const void* bb, void* mid, void* out, int B, int H, int W,
                                int pool, void* stream) {
  const long long tiles = (long long)B * ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
  if (B <= 0 || H <= 0 || W <= 0 || tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (err == cudaSuccess) err = launch<false>(x, wa, sa, ba, mid, B, H, W, sms, st);
  if (err == cudaSuccess)
    err = pool ? launch<true>(mid, wb, sb, bb, out, B, H, W, sms, st)
               : launch<false>(mid, wb, sb, bb, out, B, H, W, sms, st);
  return int(err);
}
