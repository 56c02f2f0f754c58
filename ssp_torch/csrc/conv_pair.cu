// Fused "3x3 conv 64->64 -> folded BN -> ReLU -> 3x3 conv 64->64 -> folded BN
// -> ReLU (-> 2x2 max)" for SuperPoint's down1, NHWC bf16, SAME padding.
//
// Replaces the TPU kernel ssp/kernels/down1_pallas.py::down1_pallas_packed.
// (The stem, the same pair with a 1-channel first conv, has its own kernel
// in stem.cu.)
//
// Bound on an H100: tensor-core operations.  At 16x240x320 down1 does ~0.18
// TFLOP of bf16 conv work against ~0.2 GB of HBM traffic, far above the
// card's ~295 FLOP/byte ridge.  The design therefore keeps the intermediate
// activation out of device memory entirely and feeds both convs to the
// tensor cores as implicit GEMMs:
//
//   * a block owns a TH x TW output tile (before pooling) and all 64
//     output channels;
//   * it loads the input tile with a 2-pixel halo into shared memory (zeros
//     outside the image), and the first conv's 64x64x9 weights;
//   * it computes the first conv for the tile plus a 1-pixel halo into
//     shared memory as bf16, and writes 0 (not ReLU(bias)) wherever that
//     halo lies outside the image, because the second conv's SAME padding
//     reads zeros there; then it loads the second conv's weights over the
//     first's;
//   * both convs run on mma.sync m16n8k16 (bf16 operands, fp32
//     accumulation): M = pixels, N = 64 output channels, K = 9 taps x 64
//     input channels; in the second conv each warp owns two 16-pixel output
//     rows, so the 2x2 max of the epilogue happens in registers (rows) and
//     one shuffle (columns);
//   * the epilogue applies the fp32 scale/bias and ReLU and stores NHWC
//     bf16.
//
// Shared-memory rows are padded from 64 to 72 bf16 (144 B) so the 32-bit
// fragment loads of a warp hit 32 distinct banks.
//
// Numerics follow the TPU kernel: bf16 input and weights, products
// accumulate in fp32, the scale/bias epilogue is fp32 (a separate multiply
// and add, not a fused FMA), the intermediate is rounded to bf16 before the
// second conv, and the output is bf16.
//
// Not yet done (the stem's kernel shows each): a persistent block that keeps
// both convs' weights in shared memory across tiles (here each of the
// blocks copies 2 x 72 KB from L2), wgmma for the two convs in place of
// mma.sync fed by 32-bit shared-memory loads, and load, first conv and
// second conv overlapped instead of separated by __syncthreads().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;                  // output channels of both convs
constexpr int TH = 16;                 // output rows per block
constexpr int TW = 16;                 // output columns per block
constexpr int MH = TH + 2;             // intermediate tile rows (1-px halo)
constexpr int MW = TW + 2;
constexpr int XH = TH + 4;             // input tile rows (2-px halo)
constexpr int XW = TW + 4;
constexpr int LD = C + 8;              // smem row stride in bf16 elements
constexpr int NWARPS = 8;              // warp w owns output rows 2w, 2w+1
constexpr int NTHREADS = NWARPS * 32;
constexpr int MID_PIX = MH * MW;       // 324 intermediate pixels
constexpr int MID_TILES = 24;          // 16-row m-tiles covering them (>= 21)
constexpr int MID_TILES_PER_WARP = MID_TILES / NWARPS;

static_assert(TH == 2 * NWARPS, "each warp owns two output rows");
static_assert(TW == 16, "one output row is one 16-pixel m-tile");
static_assert(MID_TILES * 16 >= MID_PIX, "m-tiles must cover the halo tile");

constexpr size_t W_BYTES = size_t(9) * C * LD * 2;
constexpr size_t MID_BYTES = size_t(MID_PIX) * LD * 2;

constexpr size_t SMEM_BYTES = W_BYTES + MID_BYTES + size_t(XH * XW) * LD * 2;

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Weights [3][3][C out][C in] bf16 (global, dense) -> smem [9][C][LD].
__device__ __forceinline__ void load_weights(__nv_bfloat16* ws,
                                             const __nv_bfloat16* __restrict__ w) {
  for (int i = threadIdx.x; i < 9 * C * (C / 8); i += NTHREADS) {
    const int row = i >> 3, q = i & 7;
    *reinterpret_cast<uint4*>(ws + row * LD + q * 8) =
        __ldg(reinterpret_cast<const uint4*>(w + row * C + q * 8));
  }
}

// Implicit-GEMM 3x3 conv over 64 input channels for MT m-tiles of 16
// pixels and all 64 output channels.  src holds pixels with row stride LD;
// pa[j]/pb[j] are the pixel indices (in src) of the top-left tap for this
// lane's rows g and g+8 of m-tile j; SW is src's tile width in pixels.
template <int SW, int MT>
__device__ __forceinline__ void conv3x3_mma(float (&acc)[MT][8][4],
                                            const __nv_bfloat16* src,
                                            const int (&pa)[MT], const int (&pb)[MT],
                                            const __nv_bfloat16* ws, int g, int t4) {
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3) * SW + (tap % 3);
    const uint32_t* wt =
        reinterpret_cast<const uint32_t*>(ws + (tap * C + g) * LD) + t4;
    const uint32_t* ra[MT];
    const uint32_t* rb[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      ra[j] = reinterpret_cast<const uint32_t*>(src + (pa[j] + off) * LD) + t4;
      rb[j] = reinterpret_cast<const uint32_t*>(src + (pb[j] + off) * LD) + t4;
    }
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        a[j][0] = ra[j][kc * 8];
        a[j][1] = rb[j][kc * 8];
        a[j][2] = ra[j][kc * 8 + 4];
        a[j][3] = rb[j][kc * 8 + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint32_t* wn = wt + nt * 8 * (LD / 2) + kc * 8;
        const uint32_t b0 = wn[0], b1 = wn[4];
#pragma unroll
        for (int j = 0; j < MT; ++j)
          mma_bf16(acc[j][nt], a[j][0], a[j][1], a[j][2], a[j][3], b0, b1);
      }
    }
  }
}

__device__ __forceinline__ float affine_relu(float v, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), b), 0.f);
}

template <bool POOL>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_pair_kernel(const __nv_bfloat16* __restrict__ x_all, const __nv_bfloat16* __restrict__ w1,
                 const float* __restrict__ s1, const float* __restrict__ b1,
                 const __nv_bfloat16* __restrict__ w2, const float* __restrict__ s2,
                 const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                 int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);          // [9][C][LD]
  __nv_bfloat16* mid = reinterpret_cast<__nv_bfloat16*>(smem + W_BYTES);  // [MID_PIX][LD]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + W_BYTES + MID_BYTES);  // [XH*XW][LD]

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // ---- 1. input tile with a 2-pixel halo (zeros outside the image) ----
  const __nv_bfloat16* x = x_all + size_t(b) * H * W * C;
  for (int i = tid; i < XH * XW * (C / 8); i += NTHREADS) {
    const int p = i >> 3, q = i & 7;
    const int y = y0 - 2 + p / XW, xx = x0 - 2 + p % XW;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (y >= 0 && y < H && xx >= 0 && xx < W)
      v = __ldg(reinterpret_cast<const uint4*>(x + (size_t(y) * W + xx) * C + q * 8));
    *reinterpret_cast<uint4*>(xs + p * LD + q * 8) = v;
  }
  load_weights(ws, w1);
  __syncthreads();

  // ---- 2. first conv over the tile + 1-px halo -> mid (bf16) ----------
  {
    int pa[MID_TILES_PER_WARP], pb[MID_TILES_PER_WARP];
#pragma unroll
    for (int j = 0; j < MID_TILES_PER_WARP; ++j) {
      const int m0 = (warp * MID_TILES_PER_WARP + j) * 16 + g, m1 = m0 + 8;
      // rows past the halo tile compute garbage from pixel 0 and are dropped
      pa[j] = m0 < MID_PIX ? (m0 / MW) * XW + m0 % MW : 0;
      pb[j] = m1 < MID_PIX ? (m1 / MW) * XW + m1 % MW : 0;
    }
    float acc[MID_TILES_PER_WARP][8][4];
    conv3x3_mma<XW, MID_TILES_PER_WARP>(acc, xs, pa, pb, ws, g, t4);
#pragma unroll
    for (int j = 0; j < MID_TILES_PER_WARP; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (warp * MID_TILES_PER_WARP + j) * 16 + g + 8 * h;
        if (m >= MID_PIX) continue;
        const int y = y0 - 1 + m / MW, xx = x0 - 1 + m % MW;
        const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = nt * 8 + 2 * t4;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = affine_relu(acc[j][nt][2 * h], __ldg(s1 + c), __ldg(b1 + c));
            v1 = affine_relu(acc[j][nt][2 * h + 1], __ldg(s1 + c + 1), __ldg(b1 + c + 1));
          }
          *reinterpret_cast<__nv_bfloat162*>(mid + m * LD + c) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();  // every warp is done reading w1 from ws
    load_weights(ws, w2);
  }
  __syncthreads();

  // ---- 3. second conv: warp owns output rows 2w and 2w+1 -------------
  float acc[2][8][4];
  {
    int pa[2], pb[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      pa[j] = (2 * warp + j) * MW + g;
      pb[j] = pa[j] + 8;
    }
    conv3x3_mma<MW, 2>(acc, mid, pa, pb, ws, g, t4);
  }

  // ---- 4. epilogue: scale/bias, ReLU, optional 2x2 max, bf16 NHWC ----
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * t4;
    const float sa = __ldg(s2 + c), sb = __ldg(s2 + c + 1);
    const float ba = __ldg(b2 + c), bb = __ldg(b2 + c + 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[j][nt][0] = affine_relu(acc[j][nt][0], sa, ba);
      acc[j][nt][1] = affine_relu(acc[j][nt][1], sb, bb);
      acc[j][nt][2] = affine_relu(acc[j][nt][2], sa, ba);
      acc[j][nt][3] = affine_relu(acc[j][nt][3], sb, bb);
    }
    if constexpr (POOL) {
      // rows 2w, 2w+1 -> pooled row w; columns g, g+1 live in lanes 4 apart
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = fmaxf(acc[0][nt][e], acc[1][nt][e]);
        v[e] = fmaxf(v[e], __shfl_xor_sync(0xffffffffu, v[e], 4));
      }
      const int Ho = H / 2, Wo = W / 2;
      const int py = y0 / 2 + warp;
      if ((g & 1) == 0 && py < Ho) {
        __nv_bfloat16* orow = out + (size_t(b) * Ho + py) * Wo * C;
        const int px0 = x0 / 2 + g / 2, px1 = px0 + 4;  // columns g and g+8
        if (px0 < Wo)
          *reinterpret_cast<__nv_bfloat162*>(orow + size_t(px0) * C + c) =
              __floats2bfloat162_rn(v[0], v[1]);
        if (px1 < Wo)
          *reinterpret_cast<__nv_bfloat162*>(orow + size_t(px1) * C + c) =
              __floats2bfloat162_rn(v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int y = y0 + 2 * warp + j;
        if (y >= H) continue;
        __nv_bfloat16* orow = out + (size_t(b) * H + y) * W * C;
        const int xa = x0 + g, xb = xa + 8;
        if (xa < W)
          *reinterpret_cast<__nv_bfloat162*>(orow + size_t(xa) * C + c) =
              __floats2bfloat162_rn(acc[j][nt][0], acc[j][nt][1]);
        if (xb < W)
          *reinterpret_cast<__nv_bfloat162*>(orow + size_t(xb) * C + c) =
              __floats2bfloat162_rn(acc[j][nt][2], acc[j][nt][3]);
      }
    }
  }
}

template <bool POOL>
int launch(const void* x, const void* w1, const void* s1, const void* b1,
           const void* w2, const void* s2, const void* b2, void* out, int B,
           int H, int W, void* stream) {
  auto kernel = conv_pair_kernel<POOL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), H, W);
  return int(cudaGetLastError());
}

}  // namespace

// x [B,H,W,64] bf16; w1, w2 [3,3,64 out,64 in] bf16; scales/biases fp32 [64];
// out [B,H/2,W/2,64] (pool) or [B,H,W,64] bf16.
extern "C" int ssp_down1_launch(const void* x, const void* w1, const void* s1,
                                const void* b1, const void* w2, const void* s2,
                                const void* b2, void* out, int B, int H, int W,
                                int pool, void* stream) {
  return pool ? launch<true>(x, w1, s1, b1, w2, s2, b2, out, B, H, W, stream)
              : launch<false>(x, w1, s1, b1, w2, s2, b2, out, B, H, W, stream);
}
