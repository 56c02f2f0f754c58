// Cross-checked brute-force matching of byte descriptors, as OpenCV's
// BFMatcher(NORM_L2 or NORM_HAMMING, crossCheck=true).match: query row q is
// matched to its nearest train row t = nn(q) when q is in turn the nearest
// query row of t; the output is, per query row, the key of its match or
// none.  Distances are exact:
//
//   * L2 (SIFT): the descriptors are integers in [0, 255] (OpenCV saturates
//     SIFT's to uchar before storing them as float), held here as bytes; the
//     squared distance s = |a|^2 + |b|^2 - 2 a.b is an exact integer (at
//     most 128 * 255^2 < 2^24, a.b summed exactly in int32) and the distance
//     is its IEEE float square root (__fsqrt_rn), as OpenCV's float sqrt of
//     its float sum (exact for such sums, whatever the order);
//   * Hamming (ORB): popc(a) + popc(b) - 2 popc(a & b), an integer.
//
// Nearest means the least distance as a float, ties going to the lowest
// index (OpenCV's strict <): the key of a candidate is the float distance's
// bits (non-negative floats order as their bits) above its index, and the
// nearest is the least key.  Keys stay on the float root: two integer sums
// past about 2^22 can share a root (4,197,200 and 4,197,201 both give
// 2048.707), and OpenCV then keeps the lower index, which a minimum over the
// integer sums would not.
//
// Replaces no TPU kernel: the JAX package matches on the host with
// cv2.BFMatcher.  What bounds it on an H100: operations, two int8
// tensor-core operations per byte pair (L2) or bit pair (Hamming) of the
// Nq * Nt pairs; the inputs are a few hundred kB, so at the sizes of a pair
// of images (1000 x 1000 rows) the time is latency: one launch, the tiles'
// loads, the reductions.  The design, one launch per call and no memset:
//
//   * one block of 256 threads per tile of 64 query rows x 128 train rows of
//     the distance matrix (128 blocks at 1000 x 1000); the two tiles of rows
//     are staged in shared memory as 32-bit words (16-byte loads where the
//     rows allow), zero-padded to whole k steps (32 bytes, 256 bits: a zero
//     changes no dot product, norm or popcount), with a row pitch of 36
//     words (the fragment loads of a warp fall in 32 distinct banks); each
//     row's norm (__dp4a) or popcount once per tile;
//   * each warp takes 32 x 32 of the tile on the tensor cores: L2 with
//     mma.sync m16n8k32 u8 x u8 -> s32, Hamming with mma.sync m16n8k256
//     b1 AND-popc -> s32; the fragments of both are the same words;
//   * keys reduced with warp shuffles to one per row and one per column of
//     each warp's part, then across the tile's warps in shared memory, and
//     stored with plain stores: per query row, its nearest train row in this
//     tile's columns; per train row, its nearest query row in this tile's
//     rows;
//   * no second launch: the last block of each strip of query rows (a
//     counter per strip, incremented acquire-release after the block's
//     stores) reduces the strip's minima over the tiles, the last block of
//     each column of train rows the column's, and the last block of all
//     applies the cross-check; each last block resets its counter.  The
//     counters are __device__ words of this library, zero when it loads and
//     left at zero by every launch, so launches on one device must not
//     overlap (calls on one stream do not);
//   * the minima are found on the exact integers first, and the float root
//     taken of the least sum and of a sum that could share its root.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;           // query rows per block
constexpr int TT = 128;          // train rows per block
constexpr int THREADS = 256;     // 8 warps: 2 along the query rows x 4 along the train rows
constexpr int MAX_WORDS = 32;    // descriptors of at most 128 bytes
constexpr int PITCH = MAX_WORDS + 4;
constexpr unsigned long long NONE = ~0ull;

constexpr int MAX_TILES = 16384;  // strips of query rows, columns of train rows
// [0]: the blocks done of the current launch; then per strip of query rows,
// then per column of train rows
__device__ unsigned int done[1 + 2 * MAX_TILES] = {};

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// atomic increment with acquire-release at the device's scope: after a
// __syncthreads, it publishes the block's earlier stores and, for the block
// that sees the last count, the other blocks' (no separate __threadfence)
__device__ __forceinline__ unsigned int arrive(unsigned int* counter) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long min_xor(unsigned long long v, int lanes) {
  return min(v, __shfl_xor_sync(0xffffffffu, v, lanes));
}

// The key of the nearest of N candidates (sums s, INT_MAX for none; index
// increasing with p), found on the integers first (strict <: the lowest
// index of the least s).  The root is taken of that s, and of another s
// only where it could share the root (s within 3 above it: past 2^22 two
// sums can, at most two below 128 * 255^2) for a lower index, which OpenCV
// keeps; a warp vote keeps the compiler from taking those roots always.
// Called by every lane of the warp.
template <bool HAMMING, int N>
__device__ __forceinline__ unsigned long long nearest(const int (&s)[N], const int (&index)[N]) {
  int s_min = s[0], i_min = index[0];
#pragma unroll
  for (int p = 1; p < N; p++)
    if (s[p] < s_min) {
      s_min = s[p];
      i_min = index[p];
    }
  const float d = HAMMING ? static_cast<float>(s_min) : __fsqrt_rn(static_cast<float>(s_min));
  if (!HAMMING) {
    bool near = false;
#pragma unroll
    for (int p = 0; p < N; p++)
      near |= index[p] < i_min && static_cast<unsigned>(s[p] - s_min) - 1u < 3u;
    if (__any_sync(0xffffffffu, near)) {
#pragma unroll
      for (int p = N - 1; p >= 0; p--)
        if (index[p] < i_min && static_cast<unsigned>(s[p] - s_min) - 1u < 3u &&
            __fsqrt_rn(static_cast<float>(s[p])) == d)
          i_min = index[p];
    }
  }
  if (s_min == 0x7fffffff) return NONE;
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | static_cast<uint32_t>(i_min);
}

// rows [r0, r0 + N) of src (words each) into dst [N][PITCH], zero past nr
// rows and past the words, up to kw words.  Every load of a thread is
// issued before its first store (a store right after its load would wait
// for it, one load at a time).
template <int N>
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* __restrict__ src, int r0,
                                      int nr, int words, int kw, bool vec4) {
  if (vec4) {  // words % 4 == 0 and src 16-byte aligned
    constexpr int PER = (N * MAX_WORDS / 4 + THREADS - 1) / THREADS;
    const int v = words >> 2, kv = kw >> 2;
    uint4 x[PER];
#pragma unroll
    for (int e = 0; e < PER; e++) {
      const int i = threadIdx.x + e * THREADS, r = i / kv, w = i - r * kv;
      x[e] = make_uint4(0u, 0u, 0u, 0u);
      if (i < N * kv && w < v && r0 + r < nr)
        x[e] = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * words) + w);
    }
#pragma unroll
    for (int e = 0; e < PER; e++) {
      const int i = threadIdx.x + e * THREADS, r = i / kv, w = i - r * kv;
      if (i < N * kv) *reinterpret_cast<uint4*>(dst + r * PITCH + 4 * w) = x[e];
    }
  } else {
    constexpr int PER = (N * MAX_WORDS + THREADS - 1) / THREADS;
    uint32_t x[PER];
#pragma unroll
    for (int e = 0; e < PER; e++) {
      const int i = threadIdx.x + e * THREADS, r = i / kw, w = i - r * kw;
      x[e] = i < N * kw && w < words && r0 + r < nr
                 ? __ldg(src + static_cast<size_t>(r0 + r) * words + w)
                 : 0u;
    }
#pragma unroll
    for (int e = 0; e < PER; e++) {
      const int i = threadIdx.x + e * THREADS, r = i / kw, w = i - r * kw;
      if (i < N * kw) dst[r * PITCH + w] = x[e];
    }
  }
}

template <bool HAMMING>
__global__ void __launch_bounds__(THREADS)
match_kernel(const uint32_t* __restrict__ query, const uint32_t* __restrict__ train, int nq,
             int nt, int words, bool vec4, unsigned long long* __restrict__ q_part,
             unsigned long long* __restrict__ t_part, unsigned long long* __restrict__ out) {
  __shared__ __align__(16) uint32_t tiles[(TQ + TT) * PITCH];
  uint32_t* qs = tiles;
  uint32_t* ts = tiles + TQ * PITCH;
  __shared__ uint32_t q_norm[TQ], t_norm[TT];
  __shared__ unsigned long long row_min[4][TQ], col_min[2][TT];
  __shared__ bool strip_last, column_last, last;
  const int q0 = blockIdx.y * TQ, t0 = blockIdx.x * TT;
  const int kw = (words + 7) & ~7;  // words padded to whole k steps

  // ---- the two tiles of rows and their norms (or popcounts)
  stage<TQ>(qs, query, q0, nq, words, kw, vec4);
  stage<TT>(ts, train, t0, nt, words, kw, vec4);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {  // 8 lanes a row, 4 words each (the padding is zero), 4 rows a warp at a time
    const int j = lane & 7;
    for (int r = warp * 4 + (lane >> 3); r < TQ + TT; r += THREADS / 8) {
      const uint32_t* row = r < TQ ? qs + r * PITCH : ts + (r - TQ) * PITCH;
      uint32_t s = 0;
      if (4 * j < kw) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + 4 * j);
        s = HAMMING ? __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w)
                    : __dp4a(v.x, v.x, __dp4a(v.y, v.y, __dp4a(v.z, v.z, __dp4a(v.w, v.w, 0u))));
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (j == 0) (r < TQ ? q_norm[r] : t_norm[r - TQ]) = s;
    }
  }

  // ---- a . b (or popc(a & b)) of the warp's 32 x 32 on the tensor cores
  const int wq = warp >> 2, wt = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  int acc[2][4][4] = {};
  for (int k = 0; k < kw; k += 8) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; mi++) {
      const uint32_t* p = qs + (wq * 32 + mi * 16 + g) * PITCH + k + tig;
      a[mi][0] = p[0];
      a[mi][1] = p[8 * PITCH];
      a[mi][2] = p[4];
      a[mi][3] = p[8 * PITCH + 4];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ni++) {
      const uint32_t* p = ts + (wt * 32 + ni * 8 + g) * PITCH + k + tig;
      b[ni][0] = p[0];
      b[ni][1] = p[4];
    }
#pragma unroll
    for (int mi = 0; mi < 2; mi++)
#pragma unroll
      for (int ni = 0; ni < 4; ni++) {
        if (HAMMING)
          mma_b1(acc[mi][ni], a[mi], b[ni]);
        else
          mma_u8(acc[mi][ni], a[mi], b[ni]);
      }
  }
  __syncthreads();  // the norms

  // ---- the sums s, exact integers (INT_MAX past the rows); c[j] of an
  // m16n8 product is at row g + 8 (j / 2), column 2 tig + j % 2
  int sq[2][2][8];  // [mi][h][ni * 2 + c]: this thread's 4 rows x 8 columns
  int q_of[2][2], t_of[8];
#pragma unroll
  for (int ni = 0; ni < 4; ni++)
#pragma unroll
    for (int c = 0; c < 2; c++) t_of[ni * 2 + c] = t0 + wt * 32 + ni * 8 + 2 * tig + c;
#pragma unroll
  for (int mi = 0; mi < 2; mi++)
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int rl = wq * 32 + mi * 16 + h * 8 + g;
      const int nrm = static_cast<int>(q_norm[rl]);
      q_of[mi][h] = q0 + rl;
#pragma unroll
      for (int ni = 0; ni < 4; ni++)
#pragma unroll
        for (int c = 0; c < 2; c++) {
          const int cl = wt * 32 + ni * 8 + 2 * tig + c;
          sq[mi][h][ni * 2 + c] =
              q0 + rl < nq && t0 + cl < nt
                  ? nrm + static_cast<int>(t_norm[cl]) - 2 * acc[mi][ni][2 * h + c]
                  : 0x7fffffff;
        }
    }
  // each of its rows' nearest column and each column's nearest row, as keys
  unsigned long long rmin[2][2], cmin[4][2];
#pragma unroll
  for (int mi = 0; mi < 2; mi++)
#pragma unroll
    for (int h = 0; h < 2; h++) rmin[mi][h] = nearest<HAMMING, 8>(sq[mi][h], t_of);
#pragma unroll
  for (int p = 0; p < 8; p++) {
    const int col[4] = {sq[0][0][p], sq[0][1][p], sq[1][0][p], sq[1][1][p]};
    const int rows[4] = {q_of[0][0], q_of[0][1], q_of[1][0], q_of[1][1]};
    cmin[p >> 1][p & 1] = nearest<HAMMING, 4>(col, rows);
  }
#pragma unroll
  for (int mi = 0; mi < 2; mi++)
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const unsigned long long v = min_xor(min_xor(rmin[mi][h], 1), 2);
      if (tig == 0) row_min[wt][wq * 32 + mi * 16 + h * 8 + g] = v;
    }
#pragma unroll
  for (int ni = 0; ni < 4; ni++)
#pragma unroll
    for (int c = 0; c < 2; c++) {
      const unsigned long long v = min_xor(min_xor(min_xor(cmin[ni][c], 4), 8), 16);
      if (g == 0) col_min[wq][wt * 32 + ni * 8 + 2 * tig + c] = v;
    }
  __syncthreads();

  // ---- this tile's nearest per query row and per train row: plain stores
  if (threadIdx.x < TQ) {
    const int i = threadIdx.x, q = q0 + i;
    if (q < nq)
      q_part[static_cast<size_t>(blockIdx.x) * nq + q] =
          min(min(row_min[0][i], row_min[1][i]), min(row_min[2][i], row_min[3][i]));
  } else if (threadIdx.x < TQ + TT) {
    const int i = threadIdx.x - TQ, t = t0 + i;
    if (t < nt)
      t_part[static_cast<size_t>(blockIdx.y) * nt + t] = min(col_min[0][i], col_min[1][i]);
  }

  // ---- the last block of a strip of query rows (of a column of train
  // rows) reduces the strip's (column's) minima over the tiles into row 0 of
  // q_part (t_part); the last block of all applies the cross-check
  unsigned int* strip_done = done + 1 + blockIdx.y;
  unsigned int* column_done = done + 1 + gridDim.y + blockIdx.x;
  __syncthreads();
  if (threadIdx.x == 0) strip_last = arrive(strip_done) == gridDim.x - 1;
  if (threadIdx.x == 32) column_last = arrive(column_done) == gridDim.y - 1;  // in flight together
  __syncthreads();
  // TILES tiles at once: their loads in flight together (clamped: a
  // repeated tile changes no minimum)
  constexpr int TILES = 8;
  auto reduce = [&](unsigned long long* part, int n, int i, int tiles) {
    unsigned long long m = NONE;
    for (int j0 = 0; j0 < tiles; j0 += TILES) {
      unsigned long long v[TILES];
#pragma unroll
      for (int a = 0; a < TILES; a++)
        v[a] = __ldcg(part + static_cast<size_t>(min(j0 + a, tiles - 1)) * n + i);
#pragma unroll
      for (int a = 0; a < TILES; a++) m = min(m, v[a]);
    }
    __stcg(part + i, m);
  };
  if (strip_last && threadIdx.x < TQ && q0 + threadIdx.x < nq)
    reduce(q_part, nq, q0 + threadIdx.x, gridDim.x);
  if (column_last && threadIdx.x >= TQ && threadIdx.x < TQ + TT && t0 + threadIdx.x - TQ < nt)
    reduce(t_part, nt, t0 + threadIdx.x - TQ, gridDim.y);
  if (threadIdx.x == 0) {
    if (strip_last) *strip_done = 0;
    if (column_last) *column_done = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) last = arrive(done) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  constexpr int BATCH = 4;  // query rows a thread checks at once: their loads in flight together
  for (int base = threadIdx.x; base < nq; base += BATCH * THREADS) {
    unsigned long long m[BATCH], nn_q[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; u++) m[u] = __ldcg(q_part + min(base + u * THREADS, nq - 1));
#pragma unroll
    for (int u = 0; u < BATCH; u++)
      nn_q[u] = __ldcg(t_part + static_cast<uint32_t>(m[u] & 0xffffffffu));
#pragma unroll
    for (int u = 0; u < BATCH; u++) {
      const int q = base + u * THREADS;
      if (q < nq)
        out[q] = static_cast<uint32_t>(nn_q[u] & 0xffffffffu) == static_cast<uint32_t>(q) ? m[u]
                                                                                         : NONE;
    }
  }
  if (threadIdx.x == 0) *done = 0;
}

}  // namespace

// Keys of scratch that ssp_bfmatch_launch needs for nq query and nt train
// rows: each query row's nearest per tile of train rows, and each train
// row's per tile of query rows.
extern "C" long long ssp_bfmatch_scratch(int nq, int nt) {
  return static_cast<long long>((nt + TT - 1) / TT) * nq +
         static_cast<long long>((nq + TQ - 1) / TQ) * nt;
}

// query [nq, words], train [nt, words]: descriptor bytes as 32-bit words;
// scratch: ssp_bfmatch_scratch(nq, nt) keys; out [nq] keys (distance bits
// << 32 | train row) or ~0 for no match.  hamming: NORM_HAMMING, else
// NORM_L2.  One launch.  Returns a CUDA error code.
extern "C" int ssp_bfmatch_launch(const void* query, const void* train, int nq, int nt,
                                  int words, int hamming, void* scratch, void* out,
                                  void* stream) {
  if (nq <= 0 || nt <= 0 || words <= 0 || words > MAX_WORDS) return int(cudaErrorInvalidValue);
  const dim3 grid((nt + TT - 1) / TT, (nq + TQ - 1) / TQ);
  if (grid.x > unsigned(MAX_TILES) || grid.y > unsigned(MAX_TILES))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const uint32_t*>(query);
  const auto* t = static_cast<const uint32_t*>(train);
  const bool vec4 = words % 4 == 0 && reinterpret_cast<uintptr_t>(query) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(train) % 16 == 0;
  auto* q_part = static_cast<unsigned long long*>(scratch);
  auto* t_part = q_part + static_cast<size_t>(grid.x) * nq;
  auto* o = static_cast<unsigned long long*>(out);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  const cudaError_t err =
      hamming ? cudaLaunchKernelEx(&cfg, match_kernel<true>, q, t, nq, nt, words, vec4, q_part,
                                   t_part, o)
              : cudaLaunchKernelEx(&cfg, match_kernel<false>, q, t, nq, nt, words, vec4, q_part,
                                   t_part, o);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}
