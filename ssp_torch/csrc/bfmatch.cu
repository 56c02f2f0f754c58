// Cross-checked brute-force matching of byte descriptors, as OpenCV's
// BFMatcher(NORM_L2 or NORM_HAMMING, crossCheck=true).match: query row q is
// matched to its nearest train row t = nn(q) when q is in turn the nearest
// query row of t; the output is, per query row, the key of its match or
// none.  Distances are exact:
//
//   * L2 (SIFT): the descriptors are integers in [0, 255] (OpenCV saturates
//     SIFT's to uchar before storing them as float), held here as bytes; the
//     squared distance is an exact integer (at most 128 * 255^2 < 2^24) and
//     the distance is its IEEE sqrtf, as OpenCV's float sqrt of its float
//     sum (which is exact for such sums, whatever the order);
//   * Hamming (ORB): the popcount of the xor, an integer.
//
// Nearest means the least distance as a float, ties going to the lowest
// index (OpenCV's strict <): the key of a candidate is the distance's bits
// (non-negative floats order as their bits) above its index, and the nearest
// is the least key.
//
// Replaces no TPU kernel: the JAX package matches on the host with
// cv2.BFMatcher.  Bound on an H100: operations, three per byte pair of the
// Nq * Nt * D (D = 128 for SIFT, 32 for ORB); the inputs are a few hundred
// kB.  The design:
//
//   * one kernel computes a 64 x 64 tile of the distance matrix per block
//     of 256 threads (4 x 4 distances a thread); the two tiles of rows are
//     staged in shared memory as 32-bit words with a row pitch of words + 1
//     (conflict-free: the 16 query rows a warp's threads read at one word
//     fall in 16 banks); L2 takes |a - b| per byte (__vabsdiffu4) and sums
//     the squares with __dp4a, Hamming __popc of the xor;
//   * each thread reduces its 4 x 4 keys per row and per column, the block
//     reduces them in shared memory (64-bit atomicMin), and one 64-bit
//     atomicMin per row and per column of the tile goes to device memory:
//     the nearest train row of every query row and the nearest query row of
//     every train row;
//   * a second kernel applies the cross-check per query row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;          // query rows and train rows per block
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 distances each
constexpr int MAX_WORDS = 32;     // descriptors of at most 128 bytes
constexpr unsigned long long NONE = ~0ull;

template <bool HAMMING>
__device__ __forceinline__ uint32_t word_distance(uint32_t a, uint32_t b, uint32_t acc) {
  if (HAMMING) return acc + __popc(a ^ b);
  const uint32_t d = __vabsdiffu4(a, b);
  return __dp4a(d, d, acc);
}

template <bool HAMMING>
__device__ __forceinline__ unsigned long long key_of(uint32_t acc, int index) {
  const float d = HAMMING ? float(acc) : sqrtf(float(acc));
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<uint32_t>(index);
}

template <bool HAMMING>
__global__ void __launch_bounds__(THREADS)
nearest_kernel(const uint32_t* __restrict__ query, const uint32_t* __restrict__ train, int nq,
               int nt, int words, unsigned long long* __restrict__ q_best,
               unsigned long long* __restrict__ t_best) {
  __shared__ uint32_t qs[TILE * (MAX_WORDS + 1)];
  __shared__ uint32_t ts[TILE * (MAX_WORDS + 1)];
  __shared__ unsigned long long q_min[TILE], t_min[TILE];
  const int pitch = words + 1;
  const int q0 = blockIdx.y * TILE, t0 = blockIdx.x * TILE;
  for (int i = threadIdx.x; i < TILE * words; i += THREADS) {
    const int r = i / words, w = i - r * words;
    qs[r * pitch + w] = q0 + r < nq ? query[static_cast<size_t>(q0 + r) * words + w] : 0u;
    ts[r * pitch + w] = t0 + r < nt ? train[static_cast<size_t>(t0 + r) * words + w] : 0u;
  }
  if (threadIdx.x < TILE) q_min[threadIdx.x] = t_min[threadIdx.x] = NONE;
  __syncthreads();

  // thread (ty, tx): query rows ty + 16 i, train rows tx + 16 j
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  uint32_t acc[4][4] = {};
  for (int w = 0; w < words; w++) {
    uint32_t a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; i++) a[i] = qs[(ty + 16 * i) * pitch + w];
#pragma unroll
    for (int j = 0; j < 4; j++) b[j] = ts[(tx + 16 * j) * pitch + w];
#pragma unroll
    for (int i = 0; i < 4; i++)
#pragma unroll
      for (int j = 0; j < 4; j++) acc[i][j] = word_distance<HAMMING>(a[i], b[j], acc[i][j]);
  }
  unsigned long long row[4] = {NONE, NONE, NONE, NONE}, col[4] = {NONE, NONE, NONE, NONE};
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const int q = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      const int t = t0 + tx + 16 * j;
      if (q < nq && t < nt) {
        row[i] = min(row[i], key_of<HAMMING>(acc[i][j], t));
        col[j] = min(col[j], key_of<HAMMING>(acc[i][j], q));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; i++) {
    if (row[i] != NONE) atomicMin(&q_min[ty + 16 * i], row[i]);
    if (col[i] != NONE) atomicMin(&t_min[tx + 16 * i], col[i]);
  }
  __syncthreads();
  if (threadIdx.x < TILE) {
    const int r = threadIdx.x;
    if (q_min[r] != NONE) atomicMin(&q_best[q0 + r], q_min[r]);
    if (t_min[r] != NONE) atomicMin(&t_best[t0 + r], t_min[r]);
  }
}

// out[q] = q_best[q] when the nearest query row of its train row is q, else
// NONE
__global__ void cross_check_kernel(const unsigned long long* __restrict__ q_best,
                                   const unsigned long long* __restrict__ t_best, int nq,
                                   unsigned long long* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const unsigned long long k = q_best[q];
  const uint32_t t = static_cast<uint32_t>(k & 0xffffffffu);
  out[q] = static_cast<uint32_t>(t_best[t] & 0xffffffffu) == static_cast<uint32_t>(q) ? k : NONE;
}

}  // namespace

// query [nq, words], train [nt, words]: descriptor bytes as 32-bit words;
// q_best [nq] and t_best [nt] scratch; out [nq] keys (distance bits << 32 |
// train row) or ~0 for no match.  hamming: NORM_HAMMING, else NORM_L2.
extern "C" int ssp_bfmatch_launch(const void* query, const void* train, int nq, int nt,
                                  int words, int hamming, void* q_best, void* t_best, void* out,
                                  void* stream) {
  if (nq <= 0 || nt <= 0 || words <= 0 || words > MAX_WORDS) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qb = static_cast<unsigned long long*>(q_best);
  auto* tb = static_cast<unsigned long long*>(t_best);
  cudaError_t err = cudaMemsetAsync(qb, 0xff, sizeof(unsigned long long) * nq, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(tb, 0xff, sizeof(unsigned long long) * nt, st);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((nt + TILE - 1) / TILE, (nq + TILE - 1) / TILE);
  const auto* q = static_cast<const uint32_t*>(query);
  const auto* t = static_cast<const uint32_t*>(train);
  if (hamming)
    nearest_kernel<true><<<grid, THREADS, 0, st>>>(q, t, nq, nt, words, qb, tb);
  else
    nearest_kernel<false><<<grid, THREADS, 0, st>>>(q, t, nq, nt, words, qb, tb);
  cross_check_kernel<<<(nq + 255) / 256, 256, 0, st>>>(
      qb, tb, nq, static_cast<unsigned long long*>(out));
  return int(cudaGetLastError());
}
