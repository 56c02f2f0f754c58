// Ordered scatter-add: the backward of a gather along one axis, summed in a
// fixed order.
//
//   out[r, t, c] = sum over k with idx[r, k] == t of src[r, k, c]
//
// with src [R, K, C], idx [R, K] (int64) and out [R, T, C].  Each sum starts
// from +0 and adds its terms in increasing k, one rounding at a time: the
// result is that of a serial scatter_add_ into zeros (PyTorch's CPU kernel),
// bit for bit, and it is the same from run to run.  CUDA's own backward of a
// gather adds with atomicAdd, whose order, and so whose rounding, changes
// between runs wherever two k of a row hit the same t.
//
// Replaces no TPU kernel: the JAX package's training gathers are one-hot
// products or XLA scatters, both deterministic on a TPU.  The training path
// runs it in the sparse descriptor loss's backward: the bilinear taps of each
// view (R = batch, K = 4 taps x samples, C = 256, T = cells) and the match
// rows (K = samples).
//
// No host sync, no sort, no atomics, so a CUDA graph captures it.  One block
// of 256 threads per tile of nt outputs t by cw <= 256 channels of a row, the
// sums in shared memory (32 KB).  Thread (g, c) owns channel c of t = t0 + g,
// g + G, ... (G = 256 / cw; with C = 256 every thread owns one channel of
// every t).  The block walks k in rounds of 256: each thread reads one index
// (the next round's read ahead), the tile's hits are compacted into a list
// in increasing k (a warp ballot and the warps' counts), and each thread adds
// the src rows of its own hits in list order, four rows' loads in flight
// before their adds; a warp's 32 channels of a row are one 128-byte line.
// The sums are written once, coalesced along c.  Every thread looks at every
// hit of its tile, which costs G times the hits: cheap for the training
// path's rows of 256 channels, not for narrow ones (C = 1 looks at each hit
// 256 times), which no path of the port gives it.
//
// A t that nothing hits writes the +0 its sum started from.  What bounds it:
// bytes, src read once and out written once (each tile also reads its row's
// K indices, from L2 after the first).  Indices outside [0, T) add nothing
// (callers clamp them; the plain version raises on them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ACC_BYTES = 32 * 1024;  // the shared sums

template <typename T>
__global__ void __launch_bounds__(THREADS)
sums_kernel(const T* __restrict__ src, const int64_t* __restrict__ idx, T* __restrict__ out,
            int K, int Tn, int C, int cw, int nt, int t_tiles, int c_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = reinterpret_cast<T*>(smem);                         // [nt][cw]
  int* hit_k = reinterpret_cast<int*>(smem + sizeof(T) * nt * cw);  // [THREADS]
  int* hit_t = hit_k + THREADS;                                // [THREADS], t - t0
  __shared__ int warp_hits[WARPS];

  int b = blockIdx.x;
  const int ct = b % c_tiles;
  b /= c_tiles;
  const int r = b / t_tiles;
  const int t0 = (b - r * t_tiles) * nt, c0 = ct * cw;
  const int nt_here = min(nt, Tn - t0), cw_here = min(cw, C - c0);
  const int G = THREADS / cw;
  const int g = threadIdx.x / cw, c = threadIdx.x - g * cw;
  const bool active = g < G && c < cw_here;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < nt * cw; i += THREADS) acc[i] = T(0);
  const int64_t* ix = idx + static_cast<size_t>(r) * K;
  const T* s = src + static_cast<size_t>(r) * K * C + c0 + c;
  T* a = acc + c;

  int64_t v_next = threadIdx.x < K ? ix[threadIdx.x] : -1;
  for (int k0 = 0; k0 < K; k0 += THREADS) {
    const int k = k0 + threadIdx.x;
    const int64_t tl = v_next - t0;
    v_next = k + THREADS < K ? ix[k + THREADS] : -1;
    const bool hit = k < K && tl >= 0 && tl < nt_here;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();  // the counts; the sums zeroed; the last round's list consumed
    int base = 0, m = 0;
#pragma unroll
    for (int w = 0; w < WARPS; w++) {
      const int n = warp_hits[w];
      base += w < warp ? n : 0;
      m += n;
    }
    if (hit) {
      const int pos = base + __popc(mask & ((1u << lane) - 1u));
      hit_k[pos] = k;
      hit_t[pos] = static_cast<int>(tl);
    }
    __syncthreads();  // the list
    if (!active) continue;
    if (G == 1) {
      int i = 0;
      for (; i + 4 <= m; i += 4) {  // four loads in flight, then the adds in order
        const T x0 = s[static_cast<size_t>(hit_k[i]) * C];
        const T x1 = s[static_cast<size_t>(hit_k[i + 1]) * C];
        const T x2 = s[static_cast<size_t>(hit_k[i + 2]) * C];
        const T x3 = s[static_cast<size_t>(hit_k[i + 3]) * C];
        a[hit_t[i] * cw] += x0;
        a[hit_t[i + 1] * cw] += x1;
        a[hit_t[i + 2] * cw] += x2;
        a[hit_t[i + 3] * cw] += x3;
      }
      for (; i < m; i++) a[hit_t[i] * cw] += s[static_cast<size_t>(hit_k[i]) * C];
    } else {
      for (int i = 0; i < m; i++) {
        const int t = hit_t[i];
        if (t % G == g) a[t * cw] += s[static_cast<size_t>(hit_k[i]) * C];
      }
    }
  }
  __syncthreads();
  if (!active) return;
  T* o = out + (static_cast<size_t>(r) * Tn + t0) * C + c0 + c;
  for (int t = g; t < nt_here; t += G) o[static_cast<size_t>(t) * C] = a[t * cw];
}

template <typename T>
int launch(const void* src, const void* idx, void* out, int R, int K, int Tn, int C,
           cudaStream_t stream) {
  auto s = static_cast<const T*>(src);
  auto i = static_cast<const int64_t*>(idx);
  auto o = static_cast<T*>(out);
  const int cw = C < THREADS ? C : THREADS;
  int nt = ACC_BYTES / static_cast<int>(sizeof(T) * cw);
  nt = nt < Tn ? nt : Tn;
  const int t_tiles = (Tn + nt - 1) / nt, c_tiles = (C + cw - 1) / cw;
  const size_t blocks = static_cast<size_t>(R) * t_tiles * c_tiles;
  const size_t smem = sizeof(T) * nt * cw + 2 * sizeof(int) * THREADS;
  if (blocks > 0x7fffffffu || smem > 48 * 1024) return int(cudaErrorInvalidValue);
  sums_kernel<T><<<unsigned(blocks), THREADS, smem, stream>>>(s, i, o, K, Tn, C, cw, nt,
                                                               t_tiles, c_tiles);
  return int(cudaGetLastError());
}

}  // namespace

// src [R, K, C] and out [R, T, C] contiguous float32 (dtype 0) or float64
// (dtype 1), idx [R, K] contiguous int64.  Returns a CUDA error code.
extern "C" int ssp_ordered_scatter_launch(const void* src, const void* idx, void* out, int R,
                                          int K, int T, int C, int dtype, void* stream) {
  if (R <= 0 || K <= 0 || T <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, idx, out, R, K, T, C, s);
  if (dtype == 1) return launch<double>(src, idx, out, R, K, T, C, s);
  return int(cudaErrorInvalidValue);
}
