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
// What bounds it: bytes, src read once, idx read once and out written once
// (85 MB at the flagship's descriptor taps, 16 x 4000 x 256 into 1200).  The
// design reads each of them once and spends nothing else on the card's
// memory but a CSR of int32 (offsets [R, T+1], the order of k [R, K]) in
// scratch that the wrapper allocates.  Two launches, no host sync, no float
// atomics, so a CUDA graph captures the call:
//
//   1. sort_kernel, one block of 512 threads per row r: a counting sort of
//      the row's hits by t, made stable.  The row's t are staged in shared
//      memory (the idx loads of a thread all in flight at once); counts with
//      integer atomics (counts do not depend on order); their exclusive scan
//      (16-byte reads and writes); the hits placed with integer atomics, in
//      any order within a t; then each segment put in increasing k: a thread
//      sorts a segment of up to 16 in registers (a bitonic network), a warp
//      rewrites a longer one from a bitmap of its k, 1024 at a time.  The
//      order is built in shared memory and copied out coalesced.  A row
//      whose arrays do not fit in 192 KB of shared memory (T + 3 K past
//      about 48,000) counts in its offsets row shifted by one (placing the
//      hits leaves it as the offsets) and places into [R, K] more of
//      scratch.  Ranking the lanes of a warp that share a t as it places
//      (__match_any_sync, or a ballot per bit of t) was a serial chain per
//      warp that took longer than the sums (PERF.md).
//   2. rows_kernel: a warp takes 4 consecutive output rows, lanes over
//      channels with 16-byte loads and stores (float4, double2; single
//      elements where C or an address is not 16-byte aligned), 64 chunks of
//      channels a warp.  The 4 rows' segments lie one after another in the
//      order: the warp reads up to 32 of their k in one load, issues the
//      loads of 8 src rows before their adds, adds them in order into
//      registers that start from +0, and stores each row once at its last
//      hit; a row with no hits is stored as +0.  A long segment keeps 8
//      rows' loads in flight; its adds stay serial.  A C below 32 chunks
//      leaves lanes idle: every caller passes C = 256.  It is launched while
//      the sort runs (programmatic dependent launch) and waits for it in
//      griddepcontrol.wait.
//
// Indices outside [0, T) add nothing (callers clamp them; the plain version
// raises on them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SORT_THREADS = 512;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int SORT_SMEM_INTS = 48 * 1024;  // 192 KB: histogram, order and t of a row
constexpr int SHORT = 16;                  // longer segments are put in order by a warp
constexpr int SUM_THREADS = 256;
constexpr int UNROLL = 8;                  // src rows in flight per lane
constexpr int ROWS = 4;                    // output rows a warp sums

// exclusive scan of h[0, n) by the block, in place; returns the total.
// Each thread takes a contiguous run; VEC4: runs of whole int4 (h 16-byte
// aligned, n a multiple of 4), read and written 16 bytes at a time
template <bool VEC4>
__device__ int block_exclusive_scan(int* h, int n) {
  __shared__ int warp_sums[SORT_WARPS];
  __shared__ int total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int sum = 0, b, e;
  if (VEC4) {
    const int per = (n / 4 + SORT_THREADS - 1) / SORT_THREADS;
    b = min(n / 4, threadIdx.x * per);
    e = min(n / 4, b + per);
    const int4* h4 = reinterpret_cast<const int4*>(h);
#pragma unroll 8
    for (int i = b; i < e; i++) {
      const int4 v = h4[i];
      sum += v.x + v.y + v.z + v.w;
    }
  } else {
    const int per = (n + SORT_THREADS - 1) / SORT_THREADS;
    b = min(n, threadIdx.x * per);
    e = min(n, b + per);
    for (int i = b; i < e; i++) sum += h[i];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; w++) run += warp_sums[w];
  if (threadIdx.x == SORT_THREADS - 1) total = run + sum;
  if (VEC4) {
    int4* h4 = reinterpret_cast<int4*>(h);
#pragma unroll 8
    for (int i = b; i < e; i++) {
      const int4 v = h4[i];
      int4 o;
      o.x = run;
      o.y = o.x + v.x;
      o.z = o.y + v.y;
      o.w = o.z + v.z;
      run = o.w + v.w;
      h4[i] = o;
    }
  } else {
    for (int i = b; i < e; i++) {
      const int v = h[i];
      h[i] = run;
      run += v;
    }
  }
  __syncthreads();
  return total;
}

// dst[0, n) = src[0, n) in increasing order, n <= N: a bitonic network on
// N registers (the slots past n hold INT_MAX)
template <int N>
__device__ __forceinline__ void sort_segment(const int* src, int* dst, int n) {
  int v[N];
#pragma unroll
  for (int i = 0; i < N; i++) v[i] = i < n ? src[i] : 0x7fffffff;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < N; i++) {
        const int j = i ^ stride;
        if (j > i) {
          const int lo = min(v[i], v[j]), hi = max(v[i], v[j]);
          v[i] = (i & size) ? hi : lo;
          v[j] = (i & size) ? lo : hi;
        }
      }
#pragma unroll
  for (int i = 0; i < N; i++)
    if (i < n) dst[i] = v[i];
}

// Row r's hits as a CSR: offsets [T + 1], order [K] (the k of each hit, in
// increasing t, then k).  SHARED: the histogram h [T] (n4 ints, T rounded up
// to whole int4), each k's t, the hits placed in any order and the ordered
// ones live in shared memory, the last copied out coalesced at the end; else
// the histogram is the offsets row shifted by one (placing the hits leaves
// it as the offsets), the t are read again from idx, the hits are placed in
// spare [R, K] and ordered into order.  long_t (shared, long_cap ints)
// lists the segments longer than SHORT, and a 1024-bit map a warp follows.
template <bool SHARED>
__global__ void __launch_bounds__(SORT_THREADS)
sort_kernel(const int64_t* __restrict__ idx, int* __restrict__ offsets, int* __restrict__ order,
            int* __restrict__ spare, int K, int Tn, int n4, int long_cap) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int n_long;
  // the sums' blocks may take the free SMs now; they wait for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");
  const int r = blockIdx.x;
  const int64_t* ix = idx + static_cast<size_t>(r) * K;
  int* off = offsets + static_cast<size_t>(r) * (Tn + 1);
  int* ord_out = order + static_cast<size_t>(r) * K;
  int* h = SHARED ? smem : off + 1;
  int* ts = smem + n4;                                        // SHARED: t of each k, or -1
  int* placed = SHARED ? ts + K : spare + static_cast<size_t>(r) * K;
  int* ordered = SHARED ? ts + 2 * K : ord_out;
  int* long_t = SHARED ? ts + 3 * K : smem;
  unsigned* maps = reinterpret_cast<unsigned*>(long_t + long_cap);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto t_of = [&](int64_t v) { return v >= 0 && v < Tn ? static_cast<int>(v) : -1; };
  // each pass over k takes BATCH k a thread at once, their loads in flight
  // together (clamped: always a valid address)
  constexpr int BATCH = 8;
  auto t_batch = [&](int k0, int (&t)[BATCH]) {
    if (SHARED) {
#pragma unroll
      for (int u = 0; u < BATCH; u++) t[u] = ts[min(k0 + u * SORT_THREADS, K - 1)];
    } else {
      int64_t v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; u++) v[u] = ix[min(k0 + u * SORT_THREADS, K - 1)];
#pragma unroll
      for (int u = 0; u < BATCH; u++) t[u] = t_of(v[u]);
    }
#pragma unroll
    for (int u = 0; u < BATCH; u++)
      if (k0 + u * SORT_THREADS >= K) t[u] = -1;
  };

  if (SHARED) {
    for (int k0 = threadIdx.x; k0 < K; k0 += BATCH * SORT_THREADS) {
      int64_t v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; u++) v[u] = ix[min(k0 + u * SORT_THREADS, K - 1)];
#pragma unroll
      for (int u = 0; u < BATCH; u++)
        if (k0 + u * SORT_THREADS < K) ts[k0 + u * SORT_THREADS] = t_of(v[u]);
    }
  }
  for (int i = threadIdx.x; i < (SHARED ? n4 : Tn); i += SORT_THREADS) h[i] = 0;
  if (threadIdx.x == 0) {
    n_long = 0;
    if (!SHARED) off[0] = 0;
  }
  __syncthreads();
  // counts, then their exclusive scan: h[t] = where t's hits start
  for (int k0 = threadIdx.x; k0 < K; k0 += BATCH * SORT_THREADS) {
    int t[BATCH];
    t_batch(k0, t);
#pragma unroll
    for (int u = 0; u < BATCH; u++)
      if (t[u] >= 0) atomicAdd(&h[t[u]], 1);
  }
  __syncthreads();
  const int total = block_exclusive_scan<SHARED>(h, SHARED ? n4 : Tn);
  if (SHARED) {
    for (int t = threadIdx.x; t < Tn; t += SORT_THREADS) off[t] = h[t];
    if (threadIdx.x == 0) off[Tn] = total;
    __syncthreads();  // the starts read before the placing moves them
  }
  // placed in any order (atomics); after it h[t] is where t's hits end
  for (int k0 = threadIdx.x; k0 < K; k0 += BATCH * SORT_THREADS) {
    int t[BATCH], pos[BATCH];
    t_batch(k0, t);
#pragma unroll
    for (int u = 0; u < BATCH; u++) pos[u] = t[u] >= 0 ? atomicAdd(&h[t[u]], 1) : 0;
#pragma unroll
    for (int u = 0; u < BATCH; u++)
      if (t[u] >= 0) placed[pos[u]] = k0 + u * SORT_THREADS;
  }
  __syncthreads();
  // in order: a thread sorts each short segment in registers (a sorting
  // network of 8 or 16); the long ones are listed for the warps below
  for (int t = threadIdx.x; t < Tn; t += SORT_THREADS) {
    const int b = t ? h[t - 1] : 0, n = h[t] - b;
    if (n <= 1) {
      if (n == 1) ordered[b] = placed[b];
    } else if (n <= 8)
      sort_segment<8>(placed + b, ordered + b, n);
    else if (n <= SHORT)
      sort_segment<SHORT>(placed + b, ordered + b, n);
    else
      long_t[atomicAdd(&n_long, 1)] = t;
  }
  __syncthreads();
  // a long segment, 1024 k at a time: its k in the window as a bitmap,
  // whose set bits the lanes write out in order (their counts scanned)
  unsigned* bm = maps + 32 * warp;
  for (int i = warp; i < n_long; i += SORT_WARPS) {
    const int t = long_t[i];
    const int b = t ? h[t - 1] : 0, e = h[t];
    int pos = b;
    for (int w0 = 0; w0 < K; w0 += 1024) {
      bm[lane] = 0u;
      __syncwarp();
      for (int j = b + lane; j < e; j += 32) {
        const int d = placed[j] - w0;
        if (d >= 0 && d < 1024) atomicOr(&bm[d >> 5], 1u << (d & 31));
      }
      __syncwarp();
      unsigned word = bm[lane];
      const int c = __popc(word);
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      for (int p = pos + incl - c; word; word &= word - 1u)
        ordered[p++] = w0 + 32 * lane + __ffs(word) - 1;
      pos += __shfl_sync(0xffffffffu, incl, 31);
      __syncwarp();
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < total; i += SORT_THREADS) ord_out[i] = ordered[i];
  }
}

template <typename S, int VEC> struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<double, 2> { using type = double2; };

__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ double vzero(double) { return 0.0; }
__device__ __forceinline__ float4 vzero(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ double2 vzero(double2) { return make_double2(0.0, 0.0); }
__device__ __forceinline__ float vadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double vadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ double2 vadd(double2 a, double2 b) {
  return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
}

// The sums: warp gw takes channel tile gw % c_tiles
// of ROWS consecutive output rows t0 .. of one row r; a lane holds NCH
// chunks of VEC channels, chunk ct * 32 * NCH + q * 32 + lane.  The rows'
// segments lie one after another in the order, so the warp walks their hits
// as one list: one coalesced load of up to 32 k, the src rows of 8 hits
// loaded before their adds, one sum in registers stored (and restarted from
// +0) at the end of each row's hits; a row with no hits is stored as +0
// first.  Lanes whose chunk lies past C load chunk 0 and store nothing.
template <typename S, int VEC, int NCH>
__global__ void __launch_bounds__(SUM_THREADS)
rows_kernel(const S* __restrict__ src, const int* __restrict__ offsets,
            const int* __restrict__ order, S* __restrict__ out, int R, int K, int Tn, int C,
            int c_tiles, int groups) {
  using V = typename Vec<S, VEC>::type;
  const long long gw = (static_cast<long long>(blockIdx.x) * SUM_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int ct = static_cast<int>(gw % c_tiles);
  const long long g = gw / c_tiles;
  const int r = static_cast<int>(g / groups), t0 = static_cast<int>(g % groups) * ROWS;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the sort's CSR
  if (r >= R) return;
  const int nr = min(ROWS, Tn - t0), pitch = C / VEC;
  int chunk[NCH];
  bool ok[NCH];
#pragma unroll
  for (int q = 0; q < NCH; q++) {
    chunk[q] = ct * 32 * NCH + q * 32 + lane;
    ok[q] = chunk[q] < pitch;
    if (!ok[q]) chunk[q] = 0;
  }
  // lane l <= nr: where row t0 + l's hits start (lane nr: where the last ends)
  // (the sort's output is read with plain loads: the read-only path is for
  // data that no grid writes while this one runs, and the sort may)
  const int ov = offsets[static_cast<size_t>(r) * (Tn + 1) + t0 + min(lane, nr)];
  const int base = __shfl_sync(0xffffffffu, ov, 0), n = __shfl_sync(0xffffffffu, ov, nr) - base;
  const int next = __shfl_down_sync(0xffffffffu, ov, 1);
  V* o = reinterpret_cast<V*>(out + (static_cast<size_t>(r) * Tn + t0) * C);
  const unsigned empty = __ballot_sync(0xffffffffu, lane < nr && next == ov);
  for (unsigned m = empty; m; m &= m - 1u)
#pragma unroll
    for (int q = 0; q < NCH; q++)
      if (ok[q]) o[static_cast<size_t>(__ffs(m) - 1) * pitch + chunk[q]] = vzero(V());
  const int* ord = order + static_cast<size_t>(r) * K + base;
  const V* s = reinterpret_cast<const V*>(src + static_cast<size_t>(r) * K * C);
  V acc[NCH];
#pragma unroll
  for (int q = 0; q < NCH; q++) acc[q] = vzero(V());
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int kv = ord[min(j0 + lane, n - 1)];
    const int here = min(32, n - j0);
    for (int j1 = 0; j1 < here; j1 += UNROLL) {
      V x[UNROLL][NCH];
#pragma unroll
      for (int u = 0; u < UNROLL; u++) {
        const int k = __shfl_sync(0xffffffffu, kv, min(j1 + u, here - 1));
#pragma unroll
        for (int q = 0; q < NCH; q++)
          x[u][q] = __ldg(s + static_cast<long long>(k) * pitch + chunk[q]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; u++) {
        const int j = j0 + j1 + u;
        if (j >= n) break;
#pragma unroll
        for (int q = 0; q < NCH; q++) acc[q] = vadd(acc[q], x[u][q]);
        // the last hit of its row: the lowest lane l >= 1 whose row starts
        // past it ends row l - 1
        const unsigned ends =
            __ballot_sync(0xffffffffu, lane >= 1 && lane <= nr && ov - base == j + 1);
        if (ends) {
          const int row = __ffs(ends) - 2;
#pragma unroll
          for (int q = 0; q < NCH; q++) {
            if (ok[q]) o[static_cast<size_t>(row) * pitch + chunk[q]] = acc[q];
            acc[q] = vzero(V());
          }
        }
      }
    }
  }
}

template <typename S, int VEC>
int launch_sums(const S* src, const int* offsets, const int* order, S* out, int R, int K, int Tn,
                int C, cudaStream_t stream) {
  const int chunks = C / VEC;
  const int c_tiles = (chunks + 63) / 64, groups = (Tn + ROWS - 1) / ROWS;
  const long long warps = static_cast<long long>(R) * groups * c_tiles;
  const long long blocks = (warps * 32 + SUM_THREADS - 1) / SUM_THREADS;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  // launched while the sort runs (programmatic dependent launch): its
  // blocks wait in griddepcontrol.wait for the sort's end and its writes
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(blocks));
  cfg.blockDim = dim3(SUM_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      chunks > 32 ? cudaLaunchKernelEx(&cfg, rows_kernel<S, VEC, 2>, src, offsets, order, out, R, K,
                                       Tn, C, c_tiles, groups)
                  : cudaLaunchKernelEx(&cfg, rows_kernel<S, VEC, 1>, src, offsets, order, out, R, K,
                                       Tn, C, c_tiles, groups);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

// shared ints the sort needs besides the row's arrays: the long segments'
// list and the warps' maps
int sort_small(int K) { return K / (SHORT + 1) + 1 + 32 * SORT_WARPS; }

// whether a row's histogram, t, placed and ordered hits fit in shared memory
bool sort_shared(int K, int Tn) {
  return static_cast<long long>((Tn + 3) & ~3) + 3LL * K + sort_small(K) <= SORT_SMEM_INTS;
}

template <typename S>
int launch(const void* src, const void* idx, void* out, int* offsets, int* order, int* spare,
           int R, int K, int Tn, int C, cudaStream_t stream) {
  const int n4 = (Tn + 3) & ~3;
  const bool shared = sort_shared(K, Tn);
  const size_t smem = sizeof(int) * ((shared ? n4 + 3 * K : 0) + sort_small(K));
  if (smem > 48 * 1024) {  // the opt-in above the default 48 KB, once per device
    static int allowed[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 64 && allowed[dev] == 0) {
      cudaError_t e = cudaFuncSetAttribute(sort_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(sizeof(int) * SORT_SMEM_INTS));
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(sort_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(sizeof(int) * SORT_SMEM_INTS));
      if (e != cudaSuccess) return int(e);
      allowed[dev] = 1;
    }
  }
  if (sort_small(K) > SORT_SMEM_INTS) return int(cudaErrorInvalidValue);
  const auto* ix = static_cast<const int64_t*>(idx);
  const int long_cap = K / (SHORT + 1) + 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(R));
  cfg.blockDim = dim3(SORT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaError_t err = shared ? cudaLaunchKernelEx(&cfg, sort_kernel<true>, ix, offsets, order, spare,
                                                K, Tn, n4, long_cap)
                           : cudaLaunchKernelEx(&cfg, sort_kernel<false>, ix, offsets, order, spare,
                                                K, Tn, n4, long_cap);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  constexpr int V16 = 16 / sizeof(S);
  const auto* s = static_cast<const S*>(src);
  auto* o = static_cast<S*>(out);
  const bool vec16 = C % V16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec16 ? launch_sums<S, V16>(s, offsets, order, o, R, K, Tn, C, stream)
               : launch_sums<S, 1>(s, offsets, order, o, R, K, Tn, C, stream);
}

}  // namespace

// int32 scratch that ssp_ordered_scatter_launch needs: offsets [R, T + 1]
// and the order [R, K], and [R, K] more where a row does not fit in shared
// memory
extern "C" long long ssp_ordered_scatter_scratch(int R, int K, int T) {
  return static_cast<long long>(R) * (T + 1 + K + (sort_shared(K, T) ? 0 : K));
}

// src [R, K, C] and out [R, T, C] contiguous float32 (dtype 0) or float64
// (dtype 1), idx [R, K] contiguous int64; scratch: the ints that
// ssp_ordered_scatter_scratch(R, K, T) asks for.  Two launches on the
// stream.  Returns a CUDA error code.
extern "C" int ssp_ordered_scatter_launch(const void* src, const void* idx, void* out,
                                          void* scratch, int R, int K, int T, int C, int dtype,
                                          void* stream) {
  if (R <= 0 || K <= 0 || T <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* off = static_cast<int*>(scratch);
  auto* ord = off + static_cast<size_t>(R) * (T + 1);
  auto* spare = ord + static_cast<size_t>(R) * K;
  if (dtype == 0) return launch<float>(src, idx, out, off, ord, spare, R, K, T, C, s);
  if (dtype == 1) return launch<double>(src, idx, out, off, ord, spare, R, K, T, C, s);
  return int(cudaErrorInvalidValue);
}
