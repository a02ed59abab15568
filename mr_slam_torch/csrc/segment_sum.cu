// Fixed-order segment sums for Hopper (sm_90a): the card's scatter-add of
// `mr_slam_torch/ops/segment.py`.
//
// Given keys sorted stably and the values' rows in the same order (M,
// cols), it adds, for every run of equal keys, the run's rows one after
// another onto a zero, and then that sum onto out[key]:
//
//   out[key][c] = out[key][c] + (((0 + v_1[c]) + v_2[c]) + ... + v_k[c])
//
// which is the order of PyTorch's sorted `index_put_(..., accumulate=True)`
// on the card for rows of 2 to 32 columns (its small-stride kernel), and,
// onto a zero base, the order of `index_add_` on the CPU. No atomics, no
// tree, and built with --fmad=false, so reruns are bit-identical and the
// sums are those of the plain version.
//
// Replaces no TPU kernel: the JAX package's `.at[slot].add` is left to
// XLA. It replaces PyTorch's `index_put_` kernels, which walk each run on
// one thread and wait on the loads of every step before its add: a run of
// 16k parked points was a chain of 16k memory round trips.
//
// Bound: the larger of the bytes (4 B a key, 4 cols a row read, 8 cols a
// slot read and written) at 3.35 TB/s, and the longest run times one
// float add's latency (4 cycles), since a column's adds are one dependent
// chain. Design:
//
//   * A warp owns the runs that start in its 32 sorted positions (grid
//     from M alone); the run heads are a ballot of key[p] != key[p - 1],
//     and a run's end is the next set bit, in this window or in a ballot
//     of the next one: no per-element scan.
//   * A run that ends there (at most 63 rows) is summed by a group of
//     `cols` lanes, a column a lane, 32 / cols groups side by side; the
//     rows of 8 positions are loaded before their adds.
//   * The one run that reaches past the next window (the parked points)
//     is summed by the whole warp: its end by a 32-way search of the
//     sorted keys, then its rows, one contiguous range, streamed through
//     shared memory in windows of 1280 floats. The 32 lanes copy
//     window t + 1 in 16-byte cp.async pieces while the `cols` lanes add
//     window t, each with the next 8 reads ahead of its adds, so a
//     window costs its adds and starting the copies, not a memory latency
//     (a 16,162-row run of 4 columns: 0.105 ms on an H100, 31 % of its
//     add-chain bound).
//
// The kernel launches on the caller's stream, allocates nothing and makes
// no host sync, so CUDA graphs capture it. A key outside [0, n) adds
// nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;    // warps a block
constexpr int kChunk = 32;   // sorted positions whose runs a warp owns
constexpr int kTile = 1280;  // floats a window of a long run holds
constexpr int kUnroll = 8;   // rows in flight a group of a short run
constexpr unsigned kFull = 0xffffffffu;

struct WarpSmem {  // a long run's window, double-buffered; +4: alignment
  alignas(16) float tile[2][kTile + 4];
};

__device__ __forceinline__ bool boundary(const int* keys, int k, int m) {
  return k >= m || k == 0 || keys[k] != keys[k - 1];
}

// Positions [h, e) of one run, column `col`, by one lane of a group.
__device__ void short_run(const int* keys, const float* vals, float* out, int h, int e, int n,
                          int cols, int col) {
  const int key = keys[h];
  if (key < 0 || key >= n) return;
  float acc = 0.f;
  for (int p = h; p < e; p += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = p + u < e ? vals[(long long)(p + u) * cols + col] : 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u < e) acc += v[u];
  }
  float* o = out + (long long)key * cols + col;
  *o = *o + acc;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The end of the run of `key` that covers sorted position lo - 1: the
// first position >= lo whose key differs, or m. Each step probes 32
// evenly spaced keys of [lo, hi) and keeps the stretch where they change.
__device__ int run_end(const int* keys, int lo, int m, int key, int lane) {
  int hi = m;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + lane * step;
    const unsigned past = __ballot_sync(kFull, q >= hi || keys[q] != key);
    if (!past) {
      lo = lo + 31 * step + 1;
      continue;
    }
    const int f = __ffs(past) - 1;
    if (f == 0) break;
    hi = min(hi, lo + f * step);
    lo = lo + (f - 1) * step + 1;
  }
  return lo;
}

// Starts the copy of the floats [f0, f0 + len) of `vals` into `tile`,
// at the tile offset with f0's 16-byte alignment, which it returns:
// 4-byte pieces up to the first 16-byte boundary and after the last one,
// 16-byte pieces between.
__device__ __forceinline__ int fetch(const float* vals, long long f0, int len, float* tile,
                                     int lane) {
  const float* src = vals + f0;
  const int off = (int)((reinterpret_cast<unsigned long long>(src) >> 2) & 3);
  const int lead = min(len, (4 - off) & 3);
  const int body = (len - lead) >> 2;
  float* dst = tile + off;
  if (lane < lead) cp_async4(dst + lane, src + lane);
#pragma unroll 1
  for (int i = lane; i < body; i += 32) cp_async16(dst + lead + 4 * i, src + lead + 4 * i);
  const int tail = lead + 4 * body + lane;
  if (tail < len) cp_async4(dst + tail, src + tail);
  return off;
}

// The run from sorted position h to wherever its key ends, by the whole
// warp, a window of kTile / cols positions at a time: window t + 1 is
// copied while window t is added.
__device__ void long_run(const int* keys, const float* vals, float* out, WarpSmem& sm, int h,
                         int m, int n, int cols, int lane) {
  const int key = keys[h];
  if (key < 0 || key >= n) return;
  const int e = run_end(keys, h + 1, m, key, lane);
  const int win = kTile / cols;
  int off = fetch(vals, (long long)h * cols, min(win, e - h) * cols, sm.tile[0], lane);
  cp_async_wait_all();
  __syncwarp();
  float acc = 0.f;
  for (int p = h, t = 0; p < e; p += win, ++t) {
    const int cur = t & 1, count = min(win, e - p);
    const int next_off = p + win < e ? fetch(vals, (long long)(p + win) * cols,
                                             min(win, e - p - win) * cols, sm.tile[cur ^ 1], lane)
                                     : 0;
    if (lane < cols) {  // window t, in order, the next 8 reads ahead of the adds
      const float* tile = sm.tile[cur] + off + lane;
      int j = 0;
      if (count >= 8) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = tile[u * cols];
        for (; j + 16 <= count; j += 8) {
          float y[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) y[u] = tile[(j + 8 + u) * cols];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc += x[u];
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = y[u];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc += x[u];
        j += 8;
      }
#pragma unroll 1
      for (; j < count; ++j) acc += tile[j * cols];
    }
    cp_async_wait_all();
    __syncwarp();
    off = next_off;
  }
  if (lane < cols) {
    float* o = out + (long long)key * cols + lane;
    *o = *o + acc;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    segment_sum_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                       float* __restrict__ out, int m, int n, int cols) {
  __shared__ WarpSmem smem[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = (blockIdx.x * kWarps + warp) * kChunk;
  if (c0 >= m) return;
  // run boundaries of this window and the next (every position >= m is one)
  const unsigned here = __ballot_sync(kFull, boundary(keys, c0 + lane, m));
  const unsigned next = __ballot_sync(kFull, boundary(keys, c0 + kChunk + lane, m));
  const unsigned starts = m - c0 >= 32 ? here : here & ((1u << (m - c0)) - 1u);
  if (!starts) return;  // the window lies inside a run that starts earlier
  const int last = 31 - __clz(starts);
  const bool last_is_long = (last == 31 || !(here >> (last + 1))) && !next;

  const int groups = 32 / cols;
  const int g = lane / cols, col = lane - g * cols;
  if (g < groups) {
    unsigned s = starts;
    for (int q = 0; q < g && s; ++q) s &= s - 1u;
    while (s) {
      const int b = __ffs(s) - 1;
      const unsigned after = b == 31 ? 0u : here >> (b + 1);
      const int end = after  ? c0 + b + __ffs(after)
                      : next ? c0 + kChunk + __ffs(next) - 1
                             : -1;  // the long run: the warp's, below
      if (end >= 0) short_run(keys, vals, out, c0 + b, end, n, cols, col);
      for (int q = 0; q < groups && s; ++q) s &= s - 1u;
    }
  }
  __syncwarp();
  if (last_is_long) {
    long_run(keys, vals, out, smem[warp], c0 + last, m, n, cols, lane);
  }
}

}  // namespace

extern "C" {

// Adds the rows of `vals` (m rows of `cols` floats, cols <= 32, in key
// order) into `out` (n rows of `cols` floats) by the sorted int32 `keys`
// (m), on `stream`. Returns the CUDA error (0 on success).
int segment_sum_launch(const void* keys, const void* vals, void* out, int m, int n, int cols,
                       void* stream) {
  if (m <= 0) return 0;
  if (cols < 1 || cols > 32) return (int)cudaErrorInvalidValue;
  const int warps = (m + kChunk - 1) / kChunk;
  const int blocks = (warps + kWarps - 1) / kWarps;
  segment_sum_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (const float*)vals, (float*)out, m, n, cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
