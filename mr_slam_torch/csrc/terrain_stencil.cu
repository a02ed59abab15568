// Fused 5x5 terrain-feature stencil for Hopper (sm_90a), with the window
// moments computed separably in shared memory.
//
// Replaces the TPU kernel mr_slam_tpu/ops/pallas_stencil.py::_kernel
// (pallas_call at pallas_stencil.py:178, driven by terrain_features
// :152 from mapping/elevation.features_fused). It computes the function
// of the port's plain version (mr_slam_torch/ops/hopper_stencil.py::
// terrain_features_plain), not a copy of the Pallas body's row stripes,
// DMA windows and rolls: per cell, over its 5x5 window,
//
//   * ten moments of the valid cells (1, u, w, uu, ww, uw, z, uz, wz,
//     zz) in window-local integer cell offsets (u, w) = (di, dj) about
//     the centre cell (the reference's absolute coordinates cancel in
//     float32 on wide maps); out-of-grid cells add nothing;
//   * the closed-form plane fit from n-scaled central moments, whose xy
//     part is integer-valued and exact (collinear windows are exactly
//     singular), scaled by the resolution -> slope and residual
//     roughness, with the reference's |det| < 1e-9 m^4 floor;
//   * step = max - min over the window: the max over in-grid cells with
//     z = 0 for invalid ones (out-of-grid cells are -inf, as the
//     reference's -inf padded 3x3 dilations), the min over valid cells;
//   * the enough (>= 3 valid cells) and centre-valid flags, atanf and
//     the traversability blend — inside the kernel (the Pallas kernel
//     left atan outside only because it has no Pallas TPU lowering).
//
// Bound: the bytes. It must read 5 B per cell (height f32, valid u8) and
// write 16 B (four f32 layers), 21 B in all: 88 MB at 2048^2, 352 MB at
// 4096^2, 26 us / 105 us at the H100's 3.35 TB/s.
//
// Design. Walking all 25 neighbours costs ~600 f32 operations per cell
// (ten multiply-adds each, no FMA contraction), which made the first
// version bound by instruction throughput at ~18 % of the HBM bound. Here, as in the Pallas
// kernel's own row-then-column box sums, the moments are separable:
//
//   1. Tiles of 32 x 32 cells; a block of 32 x 8 threads. The grid is
//      persistent (as many blocks as the card holds at once, each
//      walking tiles at a stride of the grid), so that the next tile's
//      halo (36 rows, 40 columns so that rows stay 16-byte aligned; a
//      41 % halo overhead, served from L2) is in flight with cp.async
//      while the current one is computed. Tiles at the left and right
//      edges, and grids whose rows are not 16-byte aligned, load their
//      halo with scalar loads instead. The halo is stored as what the
//      taps need: four arrays v, z (0 for an invalid cell), the max's z
//      and the min's z.
//   2. Horizontal pass: for each of the 36 halo rows, the 5-wide row
//      sums A0 = sum v, A1 = sum v w, A2 = sum v w^2, Az = sum z, Awz =
//      sum w z, Azz = sum z^2 and the row max and min of the 32 output
//      columns, two adjacent columns per item from their six taps
//      (float2 loads, no bank conflicts), into shared memory. A0, A1 and
//      A2 are small integers, exact in any order, so they are formed
//      directly; Az, Awz and Azz follow the plain version's order (w
//      ascending); the two items share the extrema of their middle taps.
//   3. Vertical pass: each thread owns a column strip of 4 cells; it
//      reads the 8 row-sum rows the strip needs once and adds each to
//      the cells it belongs to with the u weights (S1 = sum A0, Su =
//      sum u A0, Suu = sum u^2 A0, Sw = sum A1, Suw = sum u A1, Sww =
//      sum A2, Sz = sum Az, Suz = sum u Az, Swz = sum Awz, Szz = sum
//      Azz, max and min over the five rows), u ascending for every cell.
//      A term whose weight is 0 is not added (in both passes).
//   4. The closed form, atanf and the blend, unchanged. The extrema use
//      the NaN-propagating max.NaN / min.NaN instructions.
//
// About 300 instructions per cell, of which the closed form's five IEEE
// divisions, two square roots and atanf are about half; ~66 KB of shared
// memory and at most 80 registers a thread keep three blocks on an SM.
// No atomics: a rerun is bit-identical.
//
// Numerics: built with --fmad=false and evaluating every inexact
// product, sum and division in the plain version's order (row sums w
// ascending, then the rows u ascending, zero-weight terms skipped in
// both; the closed form step by step), so the kernel and the plain
// version agree bit for bit on the card wherever the math library's
// atanf agrees with PyTorch's; step, the six xy moments and the flags
// are exact in any case. The blend multiplies by the float32 reciprocals of
// the critical values the wrapper passes, as the plain version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 2;
constexpr int kTile = 32;                 // output rows and columns per block
constexpr int kThreadsX = 32;             // one column each
constexpr int kThreadsY = 8;              // column strips
constexpr int kStrip = kTile / kThreadsY; // cells per thread, down a column
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kS = kTile + 2 * kHalo;     // halo tile rows, 36
constexpr int kW = kTile + 8;             // halo tile columns jb-4 .. jb+35, 40
constexpr int kVec = kW / 4;              // float4 loads per aligned halo row, 10
constexpr int kPairs = kTile / 2;         // output column pairs per row in the horizontal pass
constexpr float kDetFloor = 1e-9f;

// torch.maximum / torch.minimum semantics: NaN in, NaN out.
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Halo column c of a tile holds grid column jb - 4 + c; an output
// column x has its taps in halo columns x + 2 .. x + 6.
struct Shared {
  float v[kS][kW];          // 1 for a valid cell, else 0
  float z[kS][kW];          // height of a valid cell, else 0
  float zmx[kS][kW];        // the max's z: z in the grid, -inf outside
  float zmn[kS][kW];        // the min's z: z for a valid cell, else +inf
  float rs[8][kS][kTile];   // row sums A0, A1, A2, Az, Awz, Azz, row max, row min
  float stage_h[kS][kW];    // the next tile's heights, in flight (cp.async)
  uint8_t stage_v[kS][kW];  // the next tile's valid flags, in flight
};

__device__ __forceinline__ void cell(bool in, bool ok, float h, float& v, float& z, float& zmx,
                                     float& zmn) {
  z = ok ? h : 0.f;
  v = ok ? 1.f : 0.f;
  zmx = in ? z : -INFINITY;
  zmn = ok ? z : INFINITY;
}

// cp.async of 16 / 4 bytes; `n` = 0 copies nothing and zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

struct Grid {
  int H, W, tiles_x, n_tiles;
  bool aligned;
  // a tile whose 40 halo columns lie in the grid, in a grid whose rows
  // are 16-byte aligned: its halo streams in with cp.async
  __device__ bool streams(int t) const {
    const int jh = (t % tiles_x) * kTile - 4;
    return aligned && jh >= 0 && jh + kW <= W;
  }
};

// Starts the copy of tile t's halo rows (out-of-grid rows zero-filled)
// into the staging buffers.
__device__ __forceinline__ void prefetch(Shared& s, const Grid& g, int t, int tid,
                                         const float* __restrict__ height,
                                         const uint8_t* __restrict__ valid) {
  const int i0 = (t / g.tiles_x) * kTile - kHalo, jh = (t % g.tiles_x) * kTile - 4;
  for (int k = tid; k < kS * kVec; k += kThreads) {
    const int r = k / kVec, c = 4 * (k % kVec);
    const int i = i0 + r;
    const bool in = i >= 0 && i < g.H;
    const size_t p = (size_t)(in ? i : 0) * g.W + jh + c;
    cp_async16(&s.stage_h[r][c], height + p, in ? 16 : 0);
    cp_async4(&s.stage_v[r][c], valid + p, in ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 3)
terrain_kernel(const float* __restrict__ height,   // (H, W)
               const uint8_t* __restrict__ valid,  // (H, W) 0/1
               const float* __restrict__ res_ptr,  // () metres per cell
               Grid g, float inv_slope, float inv_rough, float inv_step,
               float* __restrict__ slope_out, float* __restrict__ rough_out,
               float* __restrict__ step_out, float* __restrict__ trav_out) {
  extern __shared__ float4 smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const float res = *res_ptr;
  const float r2 = res * res;
  const float r4 = r2 * r2;

  // persistent: tiles blockIdx.x, + gridDim.x, ...; the next tile's halo
  // is in flight while this one is computed
  if ((int)blockIdx.x < g.n_tiles && g.streams(blockIdx.x))
    prefetch(s, g, blockIdx.x, tid, height, valid);
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const int ib = (t / g.tiles_x) * kTile, jb = (t % g.tiles_x) * kTile;
    const int i0 = ib - kHalo, jh = jb - 4;

    // 1. the halo tile, from the staging buffers or straight from the grid
    if (g.streams(t)) {
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
      for (int k = tid; k < kS * kVec; k += kThreads) {
        const int r = k / kVec, c = 4 * (k % kVec);
        const bool in = i0 + r >= 0 && i0 + r < g.H;
        const float4 h4 = *reinterpret_cast<const float4*>(&s.stage_h[r][c]);
        const uchar4 v4 = *reinterpret_cast<const uchar4*>(&s.stage_v[r][c]);
        float4 v, z, zmx, zmn;
        cell(in, in && v4.x, h4.x, v.x, z.x, zmx.x, zmn.x);
        cell(in, in && v4.y, h4.y, v.y, z.y, zmx.y, zmn.y);
        cell(in, in && v4.z, h4.z, v.z, z.z, zmx.z, zmn.z);
        cell(in, in && v4.w, h4.w, v.w, z.w, zmx.w, zmn.w);
        *reinterpret_cast<float4*>(&s.v[r][c]) = v;
        *reinterpret_cast<float4*>(&s.z[r][c]) = z;
        *reinterpret_cast<float4*>(&s.zmx[r][c]) = zmx;
        *reinterpret_cast<float4*>(&s.zmn[r][c]) = zmn;
      }
    } else {
      for (int k = tid; k < kS * kW; k += kThreads) {
        const int r = k / kW, c = k % kW;
        const int i = i0 + r, j = jh + c;
        const bool in = i >= 0 && i < g.H && j >= 0 && j < g.W;
        bool ok = false;
        float h = 0.f;
        if (in) {
          const size_t p = (size_t)i * g.W + j;
          ok = __ldg(valid + p) != 0;
          h = __ldg(height + p);
        }
        cell(in, ok, h, s.v[r][c], s.z[r][c], s.zmx[r][c], s.zmn[r][c]);
      }
    }
    __syncthreads();
    const int tn = t + gridDim.x;  // the staging buffers are free again
    if (tn < g.n_tiles && g.streams(tn)) prefetch(s, g, tn, tid, height, valid);

    // 2. horizontal pass: 5-wide row sums of two adjacent output columns
    // per item, from their six taps (three float2 loads per array). The
    // integer sums A0, A1, A2 are exact in any order; Az, Awz, Azz follow
    // the plain version's order (w ascending, zero weight skipped); the
    // extrema share the four middle taps.
    for (int k = tid; k < kS * kPairs; k += kThreads) {
      const int r = k / kPairs, x = 2 * (k % kPairs);
      float tv[6], tz[6], tmx[6], tmn[6];
#pragma unroll
      for (int e = 0; e < 6; e += 2) {
        const float2 a = *reinterpret_cast<const float2*>(&s.v[r][x + 2 + e]);
        const float2 b = *reinterpret_cast<const float2*>(&s.z[r][x + 2 + e]);
        const float2 c = *reinterpret_cast<const float2*>(&s.zmx[r][x + 2 + e]);
        const float2 d = *reinterpret_cast<const float2*>(&s.zmn[r][x + 2 + e]);
        tv[e] = a.x; tv[e + 1] = a.y;
        tz[e] = b.x; tz[e + 1] = b.y;
        tmx[e] = c.x; tmx[e + 1] = c.y;
        tmn[e] = d.x; tmn[e + 1] = d.y;
      }
      float zz[6];
#pragma unroll
      for (int e = 0; e < 6; ++e) zz[e] = tz[e] * tz[e];
      const float v14 = (tv[1] + tv[2]) + (tv[3] + tv[4]);
      const float mx14 = nan_max(nan_max(tmx[1], tmx[2]), nan_max(tmx[3], tmx[4]));
      const float mn14 = nan_min(nan_min(tmn[1], tmn[2]), nan_min(tmn[3], tmn[4]));
      float out[8][2];
      out[0][0] = tv[0] + v14;
      out[0][1] = v14 + tv[5];
      out[1][0] = (tv[4] - tv[0]) * 2.f + (tv[3] - tv[1]);
      out[1][1] = (tv[5] - tv[1]) * 2.f + (tv[4] - tv[2]);
      out[2][0] = (tv[0] + tv[4]) * 4.f + (tv[1] + tv[3]);
      out[2][1] = (tv[1] + tv[5]) * 4.f + (tv[2] + tv[4]);
      out[6][0] = nan_max(tmx[0], mx14);
      out[6][1] = nan_max(mx14, tmx[5]);
      out[7][0] = nan_min(tmn[0], mn14);
      out[7][1] = nan_min(mn14, tmn[5]);
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        float Az = 0.f, Awz = 0.f, Azz = 0.f;
#pragma unroll
        for (int dw = -kHalo; dw <= kHalo; ++dw) {
          const int e = o + dw + kHalo;
          Az = Az + tz[e];
          if (dw != 0) Awz = Awz + tz[e] * (float)dw;
          Azz = Azz + zz[e];
        }
        out[3][o] = Az;
        out[4][o] = Awz;
        out[5][o] = Azz;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        *reinterpret_cast<float2*>(&s.rs[q][r][x]) = make_float2(out[q][0], out[q][1]);
    }
    __syncthreads();

    // 3. vertical pass over a strip of kStrip cells: halo rows r0 .. r0+kStrip+3
    const int r0 = ty * kStrip;
    float S1[kStrip], Su[kStrip], Sw[kStrip], Suu[kStrip], Sww[kStrip];
    float Suw[kStrip], Sz[kStrip], Suz[kStrip], Swz[kStrip], Szz[kStrip];
    float zmax[kStrip], zmin[kStrip];
#pragma unroll
    for (int m = 0; m < kStrip; ++m) {
      S1[m] = Su[m] = Sw[m] = Suu[m] = Sww[m] = 0.f;
      Suw[m] = Sz[m] = Suz[m] = Swz[m] = Szz[m] = 0.f;
      zmax[m] = -INFINITY;
      zmin[m] = INFINITY;
    }
#pragma unroll
    for (int k = 0; k < kStrip + 2 * kHalo; ++k) {
      const int r = r0 + k;
      const float A0 = s.rs[0][r][tx], A1 = s.rs[1][r][tx], A2 = s.rs[2][r][tx];
      const float Az = s.rs[3][r][tx], Awz = s.rs[4][r][tx], Azz = s.rs[5][r][tx];
      const float mx = s.rs[6][r][tx], mn = s.rs[7][r][tx];
#pragma unroll
      for (int m = 0; m < kStrip; ++m) {
        const int du = k - m - kHalo;  // this row's offset from cell m's row
        if (du < -kHalo || du > kHalo) continue;
        const float u = (float)du;
        S1[m] = S1[m] + A0;
        if (du != 0) {
          const float ua0 = u * A0;
          Su[m] = Su[m] + ua0;
          Suu[m] = Suu[m] + ua0 * u;
          Suw[m] = Suw[m] + u * A1;
          Suz[m] = Suz[m] + u * Az;
        }
        Sw[m] = Sw[m] + A1;
        Sww[m] = Sww[m] + A2;
        Sz[m] = Sz[m] + Az;
        Swz[m] = Swz[m] + Awz;
        Szz[m] = Szz[m] + Azz;
        zmax[m] = nan_max(zmax[m], mx);
        zmin[m] = nan_min(zmin[m], mn);
      }
    }

    // 4. closed form and blend, per cell of the strip
    const int j = jb + tx;
#pragma unroll
    for (int m = 0; m < kStrip; ++m) {
      const int i = ib + r0 + m;
      if (i >= g.H || j >= g.W) break;
      // n-scaled central moments; the xy part is integer-valued and exact
      const float n = nan_max(S1[m], 1.f);
      const float Cuu = n * Suu[m] - Su[m] * Su[m];
      const float Cww = n * Sww[m] - Sw[m] * Sw[m];
      const float Cuw = n * Suw[m] - Su[m] * Sw[m];
      const float Cuz = n * Suz[m] - Su[m] * Sz[m];
      const float Cwz = n * Swz[m] - Sw[m] * Sz[m];
      const float Czz = n * Szz[m] - Sz[m] * Sz[m];
      const float D = Cuu * Cww - Cuw * Cuw;
      const float n2 = n * n;
      const float floor_ = n2 * n2 * kDetFloor;  // det = D res^4 / n^4 < 1e-9
      float D_eff = D;
      if (fabsf(D) * r4 < floor_) D_eff = floor_ / r4;  // rare: few or collinear cells
      const float ac = (Cww * Cuz - Cuw * Cwz) / D_eff;
      const float bc = (Cuu * Cwz - Cuw * Cuz) / D_eff;
      const float a = ac / res;
      const float b = bc / res;
      const float slope = atanf(sqrtf(a * a + b * b));
      const float rough = sqrtf(nan_max((Czz - (ac * Cuz + bc * Cwz)) / n2, 0.f));
      const float step = isfinite(zmin[m]) ? zmax[m] - zmin[m] : 0.f;
      const bool enough = S1[m] >= 3.f;
      const bool centre = s.v[r0 + m + kHalo][tx + 4] > 0.f;
      float t = 1.f - nan_max(nan_max(slope * inv_slope, rough * inv_rough), step * inv_step);
      t = nan_min(nan_max(t, 0.f), 1.f);

      const size_t p = (size_t)i * g.W + j;
      slope_out[p] = enough ? slope : 0.f;
      rough_out[p] = enough ? rough : 0.f;
      step_out[p] = step;
      trav_out[p] = (enough && centre) ? t : 0.5f;
    }
    __syncthreads();  // the next tile overwrites the halo and the row sums
  }
}

}  // namespace

extern "C" {

// Launches the stencil on `stream` over an (H, W) grid; returns the CUDA
// error (0 on success). `res` points to one float on the device; out
// holds four (H, W) float layers: slope, roughness, step,
// traversability. `aligned` != 0 promises W % 4 == 0, height 16-byte
// and valid 4-byte aligned, so that interior tiles stream their halo
// with cp.async. The grid is persistent: as many blocks as fit on the
// card at once, each walking tiles at a stride of the grid.
int terrain_stencil_launch(const void* height, const void* valid, const void* res, int H,
                           int W, int aligned, float inv_slope, float inv_rough,
                           float inv_step, void* out, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  static int resident[64] = {};  // blocks the card holds at once, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !resident[dev]) {
    err = cudaFuncSetAttribute((const void*)terrain_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Shared));
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, terrain_kernel, kThreads,
                                                        sizeof(Shared));
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    resident[dev] = per_sm * sms;
  }
  Grid g;
  g.H = H;
  g.W = W;
  g.tiles_x = (W + kTile - 1) / kTile;
  const long long tiles = (long long)g.tiles_x * ((H + kTile - 1) / kTile);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  g.n_tiles = (int)tiles;
  g.aligned = aligned != 0;
  const int blocks = g.n_tiles < resident[dev] ? g.n_tiles : resident[dev];
  float* o = static_cast<float*>(out);
  const size_t plane = (size_t)H * W;
  terrain_kernel<<<blocks, dim3(kThreadsX, kThreadsY), sizeof(Shared),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(height), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(res), g, inv_slope, inv_rough, inv_step, o, o + plane,
      o + 2 * plane, o + 3 * plane);
  return (int)cudaGetLastError();
}

}  // extern "C"
