// Fused 5x5 terrain-feature stencil for Hopper (sm_90a).
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
// Design: a block of 32 x 8 threads, one output cell each, loads the
// (8 + 4) x (32 + 4) tile of its cells and their 2-cell halo into
// shared memory once; each thread then walks its 25 neighbours in a
// fixed order (row offset outer, column offset inner) and keeps the
// sums in registers. No atomics: a rerun is bit-identical.
//
// Bound: it reads 5 B per cell (height f32, valid u8) and writes 16 B
// (four f32 layers), 21 B in all: 88 MB at 2048^2, 352 MB at 4096^2,
// 26 us / 105 us at the H100's 3.35 TB/s. Its arithmetic is ~600 f32
// operations per cell (25 neighbours x ~20, plus six divisions, two
// square roots and an atan), ~10 GFLOP at 4096^2, so a plain
// one-thread-per-cell loop lands near the f32 issue rate, not the
// memory bound. The halo tile keeps global traffic at one read per
// cell (plus the halo's 50 % overhead from L2).
//
// Numerics: built with --fmad=false and evaluating every product, sum
// and division in the plain version's order, so the kernel and the
// plain version agree bit for bit on the card wherever the math
// library's atanf agrees with PyTorch's; step, S1 and the flags are
// exact in any case. The blend multiplies by the float32 reciprocals of
// the critical values the wrapper passes, as the plain version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 2;
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kSW = kTileW + 2 * kHalo;
constexpr int kSH = kTileH + 2 * kHalo;
constexpr float kDetFloor = 1e-9f;

// torch.maximum / torch.clamp semantics: NaN in, NaN out.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__global__ void __launch_bounds__(kThreads)
terrain_kernel(const float* __restrict__ height,   // (H, W)
               const uint8_t* __restrict__ valid,  // (H, W) 0/1
               const float* __restrict__ res_ptr,  // () metres per cell
               int H, int W, float inv_slope, float inv_rough, float inv_step,
               float* __restrict__ slope_out, float* __restrict__ rough_out,
               float* __restrict__ step_out, float* __restrict__ trav_out) {
  __shared__ float s_v[kSH][kSW];     // 1 for a valid cell, else 0
  __shared__ float s_z[kSH][kSW];     // height of a valid cell, else 0
  __shared__ float s_zmax[kSH][kSW];  // in grid: s_z; outside: -inf
  __shared__ float s_zmin[kSH][kSW];  // valid: height; else +inf

  const int i0 = blockIdx.y * kTileH - kHalo;
  const int j0 = blockIdx.x * kTileW - kHalo;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int k = tid; k < kSH * kSW; k += kThreads) {
    const int r = k / kSW, c = k % kSW;
    const int i = i0 + r, j = j0 + c;
    const bool in = i >= 0 && i < H && j >= 0 && j < W;
    bool ok = false;
    float z = 0.f;
    if (in) {
      const size_t p = (size_t)i * W + j;
      ok = valid[p] != 0;
      if (ok) z = height[p];
    }
    s_v[r][c] = ok ? 1.f : 0.f;
    s_z[r][c] = z;
    s_zmax[r][c] = in ? z : -INFINITY;
    s_zmin[r][c] = ok ? z : INFINITY;
  }
  __syncthreads();

  const int i = blockIdx.y * kTileH + threadIdx.y;
  const int j = blockIdx.x * kTileW + threadIdx.x;
  if (i >= H || j >= W) return;
  const float res = *res_ptr;

  // window sums in integer cell offsets (u, w) = (di, dj)
  float S1 = 0.f, Su = 0.f, Sw = 0.f, Suu = 0.f, Sww = 0.f;
  float Suw = 0.f, Sz = 0.f, Suz = 0.f, Swz = 0.f, Szz = 0.f;
  float zmax = -INFINITY, zmin = INFINITY;
#pragma unroll
  for (int du = -kHalo; du <= kHalo; ++du) {
    const float u = (float)du;
    const int r = threadIdx.y + kHalo + du;
#pragma unroll
    for (int dw = -kHalo; dw <= kHalo; ++dw) {
      const float w = (float)dw;
      const int c = threadIdx.x + kHalo + dw;
      const float v = s_v[r][c];
      const float z = s_z[r][c];
      const float vu = v * u;
      const float vw = v * w;
      const float vz = v * z;
      S1 = S1 + v;
      Su = Su + vu;
      Sw = Sw + vw;
      Suu = Suu + vu * u;
      Sww = Sww + vw * w;
      Suw = Suw + vu * w;
      Sz = Sz + vz;
      Suz = Suz + vu * z;
      Swz = Swz + vw * z;
      Szz = Szz + vz * z;
      zmax = nan_max(zmax, s_zmax[r][c]);
      zmin = nan_min(zmin, s_zmin[r][c]);
    }
  }

  // n-scaled central moments; the xy part is integer-valued and exact
  const float n = nan_max(S1, 1.f);
  const float Cuu = n * Suu - Su * Su;
  const float Cww = n * Sww - Sw * Sw;
  const float Cuw = n * Suw - Su * Sw;
  const float Cuz = n * Suz - Su * Sz;
  const float Cwz = n * Swz - Sw * Sz;
  const float Czz = n * Szz - Sz * Sz;
  const float D = Cuu * Cww - Cuw * Cuw;
  const float n2 = n * n;
  const float r2 = res * res;
  const float r4 = r2 * r2;
  const float floor_ = n2 * n2 * kDetFloor;  // det = D res^4 / n^4 < 1e-9
  const float D_eff = fabsf(D) * r4 < floor_ ? floor_ / r4 : D;
  const float ac = (Cww * Cuz - Cuw * Cwz) / D_eff;
  const float bc = (Cuu * Cwz - Cuw * Cuz) / D_eff;
  const float a = ac / res;
  const float b = bc / res;
  const float slope = atanf(sqrtf(a * a + b * b));
  const float rough = sqrtf(nan_max((Czz - (ac * Cuz + bc * Cwz)) / n2, 0.f));
  const float step = isfinite(zmin) ? zmax - zmin : 0.f;
  const bool enough = S1 >= 3.f;
  const bool centre = s_v[threadIdx.y + kHalo][threadIdx.x + kHalo] > 0.f;
  float t = 1.f - nan_max(nan_max(slope * inv_slope, rough * inv_rough), step * inv_step);
  t = nan_min(nan_max(t, 0.f), 1.f);

  const size_t p = (size_t)i * W + j;
  slope_out[p] = enough ? slope : 0.f;
  rough_out[p] = enough ? rough : 0.f;
  step_out[p] = step;
  trav_out[p] = (enough && centre) ? t : 0.5f;
}

}  // namespace

extern "C" {

// Launches the stencil on `stream` over an (H, W) grid; returns
// cudaGetLastError() (0 on success). `res` points to one float on the
// device; out holds four (H, W) float layers: slope, roughness, step,
// traversability.
int terrain_stencil_launch(const void* height, const void* valid, const void* res, int H,
                           int W, float inv_slope, float inv_rough, float inv_step,
                           void* out, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kTileH);
  float* o = static_cast<float*>(out);
  const size_t plane = (size_t)H * W;
  terrain_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(height), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(res), H, W, inv_slope, inv_rough, inv_step, o, o + plane,
      o + 2 * plane, o + 3 * plane);
  return (int)cudaGetLastError();
}

}  // extern "C"
