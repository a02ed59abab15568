// VGICP Gauss-Newton accumulation for Hopper (sm_90a): one launch per GN
// step, the pose applied inside, a fixed-order reduction across a
// thread-block cluster.
//
// Replaces the TPU kernel mr_slam_tpu/ops/pallas_vgicp.py::_accum_kernel
// (pallas_call at pallas_vgicp.py:269), extended to the production
// contract of mr_slam_tpu/ops/registration.py::_gn_terms_from_rows
// (cached correspondences + linearization center). The TPU kernel's
// one-hot MXU "gather", BLK padding, (B, 32, N) integrand output and
// B-chunking for VMEM are TPU workarounds and are not carried over: here
// a thread loads its point's 64-byte packed voxel row directly.
//
// Per point: x' = R p + t when a pose is given (fixed order
// ((R00 x + R01 y) + R02 z) + t0), the voxel row (hash mode: floor(x' /
// leaf), lowbias32 % H, coordinate check; slot mode: the cached slot and
// found flag), the max-correspondence gate, the adjugate inverse of
// cov + eps I under the det floor max(1e-5 cxx cyy czz, 1e-12), and 29
// integrands: the 21 entries of the H upper triangle, 6 of b, the cost
// and the inlier weight. A row is read only for a point that needs it
// (valid, and found in slot mode); a point that does not needs no row
// and adds zeros.
//
// Bound: the bytes. At the loop-verify shapes (B = 8 x N = 16384, tables
// of 8192 / 32768 rows) one call must read 18 B per point (point 12,
// mask 1, slot 4, found 1), 64 B per distinct row the found points
// reference (~2,000 on the fine table) and the pose: ~2.5 MB, 0.74 us
// at 3.35 TB/s. Its ~200 f32 operations per point are 0.4 us at the f32
// peak. At that scale a launch and any second pass cost more than the
// work, so:
//
//   * One launch per call. Batch item b is one thread-block cluster of C
//     CTAs (grid (C, B), cluster (C, 1, 1)); CTA r owns the contiguous
//     points [r ceil(N/C), (r+1) ceil(N/C)). Each thread walks its points
//     at a stride of the block size (coalesced loads) and keeps the 29
//     sums in registers.
//   * The gather is software-pipelined in registers: the point, slot and
//     found flag of point k+2 and the four float4 row loads of point k+1
//     are in flight while point k is computed.
//   * No float atomics and no partial buffer in device memory: a
//     transposing butterfly of 31 shuffles per warp, then the warps in
//     shared memory in order; each CTA then
//     writes its 29 block sums into CTA rank 0's shared memory through
//     distributed shared memory, one cluster.sync() (release / acquire)
//     publishes them, and rank 0 sums them in rank order and writes the
//     (B, 44) result (H both triangles, b, cost, inliers). Nothing reads
//     a CTA's own shared memory after the barrier, so no second barrier
//     holds the CTAs back; the barrier that guarantees every CTA has
//     started before the first remote write is arrived at on entry and
//     waited on only then. The summation order depends only on N and
//     C, so reruns are bit-identical.
//   * The pose is applied in the kernel, so the GN loop no longer writes
//     and reads back a transformed (B, N, 3) copy of the points.
//
// Built with --fmad=false: the plain PyTorch version evaluates every
// product and sum as a separate IEEE operation, so without contraction
// the transform, the per-point gates (d2 < max_corr2, det > det_floor)
// and therefore the inlier count agree exactly with it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;  // the block size is the launch's (128, 256 or 512)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kTerms = 29;
constexpr int kOut = 44;  // H (36), b (6), cost, inliers

struct Params {
  int N;
  int H;
  int chunk;  // points per CTA: ceil(N / C)
  float leaf;
  float eps;
  float max_corr2;
};

__device__ __forceinline__ int hash_slot(int i, int j, int k, uint32_t H) {
  uint32_t h = (uint32_t)i * 0x9E3779B1u + (uint32_t)j * 0x85EBCA77u +
               (uint32_t)k * 0xC2B2AE3Du;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return (int)(h % H);
}

// Stage 1 of the pipeline: a point's own inputs.
struct Raw {
  float px, py, pz;
  int s;
  bool m, f;
};

// Stage 2: the point in the target frame, with its row in flight.
// row: q0 = (c0 c1 c2 count), q1 = (mu0 mu1 mu2 cxx),
//      q2 = (cyy czz cxy cxz), q3 = (cyz valid pad pad)
struct Pt {
  float x, y, z;
  float fi, fj, fk;  // voxel coords (hash mode)
  bool m, f;
  float4 q0, q1, q2, q3;
};

template <bool kSlot>
__device__ __forceinline__ Raw load_raw(const float* __restrict__ xyz,
                                        const uint8_t* __restrict__ mask,
                                        const int32_t* __restrict__ slot,
                                        const uint8_t* __restrict__ found, size_t p) {
  Raw r;
  r.px = __ldg(xyz + 3 * p + 0);
  r.py = __ldg(xyz + 3 * p + 1);
  r.pz = __ldg(xyz + 3 * p + 2);
  r.m = __ldg(mask + p) != 0;
  if (kSlot) {
    r.s = __ldg(slot + p);
    r.f = __ldg(found + p) != 0;
  } else {
    r.s = 0;
    r.f = false;
  }
  return r;
}

template <bool kSlot, bool kPose>
__device__ __forceinline__ Pt start_row(const Raw& r, const float (&R)[9], const float (&T)[3],
                                        const float4* __restrict__ rows, const Params& prm) {
  Pt p;
  if (kPose) {
    p.x = ((R[0] * r.px + R[1] * r.py) + R[2] * r.pz) + T[0];
    p.y = ((R[3] * r.px + R[4] * r.py) + R[5] * r.pz) + T[1];
    p.z = ((R[6] * r.px + R[7] * r.py) + R[8] * r.pz) + T[2];
  } else {
    p.x = r.px;
    p.y = r.py;
    p.z = r.pz;
  }
  p.m = r.m;
  int s;
  bool load;
  if (kSlot) {
    p.fi = p.fj = p.fk = 0.f;
    p.f = r.f;
    s = r.s;
    load = r.m && r.f;
  } else {
    p.fi = floorf(p.x / prm.leaf);
    p.fj = floorf(p.y / prm.leaf);
    p.fk = floorf(p.z / prm.leaf);
    p.f = false;
    s = hash_slot((int)p.fi, (int)p.fj, (int)p.fk, (uint32_t)prm.H);
    load = r.m;
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  p.q0 = p.q1 = p.q2 = p.q3 = zero;
  if (load) {
    const float4* row = rows + (size_t)s * 4;
    p.q0 = __ldg(row + 0);
    p.q1 = __ldg(row + 1);
    p.q2 = __ldg(row + 2);
    p.q3 = __ldg(row + 3);
  }
  return p;
}

// Stage 3: the 29 integrands of one point, added to the running sums.
template <bool kSlot, bool kCenter>
__device__ __forceinline__ void accumulate(const Pt& p, const float (&c)[3], const Params& prm,
                                           float (&acc)[kTerms]) {
  const bool found = kSlot ? p.f
                           : (p.q3.y > 0.5f) && (p.q0.x == p.fi) && (p.q0.y == p.fj) &&
                                 (p.q0.z == p.fk);
  const bool need = p.m && found;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 q1 = need ? p.q1 : zero;  // a point that needs no row adds zeros
  const float4 q2 = need ? p.q2 : zero;
  const float4 q3 = need ? p.q3 : zero;
  const float xr = p.x, yr = p.y, zr = p.z;
  float x = xr, y = yr, z = zr;
  if (kCenter) {
    x = xr - c[0];
    y = yr - c[1];
    z = zr - c[2];
  }
  const float mu0 = q1.x, mu1 = q1.y, mu2 = q1.z;
  const float cxx = q1.w + prm.eps;
  const float cyy = q2.x + prm.eps;
  const float czz = q2.y + prm.eps;
  const float cxy = q2.z, cxz = q2.w, cyz = q3.x;

  const float r0 = mu0 - xr, r1 = mu1 - yr, r2 = mu2 - zr;
  const float d2 = r0 * r0 + r1 * r1 + r2 * r2;
  float w = (need && d2 < prm.max_corr2) ? 1.f : 0.f;

  const float a00 = cyy * czz - cyz * cyz;
  const float a01 = cxz * cyz - cxy * czz;
  const float a02 = cxy * cyz - cxz * cyy;
  const float a11 = cxx * czz - cxz * cxz;
  const float a12 = cxy * cxz - cxx * cyz;
  const float a22 = cxx * cyy - cxy * cxy;
  const float det = cxx * a00 + cxy * a01 + cxz * a02;
  const float det_floor = fmaxf(1e-5f * cxx * cyy * czz, 1e-12f);
  w = w * (det > det_floor ? 1.f : 0.f);
  const float inv_det = w / fmaxf(det, 1e-30f);
  const float w00 = a00 * inv_det, w01 = a01 * inv_det, w02 = a02 * inv_det;
  const float w11 = a11 * inv_det, w12 = a12 * inv_det, w22 = a22 * inv_det;

  const float u0 = w00 * r0 + w01 * r1 + w02 * r2;
  const float u1 = w01 * r0 + w11 * r1 + w12 * r2;
  const float u2 = w02 * r0 + w12 * r1 + w22 * r2;

  const float D00 = z * w01 - y * w02;
  const float D10 = z * w11 - y * w12;
  const float D20 = z * w12 - y * w22;
  const float D01 = -z * w00 + x * w02;
  const float D11 = -z * w01 + x * w12;
  const float D21 = -z * w02 + x * w22;
  const float D02 = y * w00 - x * w01;
  const float D12 = y * w01 - x * w11;
  const float D22 = y * w02 - x * w12;
  const float E00 = z * D10 - y * D20;
  const float E01 = z * D11 - y * D21;
  const float E02 = z * D12 - y * D22;
  const float E11 = -z * D01 + x * D21;
  const float E12 = -z * D02 + x * D22;
  const float E22 = y * D02 - x * D12;

  // H upper triangle (21), _TRI order; b (6), cost, inlier weight
  const float t[kTerms] = {
      w00, w01, w02, -D00, -D01, -D02,
      w11, w12, -D10, -D11, -D12,
      w22, -D20, -D21, -D22,
      E00, E01, E02,
      E11, E12,
      E22,
      u0, u1, u2, y * u2 - z * u1, z * u0 - x * u2, x * u1 - y * u0,
      r0 * u0 + r1 * u1 + r2 * u2, w,
  };
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = acc[k] + t[k];
}

// One step of a transposing butterfly over a warp: a lane hands the half
// of its 2 kHalf running sums that its partner (lane ^ kHalf) keeps and
// adds the partner's share of the half it keeps. After the steps 16, 8,
// 4, 2, 1 (31 shuffles, not 29 x 5), lane l holds the warp's sum of
// term l, added in an order fixed by the lane numbers.
template <int kHalf>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float keep = upper ? v[k + kHalf] : v[k];
    const float give = upper ? v[k] : v[k + kHalf];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, give, kHalf);
  }
}

__constant__ int kTriRow[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
                                2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ int kTriCol[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5,
                                2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

template <bool kSlot, bool kCenter, bool kPose>
__global__ void __launch_bounds__(kMaxThreads, 1)
accum_kernel(const float* __restrict__ xyz,       // (B, N, 3)
             const uint8_t* __restrict__ mask,    // (B, N)
             const float4* __restrict__ table,    // (B, H, 16) as float4
             const int32_t* __restrict__ slot,    // (B, N), slot mode
             const uint8_t* __restrict__ found,   // (B, N), slot mode
             const float* __restrict__ center,    // (B, 3), kCenter
             const float* __restrict__ pose_R,    // (B, 3, 3), kPose
             const float* __restrict__ pose_t,    // (B, 3), kPose
             Params prm,
             float* __restrict__ out) {           // (B, 44)
  __shared__ float warp_sums[kMaxWarps][kTerms];
  __shared__ float gathered[kMaxCluster][kTerms];  // the leader's: every CTA's block sums
  cg::cluster_group cluster = cg::this_cluster();
  // arrive now, wait before the first remote write: every CTA of the
  // cluster has started by then, and the wait costs nothing by that time
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  const int b = blockIdx.y;
  const int begin = min(prm.N, (int)blockIdx.x * prm.chunk);
  const int end = min(prm.N, begin + prm.chunk);
  const size_t base = (size_t)b * prm.N;
  const float4* rows = table + (size_t)b * prm.H * 4;
  const int32_t* slot_b = kSlot ? slot + base : nullptr;
  const uint8_t* found_b = kSlot ? found + base : nullptr;
  const float* xyz_b = xyz + 3 * base;
  const uint8_t* mask_b = mask + base;

  float R[9], T[3], c[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = kPose ? __ldg(pose_R + 9 * b + k) : 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T[k] = kPose ? __ldg(pose_t + 3 * b + k) : 0.f;
    c[k] = kCenter ? __ldg(center + 3 * b + k) : 0.f;
  }
  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.f;

  // pipeline: raw inputs two points ahead, the row one point ahead
  const int step = blockDim.x;
  int i = begin + threadIdx.x;
  Pt cur{};
  Raw ahead{};
  if (i < end)
    cur = start_row<kSlot, kPose>(load_raw<kSlot>(xyz_b, mask_b, slot_b, found_b, i), R, T,
                                  rows, prm);
  if (i + step < end) ahead = load_raw<kSlot>(xyz_b, mask_b, slot_b, found_b, i + step);
  for (; i < end; i += step) {
    Pt next = cur;
    if (i + step < end) next = start_row<kSlot, kPose>(ahead, R, T, rows, prm);
    if (i + 2 * step < end)
      ahead = load_raw<kSlot>(xyz_b, mask_b, slot_b, found_b, i + 2 * step);
    accumulate<kSlot, kCenter>(cur, c, prm, acc);
    cur = next;
  }

  // fixed-order reduction: a transposing butterfly within each warp
  // (`fold`), the warps in order, the CTAs in rank order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = k < kTerms ? acc[k] : 0.f;
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  if (lane < kTerms) warp_sums[warp][lane] = v[0];
  __syncthreads();
  // each CTA writes its block sums into the leader's shared memory; one
  // cluster barrier (release / acquire) makes them visible there, and
  // no CTA's own shared memory is read after it, so none has to wait
  const unsigned rank = cluster.block_rank();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (threadIdx.x < kTerms) {
    const int n_warps = blockDim.x >> 5;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w)
      if (w < n_warps) v += warp_sums[w][threadIdx.x];
    cluster.map_shared_rank(&gathered[0][0], 0)[rank * kTerms + threadIdx.x] = v;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < kTerms) {
    const int k = threadIdx.x;
    const int n_ranks = (int)cluster.num_blocks();
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_ranks) v += gathered[r][k];
    float* o = out + (size_t)b * kOut;
    if (k < 21) {
      o[kTriRow[k] * 6 + kTriCol[k]] = v;
      o[kTriCol[k] * 6 + kTriRow[k]] = v;
    } else {
      o[36 + (k - 21)] = v;  // b 36..41, cost 42, inliers 43
    }
  }
}

using KernelFn = void (*)(const float*, const uint8_t*, const float4*, const int32_t*,
                          const uint8_t*, const float*, const float*, const float*, Params,
                          float*);

// index: slot_mode * 4 + has_center * 2 + has_pose
const KernelFn kKernels[8] = {
    accum_kernel<false, false, false>, accum_kernel<false, false, true>,
    accum_kernel<false, true, false>,  accum_kernel<false, true, true>,
    accum_kernel<true, false, false>,  accum_kernel<true, false, true>,
    accum_kernel<true, true, false>,   accum_kernel<true, true, true>,
};

KernelFn select_kernel(int slot_mode, int has_center, int has_pose) {
  return kKernels[(slot_mode ? 4 : 0) + (has_center ? 2 : 0) + (has_pose ? 1 : 0)];
}

// Clusters of 16 CTAs are beyond the portable 8: allow them once per
// device for every instantiation.
cudaError_t allow_large_clusters() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  for (KernelFn fn : kKernels) {
    err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

cudaLaunchConfig_t launch_config(int cluster, int threads, int B, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// How many clusters of `cluster` CTAs of `threads` threads of the
// selected variant can be resident at once (cudaOccupancyMaxActiveClusters)
// into *n; returns the CUDA error (0 on success). 0 clusters means the
// launch cannot run.
int vgicp_accum_max_clusters(int cluster, int threads, int slot_mode, int has_center,
                             int has_pose, int* n) {
  if (cluster < 1 || cluster > kMaxCluster || threads < 32 || threads > kMaxThreads ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_large_clusters();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(cluster, threads, 1, 0, attr);
  err = cudaOccupancyMaxActiveClusters(n, (const void*)select_kernel(slot_mode, has_center, has_pose),
                                       &cfg);
  return (int)err;
}

// Launches the accumulation on `stream` as B clusters of `cluster` CTAs
// of `threads` threads; returns the CUDA error (0 on success).
// `slot`/`found` are read only when slot_mode != 0, `center` and
// `pose_R`/`pose_t` only when non-null. `out` holds B * 44 floats.
int vgicp_accum_launch(const void* xyz, const void* mask, const void* table, const void* slot,
                       const void* found, const void* center, const void* pose_R,
                       const void* pose_t, int B, int N, int H, float leaf, float eps,
                       float max_corr2, int slot_mode, int cluster, int threads, void* out,
                       void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || threads < 32 || threads > kMaxThreads ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_large_clusters();
  if (err != cudaSuccess) return (int)err;
  Params prm;
  prm.N = N;
  prm.H = H;
  prm.chunk = (N + cluster - 1) / cluster;
  prm.leaf = leaf;
  prm.eps = eps;
  prm.max_corr2 = max_corr2;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      launch_config(cluster, threads, B, static_cast<cudaStream_t>(stream), attr);
  const KernelFn fn = select_kernel(slot_mode, center != nullptr, pose_R != nullptr);
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<const float*>(xyz),
                           static_cast<const uint8_t*>(mask), static_cast<const float4*>(table),
                           static_cast<const int32_t*>(slot), static_cast<const uint8_t*>(found),
                           static_cast<const float*>(center), static_cast<const float*>(pose_R),
                           static_cast<const float*>(pose_t), prm, static_cast<float*>(out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
