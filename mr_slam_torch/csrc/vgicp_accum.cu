// VGICP Gauss-Newton accumulation for Hopper (sm_90a).
//
// Replaces the TPU kernel mr_slam_tpu/ops/pallas_vgicp.py::_accum_kernel
// (pallas_call at pallas_vgicp.py:269), extended to the production
// contract of mr_slam_tpu/ops/registration.py::_gn_terms_from_rows
// (cached correspondences + linearization center). The TPU kernel's
// one-hot MXU "gather", BLK padding, (B, 32, N) integrand output and
// B-chunking for VMEM are TPU workarounds and are not carried over:
// here a thread loads its point's 64-byte packed voxel row directly.
//
// One thread per point. Per point: the voxel row (hash mode: floor(x /
// leaf), lowbias32 % H, coordinate check; slot mode: the cached slot and
// found flag), the max-correspondence gate, the adjugate inverse of
// cov + eps I under the det floor max(1e-5 cxx cyy czz, 1e-12), and 29
// integrands: the 21 entries of the H upper triangle, 6 of b, the cost
// and the inlier weight. The block sums them with warp shuffles and then
// across warps in shared memory, writing one (29,) partial per block;
// a second kernel sums the partials of each batch item in a fixed order
// and writes H (B, 6, 6), b (B, 6), cost (B,), inliers (B,). There are
// no float atomics: a rerun is bit-identical.
//
// Bound: at the loop-verify shapes (B = 8 candidates x N = 16384
// points, tables of 8192 / 32768 rows) the kernel moves ~84 B per point
// (12 B point, 1 B mask, 4 B slot, 1 B found, 64 B row) — ~11 MB per GN
// step, a few microseconds at HBM rate, so a step is bound by launch
// count first and memory second. The design keeps it to two launches
// per step and one pass over the points.
//
// Built with --fmad=false: the plain PyTorch twin evaluates every
// product and sum as a separate IEEE operation, so without contraction
// the per-point gates (d2 < max_corr2, det > det_floor) and therefore
// the inlier count agree exactly with it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 29;

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

template <bool kSlotMode, bool kCenter>
__global__ void __launch_bounds__(kThreads)
accum_kernel(const float* __restrict__ tp,          // (B, N, 3)
             const uint8_t* __restrict__ mask,      // (B, N)
             const float4* __restrict__ table,      // (B, H, 16) as float4
             const int32_t* __restrict__ slot,      // (B, N), slot mode
             const uint8_t* __restrict__ found_in,  // (B, N), slot mode
             const float* __restrict__ center,      // (B, 3), kCenter
             int N, int H, float leaf, float eps, float max_corr2,
             float* __restrict__ partial) {         // (B, gridDim.x, 29)
  __shared__ float warp_sums[kWarps][kTerms];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float t[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) t[k] = 0.f;

  if (i < N) {
    const size_t p = (size_t)b * N + i;
    const float xr = tp[3 * p + 0];
    const float yr = tp[3 * p + 1];
    const float zr = tp[3 * p + 2];
    int s;
    float fi = 0.f, fj = 0.f, fk = 0.f;
    if (kSlotMode) {
      s = slot[p];
    } else {
      fi = floorf(xr / leaf);
      fj = floorf(yr / leaf);
      fk = floorf(zr / leaf);
      s = hash_slot((int)fi, (int)fj, (int)fk, (uint32_t)H);
    }
    const float4* row = table + ((size_t)b * H + s) * 4;
    // row: q0 = (c0 c1 c2 count), q1 = (mu0 mu1 mu2 cxx),
    //      q2 = (cyy czz cxy cxz), q3 = (cyz valid pad pad)
    const float4 q0 = row[0];
    const float4 q1 = row[1];
    const float4 q2 = row[2];
    const float4 q3 = row[3];
    bool found;
    if (kSlotMode) {
      found = found_in[p] != 0;
    } else {
      found = (q3.y > 0.5f) && (q0.x == fi) && (q0.y == fj) && (q0.z == fk);
    }
    float x = xr, y = yr, z = zr;
    if (kCenter) {
      x = xr - center[3 * b + 0];
      y = yr - center[3 * b + 1];
      z = zr - center[3 * b + 2];
    }
    const float mu0 = q1.x, mu1 = q1.y, mu2 = q1.z;
    const float cxx = q1.w + eps;
    const float cyy = q2.x + eps;
    const float czz = q2.y + eps;
    const float cxy = q2.z, cxz = q2.w, cyz = q3.x;

    const float r0 = mu0 - xr, r1 = mu1 - yr, r2 = mu2 - zr;
    const float d2 = r0 * r0 + r1 * r1 + r2 * r2;
    float w = (found && mask[p] != 0 && d2 < max_corr2) ? 1.f : 0.f;

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

    // H upper triangle (21), _TRI order
    t[0] = w00;  t[1] = w01;  t[2] = w02;  t[3] = -D00; t[4] = -D01; t[5] = -D02;
    t[6] = w11;  t[7] = w12;  t[8] = -D10; t[9] = -D11; t[10] = -D12;
    t[11] = w22; t[12] = -D20; t[13] = -D21; t[14] = -D22;
    t[15] = E00; t[16] = E01; t[17] = E02;
    t[18] = E11; t[19] = E12;
    t[20] = E22;
    // b (6), cost, inlier weight
    t[21] = u0; t[22] = u1; t[23] = u2;
    t[24] = y * u2 - z * u1;
    t[25] = z * u0 - x * u2;
    t[26] = x * u1 - y * u0;
    t[27] = r0 * u0 + r1 * u1 + r2 * u2;
    t[28] = w;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    float v = t[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += warp_sums[w][threadIdx.x];
    partial[((size_t)b * gridDim.x + blockIdx.x) * kTerms + threadIdx.x] = v;
  }
}

__constant__ int kTriRow[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
                                2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ int kTriCol[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5,
                                2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

// One block per batch item; thread k sums term k over the blocks in
// index order (fixed order: deterministic) and scatters it into H/b.
__global__ void finalize_kernel(const float* __restrict__ partial, int n_blocks,
                                float* __restrict__ H_out, float* __restrict__ b_out,
                                float* __restrict__ cost_out,
                                float* __restrict__ inl_out) {
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  if (k >= kTerms) return;
  float v = 0.f;
  const float* src = partial + (size_t)b * n_blocks * kTerms + k;
  for (int j = 0; j < n_blocks; ++j) v += src[(size_t)j * kTerms];
  if (k < 21) {
    const int r = kTriRow[k], c = kTriCol[k];
    H_out[b * 36 + r * 6 + c] = v;
    H_out[b * 36 + c * 6 + r] = v;
  } else if (k < 27) {
    b_out[b * 6 + (k - 21)] = v;
  } else if (k == 27) {
    cost_out[b] = v;
  } else {
    inl_out[b] = v;
  }
}

template <bool kSlotMode, bool kCenter>
void launch_accum(dim3 grid, cudaStream_t stream, const float* tp, const uint8_t* mask,
                  const float4* table, const int32_t* slot, const uint8_t* found,
                  const float* center, int N, int H, float leaf, float eps,
                  float max_corr2, float* partial) {
  accum_kernel<kSlotMode, kCenter><<<grid, kThreads, 0, stream>>>(
      tp, mask, table, slot, found, center, N, H, leaf, eps, max_corr2, partial);
}

}  // namespace

extern "C" {

int vgicp_accum_blocks(int N) { return N > 0 ? (N + kThreads - 1) / kThreads : 1; }

// Launches the accumulation and the finalize kernel on `stream`; returns
// cudaGetLastError() (0 on success). `slot`/`found` are read only when
// slot_mode != 0, `center` only when non-null. `partial` holds
// B * vgicp_accum_blocks(N) * 29 floats.
int vgicp_accum_launch(const void* tp, const void* mask, const void* table,
                       const void* slot, const void* found, const void* center,
                       int B, int N, int H, float leaf, float eps, float max_corr2,
                       int slot_mode, void* partial, void* H_out, void* b_out,
                       void* cost_out, void* inl_out, void* stream) {
  const int n_blocks = vgicp_accum_blocks(N);
  const dim3 grid(n_blocks, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp_f = static_cast<const float*>(tp);
  const uint8_t* mask_u = static_cast<const uint8_t*>(mask);
  const float4* table_f4 = static_cast<const float4*>(table);
  const int32_t* slot_i = static_cast<const int32_t*>(slot);
  const uint8_t* found_u = static_cast<const uint8_t*>(found);
  const float* center_f = static_cast<const float*>(center);
  float* partial_f = static_cast<float*>(partial);
  if (slot_mode) {
    if (center_f)
      launch_accum<true, true>(grid, s, tp_f, mask_u, table_f4, slot_i, found_u, center_f,
                               N, H, leaf, eps, max_corr2, partial_f);
    else
      launch_accum<true, false>(grid, s, tp_f, mask_u, table_f4, slot_i, found_u, center_f,
                                N, H, leaf, eps, max_corr2, partial_f);
  } else {
    if (center_f)
      launch_accum<false, true>(grid, s, tp_f, mask_u, table_f4, slot_i, found_u, center_f,
                                N, H, leaf, eps, max_corr2, partial_f);
    else
      launch_accum<false, false>(grid, s, tp_f, mask_u, table_f4, slot_i, found_u, center_f,
                                 N, H, leaf, eps, max_corr2, partial_f);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<B, 32, 0, s>>>(partial_f, n_blocks, static_cast<float*>(H_out),
                                   static_cast<float*>(b_out), static_cast<float*>(cost_out),
                                   static_cast<float*>(inl_out));
  return (int)cudaGetLastError();
}

}  // extern "C"
