// Fused compound-penalized scoring of hypotheses (sm_90a): the body that the
// per-family sources (score_homography.cu, score_fundamental.cu) share.
//
// Replaces the body of the Pallas TPU kernel
// progressivex_tpu/ops/pallas_scoring.py:91-126 (`_score_kernel`, launched by
// `fused_scores` at :155). Its two residual functions (`_homography_r2` and
// `_sampson_r2`) become the functors passed as `Residual`. For every
// (hypothesis b, point n) the kernel forms the squared residual r2,
// x = r2 / tau_t^2, the hard-tau preference pref = max(0, 1 - x) and the
// ranking preference (pref, or the MAGSAC ladder
// (1/m) sum_j max(0, 1 - x / (j/m)^2)), and reduces five sums over the
// points:
//   raw = sum rank_pref, shared = sum min(pref, compound),
//   inliers = #{r2 < tau_t^2 / 2.25}, dot = sum pref * compound,
//   norm = sum pref^2,
// all over unmasked points only. The epilogue writes
//   score = has_compound ? raw - max(shared, 0)^exponent : raw.
//
// Design: one warp per hypothesis, the 9 descriptor entries in registers;
// the warp strides over the N points reading one float4 (x1, y1, x2, y2),
// the compound value and the mask per point, keeps five running sums per
// lane and reduces them with shuffles. No atomics and a fixed reduction
// tree, so the sums are the same from run to run. Each residual is written
// in the operation order of its plain torch version and the sources are
// built with -fmad=false, so r2, and with it the inlier count, matches the
// plain version bit for bit. The TPU kernel carries its sums across a
// sequential point-tile grid axis in scratch; Hopper blocks run in no
// order, so the point loop lives inside the warp instead.
//
// Bound on an H100: operations, not bytes, at the proposal shapes (the
// per-family sources give their counts). This first version keeps no points
// in shared memory and scores one hypothesis per warp, so a warp walks
// N / 32 dependent iterations; staging point tiles and scoring several
// hypotheses per warp is the next step.

#pragma once

#include <cuda_runtime.h>

namespace progx {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <class Residual>
__global__ void score_kernel(const float4* __restrict__ pts,
                             const float* __restrict__ compound,
                             const float* __restrict__ pmask,
                             const float* __restrict__ descs, int n_hyp, int n_pts,
                             float trunc_sq, float exponent, int has_compound,
                             int magsac_levels, float* __restrict__ scores,
                             int* __restrict__ inliers, float* __restrict__ dots,
                             float* __restrict__ norms) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= n_hyp) return;  // whole warps exit together

  const Residual residual(descs + b * 9);
  const float inl_thr = trunc_sq / 2.25f;
  const float inv_m = magsac_levels > 0 ? 1.0f / (float)magsac_levels : 0.0f;

  float raw = 0.f, shared = 0.f, dot = 0.f, norm = 0.f;
  int inl = 0;
  for (int n = lane; n < n_pts; n += 32) {
    if (pmask[n] == 0.0f) continue;
    const float r2 = residual(pts[n]);
    const float c = compound[n];
    const float x = r2 / trunc_sq;
    const float pref = fmaxf(1.0f - x, 0.0f);
    float rank = pref;
    if (magsac_levels > 0) {
      float acc = 0.f;
      for (int j = 1; j <= magsac_levels; ++j) {
        const float s = (float)j * inv_m;
        acc += fmaxf(1.0f - x / (s * s), 0.0f);
      }
      rank = acc * inv_m;
    }
    raw += rank;
    shared += fminf(pref, c);
    inl += r2 < inl_thr ? 1 : 0;
    dot += pref * c;
    norm += pref * pref;
  }
  raw = warp_sum(raw);
  shared = warp_sum(shared);
  dot = warp_sum(dot);
  norm = warp_sum(norm);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) inl += __shfl_xor_sync(0xffffffffu, inl, off);
  if (lane == 0) {
    scores[b] = has_compound ? raw - powf(fmaxf(shared, 0.0f), exponent) : raw;
    inliers[b] = inl;
    dots[b] = dot;
    norms[b] = norm;
  }
}

// Launches score_kernel<Residual> on `stream`; returns cudaGetLastError().
template <class Residual>
int launch_scores(const void* pts, const void* compound, const void* pmask,
                  const void* descs, int n_hyp, int n_pts, float trunc_sq,
                  float exponent, int has_compound, int magsac_levels, void* scores,
                  void* inliers, void* dots, void* norms, void* stream) {
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (n_hyp + kWarpsPerBlock - 1) / kWarpsPerBlock;
  score_kernel<Residual><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pts), static_cast<const float*>(compound),
      static_cast<const float*>(pmask), static_cast<const float*>(descs), n_hyp,
      n_pts, trunc_sq, exponent, has_compound, magsac_levels,
      static_cast<float*>(scores), static_cast<int*>(inliers),
      static_cast<float*>(dots), static_cast<float*>(norms));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace progx
