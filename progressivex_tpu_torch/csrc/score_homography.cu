// Fused compound-penalized scoring of homography hypotheses (sm_90a).
//
// Replaces the Pallas TPU kernel progressivex_tpu/ops/pallas_scoring.py:91-126
// (`_score_kernel` with `_homography_r2` at :70-85, launched by
// `fused_scores` at :155). The kernel body is score_common.cuh's; the
// residual here is the squared transfer error under H (1e18 where
// |pz| <= 1e-9), in the operation order of the plain torch version
// (models/homography._squared_residual).
//
// Bound on an H100: at B = 256 and N = 2304 (2084 valid points, unihouse)
// the pass does 32 float32 operations per (hypothesis, valid point) pair
// (the residual 20: projection 12, |pz| test 1, transfer error 7), 49 with
// four MAGSAC levels (26 MFLOP, 0.39 us at 67 TFLOP/s), and moves 69 KB
// (0.02 us at 3.35 TB/s): it is bound by arithmetic, not by memory.

#include "score_common.cuh"

namespace {

struct HomographyR2 {
  float h[9];

  __device__ explicit HomographyR2(const float* d) {
#pragma unroll
    for (int k = 0; k < 9; ++k) h[k] = d[k];
  }

  __device__ float operator()(const float4 p) const {
    const float px = h[0] * p.x + h[1] * p.y + h[2];
    const float py = h[3] * p.x + h[4] * p.y + h[5];
    const float pz = h[6] * p.x + h[7] * p.y + h[8];
    const bool finite = fabsf(pz) > 1e-9f;
    const float pz_safe = finite ? pz : 1e-9f;
    const float dx = px / pz_safe - p.z;
    const float dy = py / pz_safe - p.w;
    return finite ? dx * dx + dy * dy : 1e18f;
  }
};

}  // namespace

extern "C" int score_homography(const void* pts, const void* compound,
                                const void* pmask, const void* descs, int n_hyp,
                                int n_pts, float trunc_sq, float exponent,
                                int has_compound, int magsac_levels, void* scores,
                                void* inliers, void* dots, void* norms,
                                void* stream) {
  return progx::launch_scores<HomographyR2>(
      pts, compound, pmask, descs, n_hyp, n_pts, trunc_sq, exponent, has_compound,
      magsac_levels, scores, inliers, dots, norms, stream);
}
