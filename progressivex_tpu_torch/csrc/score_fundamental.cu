// Fused compound-penalized scoring of fundamental-matrix hypotheses (sm_90a).
//
// Replaces the Pallas TPU kernel progressivex_tpu/ops/pallas_scoring.py:91-126
// (`_score_kernel` with `_sampson_r2` at :51-67, launched by `fused_scores`
// at :155). The kernel body is score_common.cuh's; the residual here is the
// squared Sampson distance num^2 / max(den, 1e-12) with
//   F x1 = (fx0, fx1, fx2), F^T x2 = (ftx0, ftx1, .),
//   num = x2 fx0 + y2 fx1 + fx2, den = fx0^2 + fx1^2 + ftx0^2 + ftx1^2,
// in the operation order of the plain torch version
// (models/fundamental._sampson_parts and _squared_residual).
//
// Bound on an H100: the residual is 34 float32 operations per (hypothesis,
// valid point) pair (F x1 12, F^T x2 8, num 4, den 7, square, max and
// divide 3), 46 with the preference and the five sums, 63 with four MAGSAC
// levels. At the F proposal shape, B = 1536 (512 seven-point samples x 3
// roots) and N = 256 (249 valid points, cubetoy), that is 24.1 MFLOP, 0.36 us
// at 67 TFLOP/s, against 85 KB moved (0.025 us at 3.35 TB/s): bound by
// arithmetic by that count. The LO rescoring shape, B = 4, is bound by
// bytes, and in practice by the launch. Three IEEE divisions a pair (the
// Sampson quotient, x = r2 / tau_t^2, one ladder level) cost about ten
// instructions each; the body's answer to latency is in score_common.cuh.

#include "score_common.cuh"

namespace {

struct SampsonR2 {
  float f[9];

  __device__ void load(const float* d) {
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = __ldg(d + k);
  }

  __device__ float operator()(const float4 p) const {
    const float fx0 = f[0] * p.x + f[1] * p.y + f[2];
    const float fx1 = f[3] * p.x + f[4] * p.y + f[5];
    const float fx2 = f[6] * p.x + f[7] * p.y + f[8];
    const float ftx0 = f[0] * p.z + f[3] * p.w + f[6];
    const float ftx1 = f[1] * p.z + f[4] * p.w + f[7];
    const float num = p.z * fx0 + p.w * fx1 + fx2;
    const float den = fx0 * fx0 + fx1 * fx1 + ftx0 * ftx0 + ftx1 * ftx1;
    return num * num / fmaxf(den, 1e-12f);
  }
};

}  // namespace

extern "C" int score_fundamental(const void* pts, const void* compound,
                                 const void* pmask, const void* descs, int n_rows,
                                 int n_hyp, int n_pts, const void* trunc_sq,
                                 const void* has_compound, float exponent,
                                 int magsac_levels, int k_tile, int cluster,
                                 int threads, void* scores, void* inliers,
                                 void* dots, void* norms, void* stream) {
  return progx::launch_scores<SampsonR2>(
      pts, compound, pmask, descs, n_rows, n_hyp, n_pts, trunc_sq, has_compound,
      exponent, magsac_levels, k_tile, cluster, threads, scores, inliers, dots, norms,
      stream);
}
