// Fused compound-penalized scoring of 6D-pose hypotheses (sm_90a).
//
// The JAX package scores poses with no Pallas kernel: its engine takes
// `compound_penalized_scores` over the family's `squared_residual` in XLA
// (progressivex_tpu/core/engine.py:189-195, progressivex_tpu/models/pnp.py),
// which fuses the [B, N] field away. The plain torch version
// (ops/scoring.residual_scorer over models/pnp._squared_residual) writes
// that field, and each step of the preferences and the sums, to device
// memory: at the pose proposal's [3 x 1,600, 2,304] about 600 M floats a
// call. Here the body is score_common.cuh's and the residual is the
// squared reprojection error in normalized coordinates of a pose [R | t]
// (12 floats, row-major) at a point (x, y, X, Y, Z):
//   q_i = ((D[4i] X + D[4i+1] Y) + D[4i+2] Z) + D[4i+3],
//   z = |q_z| > 1e-9 ? q_z : 1e-9, dx = q_x / z - x, dy = q_y / z - y,
//   r2 = q_z > 1e-9 ? dx^2 + dy^2 : 1e18 (behind the camera),
// in the operation order of the plain version and built with -fmad=false,
// so that r2, and with it the inlier count, matches it bit for bit.
//
// Bound on an H100: the residual is 27 float32 operations per (hypothesis,
// valid point) pair (projection 18, the |q_z| test 1, the error 7, the
// depth test 1), 39 with the preference and the five sums. At the pose
// proposal shape, 3 restarts x B = 1,600 (400 three-point samples x 4
// roots) and N = 2,304 (1,886 valid points), that is 0.35 GFLOP, 5.3 us at
// 67 TFLOP/s, against 0.48 MB moved: bound by arithmetic by that count, and
// in practice by the three IEEE divisions a pair (the two of the error and
// x = r2 / tau_t^2), about ten instructions each. The points are 25 bytes
// staged (five floats, the compound value, the mask byte), so a ring stage
// holds 848 of them.

#include "score_common.cuh"

namespace {

struct PosePoint {
  float x, y, X, Y, Z;
};

struct PnPR2 {
  using Point = PosePoint;
  static constexpr int kDescWords = 12;
  float d[12];

  __device__ void load(const float* p) {
#pragma unroll
    for (int k = 0; k < 12; ++k) d[k] = __ldg(p + k);
  }

  __device__ float operator()(const PosePoint p) const {
    const float qx = d[0] * p.X + d[1] * p.Y + d[2] * p.Z + d[3];
    const float qy = d[4] * p.X + d[5] * p.Y + d[6] * p.Z + d[7];
    const float qz = d[8] * p.X + d[9] * p.Y + d[10] * p.Z + d[11];
    const float z = fabsf(qz) > 1e-9f ? qz : 1e-9f;
    const float dx = qx / z - p.x;
    const float dy = qy / z - p.y;
    return qz > 1e-9f ? dx * dx + dy * dy : 1e18f;
  }
};

}  // namespace

extern "C" int score_pnp(const void* pts, const void* compound, const void* pmask,
                         const void* descs, int n_rows, int n_hyp, int n_pts,
                         const void* trunc_sq, const void* has_compound, float exponent,
                         int magsac_levels, int k_tile, int cluster, int threads,
                         void* scores, void* inliers, void* dots, void* norms,
                         void* stream) {
  return progx::launch_scores<PnPR2>(
      pts, compound, pmask, descs, n_rows, n_hyp, n_pts, trunc_sq, has_compound,
      exponent, magsac_levels, k_tile, cluster, threads, scores, inliers, dots, norms,
      stream);
}
