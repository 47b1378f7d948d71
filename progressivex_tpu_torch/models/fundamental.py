"""Fundamental-matrix (two-view motion) family — counterpart of
progressivex_tpu/models/fundamental.py.

Data row = [x1, y1, x2, y2]; descriptor = flattened row-major 3x3 F with
x2^T F x1 = 0. Minimal = seven-point algorithm (up to three solutions from
the cubic det(l F1 + (1 - l) F2) = 0) with the oriented epipolar check,
non-minimal = inlier-weighted normalized eight-point with rank-2
projection, refit = Sampson-reweighted eight-point, residual = squared
Sampson distance. The proposal scorer is the fused CUDA kernel
(kernels/scoring.score_fundamental). The reasons behind each step (the
best-conditioned epipole, the per-refit weighted conditioning, the
Sampson reweighting) are in the JAX module and hold here unchanged.

`_nonminimal`, `_refine` and `_squared_residual` take the scene either as
data [N, 4] or with a leading row axis, data [R, N, 4]; their weights and
descriptors then carry the row axis first too (models/base.py).
"""

from __future__ import annotations

import torch

from progressivex_tpu_torch.kernels.scoring import score_fundamental
from progressivex_tpu_torch.models.base import (ModelFamily, point_columns,
                                                register_family, row_view)
from progressivex_tpu_torch.ops.linalg import (cubic_roots_real, det3, gram,
                                               hartley_normalize, nullspace_exact, row_sum,
                                               smallest_eigvec_psd)

_EPS = 1e-12


def _epipolar_rows(p1, p2, w):
    """Rows of the linear system x2^T F x1 = 0, F row-major, scaled by w.
    p1, p2 [..., N, 2], w [..., N] -> [..., N, 9]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    rows = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], dim=-1)
    return rows * w[..., None]


def _denormalize(Fn, T1, T2):
    """x2n^T Fn x1n = 0 with xin = Ti xi  =>  F = T2^T Fn T1, unit norm."""
    F = T2.transpose(-1, -2) @ Fn @ T1
    nrm = torch.linalg.vector_norm(F, dim=(-2, -1))
    return F / torch.clamp(nrm, min=_EPS)[..., None, None]


def _minimal_batched(samples):
    """Batched seven-point algorithm. samples [B, 7, 4] -> ([B, 3, 9],
    [B, 3] bool).

    The 7x9 systems go through one batched exact null space; the cubic's
    coefficients come from four closed-form determinants (d0 = det F2,
    d1 = det F1, dm1 = det(2 F2 - F1), d2 = det(2 F1 - F2)); the
    denormalization is closed-form; a solution is kept when the cubic root
    is real, the null space exact, F finite and the sample satisfies the
    oriented epipolar constraint."""
    p1 = samples[:, :, :2]  # [B, 7, 2]
    p2 = samples[:, :, 2:4]
    sqrt2 = torch.full((), 2.0, dtype=samples.dtype, device=samples.device).sqrt()

    def norm_stats(p):
        c = p.mean(1)  # [B, 2]
        d = torch.linalg.vector_norm(p - c[:, None, :], dim=-1).mean(1)
        s = sqrt2 / torch.clamp(d, min=_EPS)
        return c, s, (p - c[:, None, :]) * s[:, None, None]

    c1, s1, n1 = norm_stats(p1)
    c2, s2, n2 = norm_stats(p2)
    A = _epipolar_rows(n1, n2, torch.ones_like(n1[..., 0]))  # [B, 7, 9]
    basis, ns_valid = nullspace_exact(A, 2)  # [B, 2, 9], [B]
    F1 = basis[:, 0].reshape(-1, 3, 3)
    F2 = basis[:, 1].reshape(-1, 3, 3)

    # det(l F1 + (1 - l) F2) is cubic in l: coefficients from 4 evaluations.
    d0 = det3(F2)
    d1 = det3(F1)
    dm1 = det3(2.0 * F2 - F1)
    d2 = det3(2.0 * F1 - F2)
    c2_ = 0.5 * (d1 + dm1) - d0
    a1 = d1 - d0 - c2_
    a2 = d2 - d0 - 4.0 * c2_
    c3_ = (a2 - 2.0 * a1) / 6.0
    c1_ = a1 - c3_
    lam, cubic_valid = cubic_roots_real(c3_, c2_, c1_, d0)  # [B, 3]

    # Fn(l) for all three roots: [B, 3(root), 3, 3].
    lam4 = lam[:, :, None, None]
    Fn = lam4 * F1[:, None] + (1.0 - lam4) * F2[:, None]

    # F = T2^T Fn T1 in closed form (Ti = [[s, 0, -s cx], [0, s, -s cy],
    # [0, 0, 1]]): Fn T1 maps the columns, T2^T the rows.
    bs = lambda v: v[:, None, None]  # noqa: E731  [B] -> [B, 1, 1]
    g0 = bs(s1) * Fn[..., :, 0]  # [B, 3r, 3(row)], new column 0
    g1 = bs(s1) * Fn[..., :, 1]
    g2 = (Fn[..., :, 2] - bs(s1 * c1[:, 0]) * Fn[..., :, 0]
          - bs(s1 * c1[:, 1]) * Fn[..., :, 1])
    G = torch.stack([g0, g1, g2], dim=-1)  # [B, 3r, row, col]
    r0 = bs(s2) * G[..., 0, :]
    r1 = bs(s2) * G[..., 1, :]
    r2 = (G[..., 2, :] - bs(s2 * c2[:, 0]) * G[..., 0, :]
          - bs(s2 * c2[:, 1]) * G[..., 1, :])
    F = torch.stack([r0, r1, r2], dim=-2)  # [B, 3r, 3, 3]
    nrm = torch.sqrt((F * F).sum((-2, -1)))
    F = F / torch.clamp(nrm, min=_EPS)[..., None, None]

    # Oriented epipolar check: the left epipole e2 is the cross product of
    # the best-conditioned pair of F's columns (argmax, ties to the first
    # pair); sign((e2 x x2_i) . F x1_i) must agree over the sample.
    col_cross = torch.stack([
        torch.linalg.cross(F[..., :, 0], F[..., :, 1], dim=-1),
        torch.linalg.cross(F[..., :, 0], F[..., :, 2], dim=-1),
        torch.linalg.cross(F[..., :, 1], F[..., :, 2], dim=-1),
    ], dim=-2)  # [B, 3r, 3(pair), 3]
    mag = (col_cross * col_cross).sum(-1)  # [B, 3r, 3p]
    pick = torch.nn.functional.one_hot(mag.argmax(-1), 3).to(F.dtype)
    e2 = (col_cross * pick[..., None]).sum(-2)  # [B, 3r, 3]
    ones = torch.ones_like(p1[..., :1])
    x1h = torch.cat([p1, ones], -1)  # [B, 7, 3]
    x2h = torch.cat([p2, ones], -1)
    # lines_i = F x1h_i: [B, 3r, 7, 3]
    Fr = F[:, :, None]  # [B, 3r, 1, 3, 3]
    xb = x1h[:, None, :, None, :]  # [B, 1, 7, 1, 3]
    lines = (Fr[..., 0] * xb[..., 0] + Fr[..., 1] * xb[..., 1]) + Fr[..., 2] * xb[..., 2]
    e2b, x2b = torch.broadcast_tensors(e2[:, :, None, :], x2h[:, None, :, :])
    s = (torch.linalg.cross(e2b, x2b, dim=-1) * lines).sum(-1)  # [B, 3r, 7]
    oriented = (s > 0.0).all(-1) | (s < 0.0).all(-1)

    finite = torch.isfinite(F).all(-1).all(-1)
    valid = cubic_valid & ns_valid[:, None] & finite & oriented
    return F.reshape(-1, 3, 9), valid


def _nonminimal(data, weights):
    """Normalized weighted eight-point with rank-2 projection, conditioned
    on the weights of each refit. data [N, 4] or [R, N, 4], weights
    [(R,) ..., N] -> (descs [(R,) ..., 9], valid [(R,) ...])."""
    sw = torch.sqrt(torch.clamp(weights, min=0.0))
    n1, T1 = hartley_normalize(row_view(data[..., :2], data, weights, 2), weights)
    n2, T2 = hartley_normalize(row_view(data[..., 2:4], data, weights, 2), weights)
    A = _epipolar_rows(n1, n2, sw)  # [..., N, 9]
    M = gram(A, A)
    Fn = smallest_eigvec_psd(M).reshape(*weights.shape[:-1], 3, 3)
    # Rank 2: subtract the smallest singular triplet, F - (F v3) v3^T with
    # v3 the smallest eigenvector of F^T F.
    v3 = smallest_eigvec_psd(Fn.transpose(-1, -2) @ Fn)
    Fn = Fn - (Fn @ v3[..., None]) * v3[..., None, :]
    F = _denormalize(Fn, T1, T2)
    valid = torch.isfinite(F).all(-1).all(-1) & ((weights > 0).sum(-1) >= 8)
    return F.reshape(*weights.shape[:-1], 9), valid


def _sampson_parts(data, descs):
    """(numerator x2^T F x1, Sampson denominator). data [N, 4], descs
    [..., 9] -> ([..., N], [..., N]); or data [R, N, 4], descs [R, ..., 9]
    -> [R, ..., N] each."""
    F = descs[..., :, None]  # [..., 9, 1] broadcasts against [N]
    x1, y1, x2, y2 = point_columns(data, descs)
    fx0 = F[..., 0, :] * x1 + F[..., 1, :] * y1 + F[..., 2, :]
    fx1 = F[..., 3, :] * x1 + F[..., 4, :] * y1 + F[..., 5, :]
    fx2 = F[..., 6, :] * x1 + F[..., 7, :] * y1 + F[..., 8, :]
    ftx0 = F[..., 0, :] * x2 + F[..., 3, :] * y2 + F[..., 6, :]
    ftx1 = F[..., 1, :] * x2 + F[..., 4, :] * y2 + F[..., 7, :]
    num = x2 * fx0 + y2 * fx1 + fx2
    den = fx0 * fx0 + fx1 * fx1 + ftx0 * ftx0 + ftx1 * ftx1
    return num, den


def _squared_residual(data, descs):
    """Squared Sampson distance. data [N, 4], descs [..., 9] -> [..., N];
    or data [R, N, 4], descs [R, ..., 9] -> [R, ..., N]."""
    num, den = _sampson_parts(data, descs)
    return num * num / torch.clamp(den, min=_EPS)


def _refine(data, weights, init_desc):
    """Sampson-reweighted eight-point: row weights w_i / den_i under the
    current model, with tiny denominators clamped to 5% of the weighted
    mean. weights [(R,) ..., N], init_desc [(R,) ..., 9]."""
    _, den = _sampson_parts(data, init_desc)
    mean_den = row_sum(den * weights) / torch.clamp(row_sum(weights), min=_EPS)
    w_s = weights / torch.maximum(den, 0.05 * torch.clamp(mean_den, min=_EPS)[..., None])
    return _nonminimal(data, w_s)


FUNDAMENTAL = register_family(
    ModelFamily(
        name="fundamental",
        sample_size=7,
        nonminimal_min=8,
        max_solutions=3,
        desc_dim=9,
        minimal_solver_batched=_minimal_batched,
        nonminimal_solver=_nonminimal,
        squared_residual=_squared_residual,
        scorer=score_fundamental,
        refine_solver=_refine,
    )
)
