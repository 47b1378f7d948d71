"""6D-pose (PnP) family — counterpart of progressivex_tpu/models/pnp.py.

Data row = [x, y, X, Y, Z], (x, y) normalized image coordinates (K^-1
applied by the front end); descriptor = row-major 3x4 pose [R | t].
Minimal = Grunert's P3P (a quartic in the distance ratio, up to four
poses through Kabsch), non-minimal = the whitened weighted DLT with the
depth-sign rule and the projection onto SO(3), refit = six warm-started
Gauss-Newton steps on the reprojection error (the family's
`refine_solver`, which the LO, PEARL and merge refits call), residual =
squared reprojection error in normalized coordinates, 1e18 behind the
camera. The reasons behind each choice (the depth sign instead of det R,
Gauss-Newton instead of the algebraic refit on small-field-angle scenes)
are in the JAX module and hold here unchanged. The JAX package reaches no
kernel for this family; XLA fuses its proposal scorer. Here the scorer is
kernels/scoring.score_pnp: on the CPU its plain version, which is
`ops/scoring.residual_scorer` over `_squared_residual`; on the card one
launch of csrc/score_pnp.cu, which writes no [B, N] field.

The SVDs (Kabsch and the SO(3) projection) are `ops/linalg.svd3` on a
matrix made finite first (`torch.linalg.svd` on the CPU, a Jacobi SVD
that reads nothing to the host on the card). The refit is
kernels/pnp.py: on the CPU its plain version, whose 6x6 Gauss-Newton
system is solved by LU with partial pivoting (`torch.linalg.solve_ex`, as
`jnp.linalg.solve`); on the card one launch of csrc/pnp_refine.cu.

`_nonminimal`, `_refine` and `_squared_residual` take data [N, 5] or
[R, N, 5], with the row axis leading the weights and descriptors too
(models/base.py); every sum over the points of the plain torch code goes
through `row_sum`.
"""

from __future__ import annotations

import torch

from progressivex_tpu_torch.kernels import pnp as kpnp
from progressivex_tpu_torch.kernels.scoring import score_pnp
from progressivex_tpu_torch.models.base import (ModelFamily, point_columns,
                                                register_family, row_view)
from progressivex_tpu_torch.ops.linalg import (det3, gram, kabsch, matmul_small,
                                               quartic_roots_real, row_sum,
                                               smallest_eigvec_psd, svd3)

_EPS = 1e-12


def _bearings(xy):
    """Unit bearing vectors of normalized image points. [..., 2] -> [..., 3]."""
    v = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=_EPS)


def _pose_desc(R, t):
    """[R | t] row-major: R [..., 3, 3], t [..., 3] -> [..., 12]."""
    return torch.cat([R, t[..., None]], -1).reshape(*R.shape[:-2], 12)


def _minimal_batched(samples):
    """Grunert P3P. samples [B, 3, 5] -> ([B, 4, 12], [B, 4] bool), one
    pose a real root of the quartic."""
    j = _bearings(samples[..., :2])  # [B, 3, 3]
    P = samples[..., 2:5]  # [B, 3, 3] world points

    a2 = ((P[:, 1] - P[:, 2]) ** 2).sum(-1)
    b2 = ((P[:, 0] - P[:, 2]) ** 2).sum(-1)
    c2 = ((P[:, 0] - P[:, 1]) ** 2).sum(-1)
    cos_a = (j[:, 1] * j[:, 2]).sum(-1)
    cos_b = (j[:, 0] * j[:, 2]).sum(-1)
    cos_g = (j[:, 0] * j[:, 1]).sum(-1)

    b2s = torch.clamp(b2, min=_EPS)
    amc = (a2 - c2) / b2s
    apc = (a2 + c2) / b2s
    A4 = (amc - 1.0) ** 2 - 4.0 * (c2 / b2s) * cos_a ** 2
    A3 = 4.0 * (amc * (1.0 - amc) * cos_b
                - (1.0 - apc) * cos_a * cos_g
                + 2.0 * (c2 / b2s) * cos_a ** 2 * cos_b)
    A2 = 2.0 * (amc ** 2 - 1.0
                + 2.0 * amc ** 2 * cos_b ** 2
                + 2.0 * ((b2 - c2) / b2s) * cos_a ** 2
                - 4.0 * apc * cos_a * cos_b * cos_g
                + 2.0 * ((b2 - a2) / b2s) * cos_g ** 2)
    A1 = 4.0 * (-amc * (1.0 + amc) * cos_b
                + 2.0 * (a2 / b2s) * cos_g ** 2 * cos_b
                - (1.0 - apc) * cos_a * cos_g)
    A0 = (1.0 + amc) ** 2 - 4.0 * (a2 / b2s) * cos_g ** 2

    solvable = A4.abs() > 1e-12
    A4s = torch.where(solvable, A4, 1.0)
    v, v_valid = quartic_roots_real(torch.stack([A3, A2, A1, A0], -1) / A4s[:, None])
    v_valid = v_valid & solvable[:, None] & (v > _EPS)  # [B, 4]

    # The pose of every root at once: [B, 4(root)].
    amc_, cos_a_, cos_b_, cos_g_, b2_ = (x[:, None] for x in (amc, cos_a, cos_b, cos_g, b2))
    denom_u = 2.0 * (cos_g_ - v * cos_a_)
    u = ((-1.0 + amc_) * v * v - 2.0 * amc_ * cos_b_ * v + 1.0 + amc_) / torch.where(
        denom_u.abs() > _EPS, denom_u, _EPS)
    s1 = torch.sqrt(torch.clamp(
        b2_ / torch.clamp(1.0 + v * v - 2.0 * v * cos_b_, min=_EPS), min=0.0))
    s2 = u * s1
    s3 = v * s1
    Q = torch.stack([s1, s2, s3], -1)[..., None] * j[:, None]  # [B, 4, 3, 3] camera frame
    R, t, ok = kabsch(P[:, None].expand_as(Q), Q, torch.ones_like(Q[..., 0]))
    descs = _pose_desc(R, t)
    ok = ok & (s1 > _EPS) & (s2 > _EPS) & (s3 > _EPS) & (denom_u.abs() > _EPS)
    return descs, ok & v_valid & torch.isfinite(descs).all(-1)


def _nonminimal(data, weights):
    """Weighted DLT of [R | t] on normalized coordinates with whitened
    world points; the sign by weighted-majority positive depth, R
    projected onto SO(3) by SVD and t rescaled with it; a reflection that
    survives the depth sign is invalid. data [N, 5] or [R, N, 5], weights
    [(R,) ..., N] -> (descs [(R,) ..., 12], valid [(R,) ...])."""
    pts = row_view(data, data, weights, 2)
    w = torch.clamp(weights, min=0.0)
    wsum = torch.clamp(row_sum(w), min=_EPS)
    Xw = pts[..., 2:5]
    mu = row_sum(w[..., None] * Xw, -2) / wsum[..., None]
    rms = torch.sqrt(row_sum(w * ((Xw - mu[..., None, :]) ** 2).sum(-1)) / wsum)
    s = torch.clamp(rms, min=_EPS)
    Xn = (Xw - mu[..., None, :]) / s[..., None, None]

    X, Y, Z = Xn.unbind(-1)
    x, y = pts[..., 0].expand_as(X), pts[..., 1].expand_as(X)
    o, z = torch.ones_like(X), torch.zeros_like(X)
    sw = torch.sqrt(w)[..., None]
    r0 = torch.stack([X, Y, Z, o, z, z, z, z, -x * X, -x * Y, -x * Z, -x], -1) * sw
    r1 = torch.stack([z, z, z, z, X, Y, Z, o, -y * X, -y * Y, -y * Z, -y], -1) * sw
    Pm = smallest_eigvec_psd(gram(r0, r0) + gram(r1, r1)).reshape(*w.shape[:-1], 3, 4)

    # Undo the whitening, then the sign by depth (see the JAX module).
    Rp = Pm[..., :3] / s[..., None, None]
    tp = Pm[..., 3] - (Rp * mu[..., None, :]).sum(-1)
    depth = (Xn * Pm[..., 2, None, :3]).sum(-1) + Pm[..., 2, 3, None]
    sgn = torch.where(row_sum(w * torch.sign(depth)) < 0.0, -1.0, 1.0)
    Rp = Rp * sgn[..., None, None]
    tp = tp * sgn[..., None]
    rot_ok = det3(Rp) > 0.0
    finite = torch.isfinite(Rp).all(-1).all(-1)
    eye = torch.eye(3, dtype=Rp.dtype, device=Rp.device)
    U, S, Vh = svd3(torch.where(finite[..., None, None], Rp, eye))
    scale = torch.clamp(S.mean(-1), min=_EPS)
    sdet = torch.sign(det3(matmul_small(U, Vh)))
    one = torch.ones_like(sdet)
    R = matmul_small(U * torch.stack([one, one, sdet], -1)[..., None, :], Vh)
    desc = _pose_desc(R, tp / scale[..., None])
    valid = (finite & torch.isfinite(desc).all(-1) & ((w > 0).sum(-1) >= 6) & rot_ok)
    return desc, valid


def _skew(v):
    """[v]_x for v [..., 3] -> [..., 3, 3]."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _so3_exp(w):
    """Rodrigues: exp of so(3) vectors. [..., 3] -> [..., 3, 3]."""
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2 + 1e-24)
    Wx = _skew(w)
    A = (torch.sin(th) / th)[..., None, None]
    B = ((1.0 - torch.cos(th)) / (th2 + 1e-24))[..., None, None]
    return torch.eye(3, dtype=w.dtype, device=w.device) + A * Wx + B * matmul_small(Wx, Wx)


def _refine(data, weights, init_desc, n_iters: int = 6):
    """Weighted Gauss-Newton on the reprojection error from init_desc,
    R <- exp(omega) R on the left; points behind the camera drop out.
    weights [(R,) ..., N], init_desc [(R,) ..., 12] -> (descs, valid); an
    invalid refit returns its start. The plain torch version on the CPU,
    one launch of csrc/pnp_refine.cu on the card (kernels/pnp.py)."""
    return kpnp.refine(data, weights, init_desc, n_iters)


def _squared_residual(data, descs):
    """Squared reprojection error in normalized coordinates, 1e18 behind
    the camera. data [N, 5], descs [..., 12] -> [..., N]; or data
    [R, N, 5], descs [R, ..., 12] -> [R, ..., N]."""
    D = descs[..., :, None]
    x, y, X, Y, Z = point_columns(data, descs)
    qx, qy, qz = (D[..., 4 * i, :] * X + D[..., 4 * i + 1, :] * Y
                  + D[..., 4 * i + 2, :] * Z + D[..., 4 * i + 3, :] for i in range(3))
    z_safe = torch.where(qz.abs() > 1e-9, qz, 1e-9)
    dx = qx / z_safe - x
    dy = qy / z_safe - y
    return torch.where(qz > 1e-9, dx * dx + dy * dy, 1e18)


PNP = register_family(
    ModelFamily(
        name="pnp",
        sample_size=3,
        nonminimal_min=6,
        max_solutions=4,
        desc_dim=12,
        minimal_solver_batched=_minimal_batched,
        nonminimal_solver=_nonminimal,
        squared_residual=_squared_residual,
        scorer=score_pnp,
        refine_solver=_refine,
    )
)
