"""Homography family — counterpart of progressivex_tpu/models/homography.py.

Data row = [x1, y1, x2, y2]; descriptor = flattened row-major 3x3 H mapping
image-1 points to image-2 points. Minimal = 4-point DLT with an exact null
space, non-minimal = weighted DLT through the 9x9 normal matrix, residual =
squared transfer error in the destination image. The proposal scorer is
the fused CUDA kernel (kernels/scoring.score_homography).

`_nonminimal` and `_squared_residual` take the scene either as data
[N, 4] or with a leading row axis, data [R, N, 4] (one scene or restart a
row); their weights and descriptors then carry the row axis first too
(models/base.py). `_minimal_batched` solves a flat batch of samples, so
the engine flattens rows and hypotheses into it.
"""

from __future__ import annotations

import torch

from progressivex_tpu_torch.kernels.scoring import score_homography
from progressivex_tpu_torch.models.base import (ModelFamily, point_columns,
                                                register_family, row_view)
from progressivex_tpu_torch.ops.linalg import (det3, gram, nullspace_exact, row_sum,
                                               smallest_eigvec_psd)

_EPS = 1e-12


def _sqrt2(like):
    return torch.full((), 2.0, dtype=like.dtype, device=like.device).sqrt()


def _dlt_rows(x1, y1, x2, y2):
    """The two DLT rows of each correspondence: ([..., 9], [..., 9])."""
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r0 = torch.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], dim=-1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    return r0, r1


def _normalize_scale(H):
    """Divide H [..., 3, 3] by H[2, 2] when well-conditioned, else by its
    largest entry."""
    scale = H[..., 2, 2]
    big = H.abs().amax(dim=(-2, -1))
    denom = torch.where(scale.abs() > 1e-8 * big, scale,
                        torch.where(big > _EPS, big, torch.ones_like(big)))
    return H / denom[..., None, None]


_TRIPLES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


def _sample_orientation_ok(p1, p2):
    """GC-RANSAC / OpenCV checkSubset parity: all four point triples keep
    their winding between the images, or all four flip. p1, p2:
    [..., 4, 2] -> [...] bool."""

    def cross_sign(p, i, j, k):
        u = p[..., j, :] - p[..., i, :]
        v = p[..., k, :] - p[..., i, :]
        return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]

    q = torch.stack(
        [cross_sign(p1, *t) * cross_sign(p2, *t) for t in _TRIPLES], dim=-1)
    return (q > 0.0).all(-1) | (q < 0.0).all(-1)


def _minimal_batched(samples):
    """Batched 4-point DLT. samples [B, 4, 4] -> ([B, 1, 9], [B, 1] bool).

    Hartley (de)normalization in closed form on [B] statistics, the 8x9
    systems solved by one batched exact null space."""
    p1 = samples[:, :, :2]
    p2 = samples[:, :, 2:4]
    sqrt2 = _sqrt2(samples)

    def norm_stats(p):
        c = p.mean(1)  # [B, 2]
        d = torch.linalg.vector_norm(p - c[:, None, :], dim=-1).mean(1)
        s = sqrt2 / torch.clamp(d, min=_EPS)
        return c, s, (p - c[:, None, :]) * s[:, None, None]

    c1, s1, n1 = norm_stats(p1)
    c2, s2, n2 = norm_stats(p2)
    r0, r1 = _dlt_rows(n1[..., 0], n1[..., 1], n2[..., 0], n2[..., 1])  # [B, 4, 9]
    A = torch.stack([r0, r1], dim=2).reshape(-1, 8, 9)  # rows interleaved per point
    basis, ns_valid = nullspace_exact(A, 1)
    Hn = basis[:, 0].reshape(-1, 3, 3)

    # Denormalize H = T2^-1 Hn T1 (T similarity transforms): Hn T1 scales
    # columns 0, 1 by s1 and folds the centroid into column 2; T2^-1
    # un-scales rows 0, 1 by s2 and adds c2 times row 2.
    m0 = s1[:, None] * Hn[:, :, 0]
    m1 = s1[:, None] * Hn[:, :, 1]
    m2 = (Hn[:, :, 2] - (s1 * c1[:, 0])[:, None] * Hn[:, :, 0]
          - (s1 * c1[:, 1])[:, None] * Hn[:, :, 1])
    M = torch.stack([m0, m1, m2], dim=-1)  # [B, row, col]
    H = torch.stack([
        M[:, 0] / s2[:, None] + c2[:, 0:1] * M[:, 2],
        M[:, 1] / s2[:, None] + c2[:, 1:2] * M[:, 2],
        M[:, 2],
    ], dim=1)
    H = _normalize_scale(H)
    valid = (ns_valid & torch.isfinite(H).all(-1).all(-1)
             & (det3(H).abs() > 1e-10) & _sample_orientation_ok(p1, p2))
    return H.reshape(-1, 1, 9), valid[:, None]


def _scene_conditioners(data):
    """Scene-level, weight-independent Hartley-style conditioning, one per
    row of data [..., N, 4], over all of the row's N points, padding
    included, as the JAX package conditions (its models/homography.py:
    202-223; conditioning only needs coordinates at O(1)). Returns
    (n1 [..., N, 2], n2 [..., N, 2], (c1 [..., 2], s1 [...]), (c2, s2))."""
    sqrt2 = _sqrt2(data)

    n = data.shape[-2]

    def stats(p):
        c = row_sum(p, -2) / n
        d = row_sum(torch.linalg.vector_norm(p - c[..., None, :], dim=-1)) / n
        return c, sqrt2 / torch.clamp(d, min=_EPS)

    c1, s1 = stats(data[..., :2])
    c2, s2 = stats(data[..., 2:4])
    return ((data[..., :2] - c1[..., None, :]) * s1[..., None, None],
            (data[..., 2:4] - c2[..., None, :]) * s2[..., None, None],
            (c1, s1), (c2, s2))


def _nonminimal(data, weights):
    """Weighted DLT over all points. data [N, 4] or [R, N, 4], weights
    [(R,) ..., N] -> (descs [(R,) ..., 9], valid [(R,) ...])."""
    n1, n2, (c1, s1), (c2, s2) = _scene_conditioners(data)
    r0, r1 = _dlt_rows(n1[..., 0], n1[..., 1], n2[..., 0], n2[..., 1])  # [(R,) N, 9]
    r0, r1 = row_view(r0, data, weights, 2), row_view(r1, data, weights, 2)
    w = torch.clamp(weights, min=0.0)
    M = gram(r0, r0, w) + gram(r1, r1, w)  # [..., 9, 9]
    Hn = smallest_eigvec_psd(M).reshape(*weights.shape[:-1], 3, 3)
    one, zero = torch.ones_like(s1), torch.zeros_like(s1)
    T1 = torch.stack([
        torch.stack([s1, zero, -s1 * c1[..., 0]], -1),
        torch.stack([zero, s1, -s1 * c1[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    T2inv = torch.stack([
        torch.stack([one / s2, zero, c2[..., 0]], -1),
        torch.stack([zero, one / s2, c2[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    H = _normalize_scale(row_view(T2inv, data, weights, 2) @ Hn
                         @ row_view(T1, data, weights, 2))
    valid = (torch.isfinite(H).all(-1).all(-1) & (det3(H).abs() > 1e-10)
             & ((weights > 0).sum(-1) >= 4))
    return H.reshape(*weights.shape[:-1], 9), valid


def _squared_residual(data, descs):
    """Squared transfer error. data [N, 4], descs [..., 9] -> [..., N]; or
    data [R, N, 4], descs [R, ..., 9] -> [R, ..., N]. Points whose image
    lies at the plane at infinity of H (|pz| <= 1e-9) get 1e18."""
    H = descs[..., :, None]  # [..., 9, 1] broadcasts against [N]
    x1, y1, x2, y2 = point_columns(data, descs)
    px = H[..., 0, :] * x1 + H[..., 1, :] * y1 + H[..., 2, :]
    py = H[..., 3, :] * x1 + H[..., 4, :] * y1 + H[..., 5, :]
    pz = H[..., 6, :] * x1 + H[..., 7, :] * y1 + H[..., 8, :]
    finite = pz.abs() > 1e-9
    pz_safe = torch.where(finite, pz, 1e-9)
    dx = px / pz_safe - x2
    dy = py / pz_safe - y2
    r2 = dx * dx + dy * dy
    return torch.where(finite, r2, 1e18)


HOMOGRAPHY = register_family(
    ModelFamily(
        name="homography",
        sample_size=4,
        nonminimal_min=4,
        max_solutions=1,
        desc_dim=9,
        minimal_solver_batched=_minimal_batched,
        nonminimal_solver=_nonminimal,
        squared_residual=_squared_residual,
        scorer=score_homography,
    )
)
