"""2D line family — counterpart of progressivex_tpu/models/line2d.py.

Data row = [x, y]; descriptor = (a, b, c) with a^2 + b^2 = 1. Minimal =
the line through two points, non-minimal = weighted total least squares
(the closed-form smallest eigenvector of the 2x2 scatter), residual =
squared point-line distance. The JAX package reaches no kernel for this
family; its proposal scorer is the plain `ops/scoring.residual_scorer` on
the card and the CPU alike.

`_nonminimal` and `_squared_residual` take data [N, 2] or [R, N, 2], with
the row axis leading the weights and descriptors too (models/base.py).
"""

from __future__ import annotations

import torch

from progressivex_tpu_torch.models.base import (ModelFamily, point_columns,
                                                register_family, row_view)
from progressivex_tpu_torch.ops.linalg import gram, row_sum, smallest_eigvec_2x2
from progressivex_tpu_torch.ops.scoring import residual_scorer

_EPS = 1e-12


def _minimal_batched(samples):
    """Line through two points. samples [B, 2, 2] -> ([B, 1, 3], [B, 1])."""
    p0, p1 = samples[:, 0], samples[:, 1]
    d = p1 - p0
    nrm = torch.linalg.vector_norm(d, dim=-1)
    valid = nrm > 1e-9
    d = d / torch.clamp(nrm, min=_EPS)[:, None]
    n = torch.stack([-d[:, 1], d[:, 0]], -1)  # unit normal
    c = -(n[:, 0] * p0[:, 0] + n[:, 1] * p0[:, 1])
    return torch.cat([n, c[:, None]], -1)[:, None, :], valid[:, None]


def _nonminimal(data, weights):
    """Weighted total-least-squares line. data [N, 2] or [R, N, 2],
    weights [(R,) ..., N] -> (descs [(R,) ..., 3], valid [(R,) ...])."""
    pts = row_view(data, data, weights, 2)
    wsum = torch.clamp(row_sum(weights), min=_EPS)
    mu = row_sum(weights[..., None] * pts, -2) / wsum[..., None]
    centered = pts - mu[..., None, :]
    n = smallest_eigvec_2x2(gram(centered, centered, weights))
    c = -(n[..., 0] * mu[..., 0] + n[..., 1] * mu[..., 1])
    desc = torch.cat([n, c[..., None]], -1)
    valid = torch.isfinite(desc).all(-1) & ((weights > 0).sum(-1) >= 2)
    return desc, valid


def _squared_residual(data, descs):
    """Squared point-line distance. data [N, 2], descs [..., 3] -> [..., N];
    or data [R, N, 2], descs [R, ..., 3] -> [R, ..., N]."""
    L = descs[..., :, None]
    x, y = point_columns(data, descs)
    a, b, c = L[..., 0, :], L[..., 1, :], L[..., 2, :]
    num = a * x + b * y + c
    return num * num / torch.clamp(a * a + b * b, min=_EPS)


LINE2D = register_family(
    ModelFamily(
        name="line2d",
        sample_size=2,
        nonminimal_min=2,
        max_solutions=1,
        desc_dim=3,
        minimal_solver_batched=_minimal_batched,
        nonminimal_solver=_nonminimal,
        squared_residual=_squared_residual,
        scorer=residual_scorer(_squared_residual),
    )
)
