"""Vanishing-point family — counterpart of progressivex_tpu/models/vanishing_point.py.

Data row = segment [xs, ys, xe, ye]; descriptor = unit homogeneous
3-vector. Minimal = the intersection of two segments' lines (chained cross
products), non-minimal = weighted homogeneous least squares (the smallest
eigenvector of A^T A by inverse iteration), residual = squared distance of
the segment's start point from the line through the VP and the segment's
midpoint. The JAX package reaches no kernel for this family; its proposal
scorer is the plain `ops/scoring.residual_scorer` on the card and the CPU
alike.

`_nonminimal` and `_squared_residual` take data [N, 4] or [R, N, 4], with
the row axis leading the weights and descriptors too (models/base.py).
"""

from __future__ import annotations

import torch

from progressivex_tpu_torch.models.base import (ModelFamily, point_columns,
                                                register_family, row_view)
from progressivex_tpu_torch.ops.linalg import gram, normalize_vec, smallest_eigvec_psd
from progressivex_tpu_torch.ops.scoring import residual_scorer

_EPS = 1e-12


def _seg_line(seg):
    """Homogeneous line through a segment's endpoints, seg [..., 4]."""
    xs, ys, xe, ye = seg.unbind(-1)
    return torch.stack([ys - ye, xe - xs, xs * ye - ys * xe], -1)


def _minimal_batched(samples):
    """Intersection of two segments' lines. samples [B, 2, 4] ->
    ([B, 1, 3], [B, 1])."""
    v = torch.linalg.cross(_seg_line(samples[:, 0]), _seg_line(samples[:, 1]), dim=-1)
    nrm = torch.linalg.vector_norm(v, dim=-1)
    v = v / torch.clamp(nrm, min=_EPS)[:, None]
    return v[:, None, :], (nrm > 1e-9)[:, None]


def _constraint_rows(data):
    """Rows of the homogeneous system, one a segment: the VP lies on the
    line through the start point and the midpoint. [..., N, 4] -> [..., N, 3]."""
    x0, y0, x1, y1 = data.unbind(-1)
    mx = (x0 + x1) / 2.0
    my = (y0 + y1) / 2.0
    return torch.stack([y0 - my, mx - x0, x0 * my - y0 * mx], -1)


def _nonminimal(data, weights):
    """Weighted homogeneous least squares over all segments. data [N, 4]
    or [R, N, 4], weights [(R,) ..., N] -> (descs [(R,) ..., 3], valid)."""
    A = row_view(_constraint_rows(data), data, weights, 2) * weights[..., None]
    v = normalize_vec(smallest_eigvec_psd(gram(A, A)))
    valid = torch.isfinite(v).all(-1) & ((weights > 0).sum(-1) >= 2)
    return v, valid


def _squared_residual(data, descs):
    """Squared distance of each segment's start point from the line through
    the VP and its midpoint. data [N, 4], descs [..., 3] -> [..., N]; or
    data [R, N, 4], descs [R, ..., 3] -> [R, ..., N]."""
    V = descs[..., :, None]
    xs, ys, xe, ye = point_columns(data, descs)
    v0, v1, v2 = V[..., 0, :], V[..., 1, :], V[..., 2, :]
    mx = (xs + xe) / 2.0
    my = (ys + ye) / 2.0
    lx = my * v2 - v1
    ly = -(mx * v2 - v0)
    lz = mx * v1 - my * v0
    num = lx * xs + ly * ys + lz
    return num * num / torch.clamp(lx * lx + ly * ly, min=_EPS)


VANISHING_POINT = register_family(
    ModelFamily(
        name="vanishing_point",
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
