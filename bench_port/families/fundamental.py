"""Fundamental-matrix family (multi-body two-view motion): the entry
points the harness drives, its scene generator, its scoring kernel and
the plain reference of the residual that judges their answers.

The residual is the squared Sampson distance of x2^T F x1 = 0 in pixels,
(x2^T F x1)^2 / ((F x1)_0^2 + (F x1)_1^2 + (F^T x2)_0^2 + (F^T x2)_1^2)
(Hartley & Zisserman, eq. 11.9; Progressive-X's two-view residual),
written here from that definition in plain torch, in the dtype of its
inputs: float64 for the reference, bfloat16 for the control. `refit` is
the reference's own least-squares model of a set of points, `model_distance`
how far two models of one set lie apart.
"""

from bench_port import synth
from bench_port.families import (normalized, null_vector, row_points, rows_batched,
                                 rows_single)

ENTRY_SINGLE = "findTwoViewMotions"
ENTRY_BATCHED = "findTwoViewMotionsBatched"
# The fewest points `refit` is run on: more than the minimal sample, so
# that the least-squares model is overdetermined.
REFIT_MIN = 12
KERNEL = "score_fundamental"
# The kernel by the name the CUDA trace gives it: score_common.cuh's
# `score_kernel`, instanced for this residual.
KERNEL_NAMES = [["score_kernel", "SampsonR2"]]
# Operations of the residual per (hypothesis, valid point), 34: F x1 12,
# F^T x2 8, num 4, den 7, square, max and divide 3.
RESIDUAL_OPS = 34
MODEL_SHAPE = (3, 3)
GENERATORS = {"f_scene": synth._f_scene}
# A scene is corrs [n, 4] (x1, y1, x2, y2), float64.
single_args, batched_args, points = rows_single, rows_batched, row_points


def squared_residual(models, corrs):
    """models [K, 3, 3], corrs [n, 4] (x1, y1, x2, y2) -> [K, n]."""
    import torch

    x1, y1, x2, y2 = (c[None, :] for c in corrs.unbind(-1))
    f = models.reshape(-1, 9)[:, :, None]
    fx0 = f[:, 0] * x1 + f[:, 1] * y1 + f[:, 2]
    fx1 = f[:, 3] * x1 + f[:, 4] * y1 + f[:, 5]
    fx2 = f[:, 6] * x1 + f[:, 7] * y1 + f[:, 8]
    ftx0 = f[:, 0] * x2 + f[:, 3] * y2 + f[:, 6]
    ftx1 = f[:, 1] * x2 + f[:, 4] * y2 + f[:, 7]
    num = x2 * fx0 + y2 * fx1 + fx2
    den = fx0 * fx0 + fx1 * fx1 + ftx0 * ftx0 + ftx1 * ftx1
    return num * num / torch.clamp(den, min=1e-30)


def refit(corrs, dtype):
    """The least-squares fundamental matrix of corrs [n, 4] (n >= 8):
    the normalized eight-point algorithm with the rank-2 constraint
    (Hartley & Zisserman, Alg. 11.1), computed in `dtype` up to its 9 x 9
    eigenproblem; [3, 3] float64 of unit norm."""
    import torch

    p1, t1 = normalized(corrs[:, :2], dtype)
    p2, t2 = normalized(corrs[:, 2:], dtype)
    x, y, u, v = p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]
    a = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, torch.ones_like(x)], 1)
    f = null_vector(a).reshape(3, 3)
    uu, s, vt = torch.linalg.svd(f)
    s[2] = 0.0
    f = t2.T @ (uu @ torch.diag(s) @ vt) @ t1
    return f / torch.linalg.norm(f)


def model_distance(a, b, corrs):
    """RMS over corrs [n, 4] of the difference between the Sampson
    distances of the fundamental matrices a and b [3, 3] (float64), in
    pixels."""
    import torch

    ra = torch.sqrt(squared_residual(a[None], corrs)[0])
    rb = torch.sqrt(squared_residual(b[None], corrs)[0])
    return float(torch.sqrt(((ra - rb) ** 2).mean()))
