"""Homography family: the entry points the harness drives, its scene
generator, its scoring kernel and the plain reference of the residual
that judges their answers.

The residual is the squared transfer error ||H x1 - x2||^2 in pixels
(Progressive-X's homography residual; Barath & Matas, ICCV 2019), with
1e18 where x1 maps to the plane at infinity (|pz| <= 1e-9). It is written
here from that definition in plain torch, in the dtype of its inputs:
float64 for the reference, bfloat16 for the control. `refit` is the
reference's own least-squares model of a set of points, `model_distance`
how far two models of one set lie apart.
"""

from bench_port import synth
from bench_port.families import (normalized, null_vector, row_points, rows_batched,
                                 rows_single)

ENTRY_SINGLE = "findHomographies"
ENTRY_BATCHED = "findHomographiesBatched"
# The fewest points `refit` is run on: more than the minimal sample, so
# that the least-squares model is overdetermined.
REFIT_MIN = 8
KERNEL = "score_homography"
# The kernel by the name the CUDA trace gives it: score_common.cuh's
# `score_kernel`, instanced for this residual.
KERNEL_NAMES = [["score_kernel", "HomographyR2"]]
# Operations of the residual per (hypothesis, valid point), 20: projection
# 12 (6 mul, 6 add), the |pz| test 1, transfer error 7 (2 div, 2 sub, 2
# mul, 1 add).
RESIDUAL_OPS = 20
MODEL_SHAPE = (3, 3)
GENERATORS = {"h_scene": synth._h_scene}
# A scene is corrs [n, 4] (x1, y1, x2, y2), float64.
single_args, batched_args, points = rows_single, rows_batched, row_points


def squared_residual(models, corrs):
    """models [K, 3, 3], corrs [n, 4] (x1, y1, x2, y2) -> [K, n]."""
    import torch

    x1, y1, x2, y2 = (c[None, :] for c in corrs.unbind(-1))
    h = models.reshape(-1, 9)[:, :, None]
    px = h[:, 0] * x1 + h[:, 1] * y1 + h[:, 2]
    py = h[:, 3] * x1 + h[:, 4] * y1 + h[:, 5]
    pz = h[:, 6] * x1 + h[:, 7] * y1 + h[:, 8]
    finite = pz.abs() > 1e-9
    pz = torch.where(finite, pz, torch.ones_like(pz))
    dx = px / pz - x2
    dy = py / pz - y2
    r2 = dx * dx + dy * dy
    return torch.where(finite, r2, torch.full_like(r2, 1e18))


def refit(corrs, dtype):
    """The least-squares homography of corrs [n, 4] (n >= 4): normalized
    DLT (Hartley & Zisserman, Alg. 4.2), computed in `dtype` up to its
    9 x 9 eigenproblem; [3, 3] float64 with h33 = 1."""
    import torch

    p1, t1 = normalized(corrs[:, :2], dtype)
    p2, t2 = normalized(corrs[:, 2:], dtype)
    x, y, u, v = p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    a = torch.cat([torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], 1),
                   torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], 1)])
    h = torch.linalg.inv(t2) @ null_vector(a).reshape(3, 3) @ t1
    return h / h[2, 2]


def model_distance(a, b, corrs):
    """RMS over corrs [n, 4] of the distance between x1 mapped by the
    homographies a and b [3, 3] (float64), in pixels."""
    import torch

    x = torch.cat([corrs[:, :2], torch.ones_like(corrs[:, :1])], 1)
    pa, pb = x @ a.T, x @ b.T
    d = pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]
    return float(torch.sqrt((d * d).sum(1).mean()))
