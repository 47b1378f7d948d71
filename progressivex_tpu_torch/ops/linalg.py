"""Closed-form linear algebra of the solvers — counterpart of the subset
of progressivex_tpu/ops/linalg.py that the homography and fundamental
families import.

The algorithms are the JAX package's, step for step: unrolled
Gauss-Jordan elimination with the same partial-pivot rule, null spaces by
fixing the free columns, shifted inverse iteration (6 steps) for the
smallest eigenvector, and the trigonometric/Cardano cubic with its
quadratic and linear fallbacks. `torch.linalg.svd`/`eigh` would return
other signs and bases. The JAX package keeps a separate lanes-major form
(`gauss_jordan_solve_lanes`, `nullspace_exact_lanes`) with the batch axis
last for the TPU's vector lanes; here one batch-first form serves both:
every function takes any number of leading batch dimensions.

`row_sum` is the sum over a long axis (the points) that every row of the
engine's row axis takes: a fixed pairwise tree of elementwise adds, so that
a row's float32 sum is the same bits whatever the other rows are and
however many there are. torch's reduction kernels and cuBLAS choose how to
split a long axis from the whole tensor's shape, so on the card their sums
move with the batch size (and a fit's borderline decisions with them).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12
_BIG = 1e18


def row_sum(x, dim: int = -1):
    """Sum of x over `dim` in a fixed order: the axis, padded with zeros to
    a power of two, halves by elementwise adds until one element is left.
    Every add is elementwise, so each output's bits depend on its own
    inputs only."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def gram(a, b, weights=None):
    """sum_n w_n a_n b_n^T for a [..., N, p], b [..., N, q] and weights
    [..., N] (all ones if None) -> [..., p, q], summed by `row_sum` (the
    normal matrices of the weighted fits)."""
    at, bt = a.transpose(-1, -2), b.transpose(-1, -2)
    if weights is not None:
        at = at * weights[..., None, :]
    return row_sum(at[..., :, None, :] * bt[..., None, :, :])


def hartley_normalize(pts, weights):
    """Weighted Hartley normalization of 2D points pts [..., N, 2] under
    weights [..., N] (leading dimensions broadcast).

    Returns (pts_norm [..., N, 2], T [..., 3, 3]) with p_norm_h = T @ p_h:
    the weighted centroid maps to the origin, the weighted mean distance
    to sqrt(2)."""
    wsum = torch.clamp(row_sum(weights), min=_EPS)
    mean = row_sum(weights[..., :, None] * pts, -2) / wsum[..., None]
    centered = pts - mean[..., None, :]
    dist = torch.linalg.vector_norm(centered, dim=-1)
    mean_dist = row_sum(weights * dist) / wsum
    sqrt2 = torch.tensor(2.0, dtype=pts.dtype, device=pts.device).sqrt()
    scale = sqrt2 / torch.clamp(mean_dist, min=_EPS)
    one, zero = torch.ones_like(scale), torch.zeros_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], -1),
        torch.stack([zero, scale, -scale * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return centered * scale[..., None, None], T


def _cbrt_signed(x):
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def cubic_roots_real(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d = 0 for coefficient tensors
    of one shape [...]. Returns (roots [..., 3], valid [..., 3] bool).

    Three real roots (the discriminant >= 0, repeated roots included) come
    from the trigonometric formula, one from Cardano's, with the other two
    entries filled by it and marked invalid; a tiny `a` falls back to the
    quadratic and a tiny `b` to the linear equation."""
    is_cubic = a.abs() > 1e-10 * torch.maximum(
        torch.maximum(b.abs(), c.abs()), torch.clamp(d.abs(), min=1.0))
    a_safe = torch.where(is_cubic, a, 1.0)

    # Depressed cubic t^3 + p t + q with x = t - b / (3 a).
    shift = b / (3.0 * a_safe)
    p = (3.0 * a_safe * c - b * b) / (3.0 * a_safe * a_safe)
    q = (2.0 * b ** 3 - 9.0 * a_safe * b * c + 27.0 * a_safe * a_safe * d) / (
        27.0 * a_safe ** 3)
    disc = -4.0 * p ** 3 - 27.0 * q * q

    # Three real roots: the trigonometric method.
    p_neg = torch.clamp(p, max=-_EPS)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    acos_arg = torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)
    theta = torch.arccos(acos_arg) / 3.0
    k = torch.arange(3, dtype=a.dtype, device=a.device)
    roots_tri = m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * k / 3.0)

    # One real root: Cardano.
    half_q = 0.5 * q
    sq = torch.sqrt(torch.clamp(half_q * half_q + p ** 3 / 27.0, min=0.0))
    t_single = _cbrt_signed(-half_q + sq) + _cbrt_signed(-half_q - sq)

    # The trigonometric formula holds on the disc == 0 boundary too.
    three_real = disc >= 0.0
    roots = torch.where(three_real[..., None], roots_tri, t_single[..., None]) \
        - shift[..., None]
    valid = torch.stack([torch.ones_like(three_real), three_real, three_real], -1)

    # Quadratic fallback b x^2 + c x + d = 0, linear below it.
    is_quad = b.abs() > 1e-12
    b_safe = torch.where(is_quad, b, 1.0)
    qdisc = c * c - 4.0 * b_safe * d
    qs = torch.sqrt(torch.clamp(qdisc, min=0.0))
    qr0 = (-c - qs) / (2.0 * b_safe)
    qr1 = (-c + qs) / (2.0 * b_safe)
    lin = -d / torch.where(c.abs() > _EPS, c, 1.0)
    quad_roots = torch.stack([torch.where(is_quad, qr0, lin), qr1, qr1], -1)
    quad_ok = is_quad & (qdisc >= 0)
    quad_valid = torch.stack([quad_ok | ~is_quad, quad_ok, torch.zeros_like(quad_ok)], -1)

    roots = torch.where(is_cubic[..., None], roots, quad_roots)
    valid = torch.where(is_cubic[..., None], valid, quad_valid)
    return roots, valid


def gauss_jordan_solve(M, B):
    """Solve M X = B for tiny static n by unrolled Gauss-Jordan with
    partial pivoting. M [..., n, n], B [..., n, r] -> X [..., n, r]
    (garbage for singular systems — callers validate).

    The pivot row is picked by argmax of |column| over the rows not yet
    used and applied through a one-hot row selection, as in the JAX
    package, so that ties and degenerate columns resolve the same way."""
    n = M.shape[-1]
    A = torch.cat([M, B], dim=-1)
    used = torch.zeros(A.shape[:-1], dtype=A.dtype, device=A.device)
    perm = []
    for i in range(n):
        col = A[..., :, i].abs() - used * _BIG
        p = torch.nn.functional.one_hot(col.argmax(-1), n).to(A.dtype)
        pivot_row = (p[..., :, None] * A).sum(-2)
        piv = pivot_row[..., i]
        piv = torch.where(piv.abs() > _EPS, piv, _EPS)
        pivot_row = pivot_row / piv[..., None]
        factors = A[..., :, i] * (1.0 - p)
        A = A - factors[..., :, None] * pivot_row[..., None, :]
        A = A * (1.0 - p)[..., :, None] + p[..., :, None] * pivot_row[..., None, :]
        perm.append(p)
        used = used + p
    P = torch.stack(perm, dim=-2)
    return (P @ A)[..., n:]


def nullspace_exact(A, n_free: int):
    """Null-space basis of exact minimal systems A [..., m, m + n_free].

    Fixes the last n_free columns as free variables and solves the square
    [m, m] system for the rest. Returns (basis [..., n_free, m + n_free]
    with unit rows, valid [...]); valid is False when the chosen free
    columns are degenerate (the basis then fails to annihilate A)."""
    m = A.shape[-2]
    X = gauss_jordan_solve(A[..., :m], -A[..., m:])  # [..., m, f]
    eye = torch.eye(n_free, dtype=A.dtype, device=A.device).expand(
        *A.shape[:-2], n_free, n_free)
    basis = torch.cat([X.transpose(-1, -2), eye], dim=-1)
    norm = torch.linalg.vector_norm(basis, dim=-1, keepdim=True)
    basis = basis / torch.clamp(norm, min=_EPS)
    resid = (basis @ A.transpose(-1, -2)).abs().amax(dim=(-2, -1))
    scale = torch.clamp(A.abs().amax(dim=(-2, -1)), min=1.0)
    valid = torch.isfinite(basis).all(-1).all(-1) & (resid < 1e-3 * scale)
    return basis, valid


def smallest_eigvec_psd(M, iters: int = 6):
    """Eigenvector of the smallest eigenvalue of small symmetric PSD
    matrices M [..., n, n] by shifted inverse iteration with the unrolled
    Gauss-Jordan solver."""
    n = M.shape[-1]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / n
    shift = torch.clamp(1e-6 * tr, min=1e-12)
    Ms = M + shift[..., None, None] * torch.eye(n, dtype=M.dtype, device=M.device)
    v = torch.arange(1, n + 1, dtype=M.dtype, device=M.device)
    v = (v / torch.linalg.vector_norm(v)).expand(*M.shape[:-2], n)
    for _ in range(iters):
        v = gauss_jordan_solve(Ms, v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=_EPS)
    return v
