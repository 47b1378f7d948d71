"""Closed-form linear algebra of the solvers — counterpart of the subset
of progressivex_tpu/ops/linalg.py that the homography, fundamental, line,
vanishing-point and PnP families import.

The algorithms are the JAX package's, step for step: unrolled
Gauss-Jordan elimination with the same partial-pivot rule, null spaces by
fixing the free columns, shifted inverse iteration (6 steps) for the
smallest eigenvector, the closed-form symmetric 2x2 eigenvector, the
trigonometric/Cardano cubic with its quadratic and linear fallbacks, and
Ferrari's quartic with two Newton steps. `torch.linalg.svd`/`eigh` would return
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


def normalize_vec(v, dim: int = -1):
    """v over its norm along `dim` (norms below 1e-12 clamped)."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=_EPS)


def det3(M):
    """Closed-form determinant of M [..., 3, 3] -> [...]."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def matmul_small(A, B):
    """A [..., p, q] @ B [..., q, r] for tiny q, as elementwise products
    summed over q, so that a row's bits do not depend on the batch."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def smallest_eigvec_2x2(M):
    """Closed-form eigenvector of the smallest eigenvalue of symmetric
    M [..., 2, 2]: orthogonal to the larger row of M - lambda I; an
    isotropic M (both rows vanish) gives the x axis."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 1, 1]
    det_gap = torch.sqrt(torch.clamp((a - c) ** 2 + 4.0 * b * b, min=0.0))
    lam = 0.5 * ((a + c) - det_gap)
    r0 = torch.stack([a - lam, b], -1)
    r1 = torch.stack([b, c - lam], -1)
    use0 = (r0 * r0).sum(-1) > (r1 * r1).sum(-1)
    row = torch.where(use0[..., None], r0, r1)
    v = torch.stack([-row[..., 1], row[..., 0]], -1)
    nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    x_axis = torch.eye(2, dtype=M.dtype, device=M.device)[0]
    return torch.where(nrm > _EPS, v / torch.clamp(nrm, min=_EPS), x_axis)


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
    sqrt2 = torch.full((), 2.0, dtype=pts.dtype, device=pts.device).sqrt()
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


def polish_poly_roots(coeffs, roots, iters: int = 2):
    """Newton steps on the roots [..., k] of the polynomials whose
    coefficients, highest power first, are coeffs [..., deg + 1]; a step is
    clipped to +-1e6 and skipped where the derivative vanishes."""
    x = roots
    for _ in range(iters):
        val = torch.zeros_like(x)
        der = torch.zeros_like(x)
        for i in range(coeffs.shape[-1]):
            der = der * x + val
            val = val * x + coeffs[..., i, None]
        step = val / torch.where(der.abs() > _EPS, der, 1.0)
        x = x - torch.clamp(step, -1e6, 1e6)
    return x


def quartic_roots_real(coeffs):
    """Real roots of the monic x^4 + a x^3 + b x^2 + c x + d = 0 by
    Ferrari's method, coeffs [..., 4] = (a, b, c, d), with two Newton
    steps. Returns (roots [..., 4], valid [..., 4]); an invalid entry holds
    the first valid root."""
    a, b, c, d = coeffs.unbind(-1)
    # Depressed: x = y - a/4 -> y^4 + p y^2 + q y + r.
    a2 = a * a
    p = b - 3.0 * a2 / 8.0
    q = c - a * b / 2.0 + a2 * a / 8.0
    r = d - a * c / 4.0 + a2 * b / 16.0 - 3.0 * a2 * a2 / 256.0
    # Resolvent cubic 8 m^3 + 8 p m^2 + (2 p^2 - 8 r) m - q^2 = 0: its
    # largest real root, at least 1e-10.
    m_roots, m_valid = cubic_roots_real(torch.full_like(p, 8.0), 8.0 * p,
                                        2.0 * p * p - 8.0 * r, -q * q)
    m = torch.where(m_valid, m_roots, -torch.inf).amax(-1)
    m = torch.clamp(m, min=1e-10)
    sqrt2m = torch.sqrt(2.0 * m)
    q_safe = torch.where(sqrt2m.abs() > _EPS, q / sqrt2m, 0.0)
    # y^2 +- sqrt(2m) y + (p/2 + m -+ q / (2 sqrt(2m))) = 0
    c1 = p / 2.0 + m - q_safe / 2.0
    c2 = p / 2.0 + m + q_safe / 2.0

    def quad(bq, cq):
        disc = bq * bq - 4.0 * cq
        s = torch.sqrt(torch.clamp(disc, min=0.0))
        return (-bq - s) / 2.0, (-bq + s) / 2.0, disc >= 0.0

    y0, y1, ok_a = quad(sqrt2m, c1)
    y2, y3, ok_b = quad(-sqrt2m, c2)
    roots = torch.stack([y0, y1, y2, y3], -1) - (a / 4.0)[..., None]
    valid = torch.stack([ok_a, ok_a, ok_b, ok_b], -1)
    roots = polish_poly_roots(torch.stack([torch.ones_like(a), a, b, c, d], -1), roots)
    first = valid.to(torch.int8).argmax(-1, keepdim=True)
    roots = torch.where(valid, roots, roots.gather(-1, first))
    return roots, valid & valid.any(-1, keepdim=True)


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


def orthonormalize_rows(basis, valid):
    """Modified Gram-Schmidt over the rows of small bases basis [..., f, c]
    (progressivex_tpu/ops/linalg.py:353-378, which says why the five-point
    solver needs it). Returns (orthonormal basis, valid & every row's
    remainder norm > 1e-6). The dot products and norms are elementwise
    products summed by `row_sum`, so a row's bits do not depend on the
    batch."""
    rows = []
    for i in range(basis.shape[-2]):
        v = basis[..., i, :]
        for u in rows:
            v = v - row_sum(v * u)[..., None] * u
        n = torch.sqrt(row_sum(v * v))
        valid = valid & (n > 1e-6)
        rows.append(v / torch.clamp(n, min=_EPS)[..., None])
    return torch.stack(rows, -2), valid


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


def kabsch(src, dst, weights):
    """Weighted rigid alignment dst ~ R src + t for src, dst [..., N, 3]
    and weights [..., N]. Returns (R [..., 3, 3], t [..., 3], valid [...]).

    R = V diag(1, 1, sign det(V U^T)) U^T from the SVD U S V^T of the
    weighted cross-covariance, which does not change when a pair of
    singular vectors flips sign together. A cross-covariance that is not
    finite (a degenerate sample) is replaced by the identity before the
    SVD and marked invalid, since the SVD of the card raises on it."""
    wsum = torch.clamp(row_sum(weights), min=_EPS)[..., None]
    mu_s = row_sum(weights[..., :, None] * src, -2) / wsum
    mu_d = row_sum(weights[..., :, None] * dst, -2) / wsum
    H = gram(src - mu_s[..., None, :], dst - mu_d[..., None, :], weights)
    finite = torch.isfinite(H).all(-1).all(-1)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    U, _, Vh = torch.linalg.svd(torch.where(finite[..., None, None], H, eye))
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    sgn = torch.sign(det3(matmul_small(V, Ut)))
    one = torch.ones_like(sgn)
    R = matmul_small(V * torch.stack([one, one, sgn], -1)[..., None, :], Ut)
    t = mu_d - (R * mu_s[..., None, :]).sum(-1)
    valid = (finite & torch.isfinite(R).all(-1).all(-1)
             & torch.isfinite(t).all(-1))
    return R, t, valid
