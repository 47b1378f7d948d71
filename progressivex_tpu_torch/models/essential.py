"""Essential-matrix family — counterpart of progressivex_tpu/models/essential.py.

Data row = [x1, y1, x2, y2] in calibrated (K^-1-normalized) coordinates;
descriptor = flattened row-major 3x3 E with x2^T E x1 = 0 and singular
values (s, s, 0). The JAX module's docstring gives the reasons behind each
step of the design, measured there; they hold here unchanged:

  1. the 4-D null space of the 5x9 epipolar system (`nullspace_exact`),
     orthonormalized (`orthonormalize_rows`), so that |E(q)| = 1 for every
     unit q, E(q) = sum_k q_k E_k;
  2. the ten Demazure constraints (det E = 0 and
     2 E E^T E - tr(E E^T) E = 0) evaluated at E(q), with their Jacobian
     in q;
  3. 64 fixed unit starts (numpy's default_rng(42), as there), 16 damped
     tangent-space Gauss-Newton steps each, the radial direction
     projected out; converged points (|r| < 1e-4) greedily deduplicated
     at |q . q'| > 0.9999 into at most 10 solutions, each kept if the
     sample satisfies it (< 1e-3) and the oriented epipolar constraint.

The JAX module takes the Jacobian by `jax.jacfwd`. E is linear in q, so
column k of the Jacobian is the directional derivative of the constraints
along E_k, which has a closed form: d det = sum(cof(E) * E_k) and
dC = 2 (E_k E^T E + E E_k^T E + E E^T E_k) - 2 <E, E_k> E - tr(E E^T) E_k.
It is written out here instead of `torch.func.jacfwd` under `vmap`: the
closed form is a few 3x3 products over all (sample, start) lanes at once,
where forward-mode AD would trace one dual product per column. Every
Gauss-Newton step runs on all B x 64 lanes, laid out last and contiguous
(the CPU then runs its loops over contiguous lanes), with its 3x3 products
as elementwise products and sums; the one cuBLAS product, the
Gauss-Jordan solve's row permutation, is by a 0/1 matrix and exact. So a
lane's bits do not depend on how many lanes there are, and there is no
loop over samples or starts.

The non-minimal refit is the weighted eight-point solve projected onto the
essential manifold (`_project_essential`), with no refine solver, as in the
JAX family. The residual is the squared Sampson distance, the fundamental
family's function itself, so the proposal scorer is the fundamental
family's kernel (kernels/scoring.score_fundamental), E in place of F.
"""

from __future__ import annotations

import numpy as np
import torch

from progressivex_tpu_torch.kernels.scoring import score_fundamental
from progressivex_tpu_torch.models.base import ModelFamily, register_family, row_view
from progressivex_tpu_torch.models.fundamental import _epipolar_rows, _squared_residual
from progressivex_tpu_torch.ops.linalg import (det3, gauss_jordan_solve, gram, matmul_small,
                                               nullspace_exact, orthonormalize_rows,
                                               smallest_eigvec_psd)

_EPS = 1e-12
_N_STARTS = 64
_N_GN = 16
_MAX_SOL = 10
_DEDUPE_DOT = 0.9999

# The JAX module's starts: float64 normals of default_rng(42), normalized,
# then cast to float32.
_STARTS_NP = np.random.default_rng(42).normal(size=(_N_STARTS, 4))
_STARTS_NP /= np.linalg.norm(_STARTS_NP, axis=1, keepdims=True)
_STARTS = _STARTS_NP.astype(np.float32)
_STARTS_ON = {}  # device -> _STARTS there, copied once


def _starts(dev):
    """_STARTS as a tensor on `dev`, copied to a device once."""
    t = _STARTS_ON.get(dev)
    if t is None:
        t = _STARTS_ON[dev] = torch.as_tensor(_STARTS, device=dev)
    return t


def _t(M):
    return M.transpose(-1, -2)


def _mm(A, B):
    """Products of 3x3 matrices stored lanes last, A [3, 3, *lanes] @ B
    [3, 3, *lanes] (the lanes broadcast), as elementwise products summed
    over the inner index: every lane's bits are its own, and the inner
    loops run over the contiguous lanes."""
    return (A[:, :, None] * B[None]).sum(1)


def _tr(M):
    return M.transpose(0, 1)


def _constraint_parts(E):
    """(E E^T, its trace, the ten Demazure constraints [10, *lanes]) of E
    [3, 3, *lanes]: det E, then 2 E E^T E - tr(E E^T) E row-major."""
    A = _mm(E, _tr(E))
    tr = A[0, 0] + A[1, 1] + A[2, 2]
    C = 2.0 * _mm(A, E) - tr * E
    return A, tr, torch.cat([det3(E.movedim((0, 1), (-2, -1)))[None], C.flatten(0, 1)])


def _constraints(E):
    """The ten Demazure constraints of E [3, 3, *lanes] -> [10, *lanes]."""
    return _constraint_parts(E)[2]


def _constraints_and_jacobian(E, Ek):
    """The constraints r [10, *lanes] at E [3, 3, *lanes] and their
    Jacobian [10, 4, *lanes] in the coefficients q of E = sum_k q_k E_k,
    Ek [3, 3, 4, *lanes]."""
    A, tr, r = _constraint_parts(E)
    # The cofactor matrix, row i = (row i+1) x (row i+2): d det / dE.
    cof = torch.linalg.cross(E.roll(-1, 0), E.roll(1, 0), dim=1)  # rows [1, 2, 0], [2, 0, 1]

    e = E[:, :, None]  # against the k axis of Ek
    d_det = (cof[:, :, None] * Ek).sum((0, 1))  # [4, *lanes]
    inner = (e * Ek).sum((0, 1))  # <E, E_k>
    dC = (2.0 * (_mm(Ek, _mm(_tr(E), E)[:, :, None]) + _mm(e, _mm(_tr(Ek), e))
                 + _mm(A[:, :, None], Ek))
          - 2.0 * inner * e - tr[None] * Ek)
    return r, torch.cat([d_det[None], dC.flatten(0, 1)])


def _combine(q, Es):
    """sum_k q_k E_k, batch first: q [B, S, 4], Es [B, 4, 3, 3] -> [B, S, 3, 3]."""
    return (q[..., None, None] * Es[:, None]).sum(-3)


def _gauss_newton(Es):
    """The 64 starts' damped tangent-space Gauss-Newton runs on the bases
    Es [B, 4, 3, 3]. Returns (q [B, 64, 4] unit, |r(q)| [B, 64]).

    The lanes (sample, start) are the last, contiguous axis of every
    tensor here: a sample's basis is copied to its 64 lanes once, and each
    step is a few elementwise expressions over [.., B * 64]."""
    b, s = Es.shape[0], _N_STARTS
    dtype, dev = Es.dtype, Es.device
    Ek = Es.permute(2, 3, 1, 0)[..., None].expand(3, 3, 4, b, s).reshape(3, 3, 4, b * s)
    q = _starts(dev).to(dtype).T[:, None, :]
    q = q.expand(4, b, s).reshape(4, b * s)
    eye = 1e-9 * torch.eye(4, dtype=dtype, device=dev)
    for _ in range(_N_GN):
        r, J = _constraints_and_jacobian((q * Ek).sum(2), Ek)
        # The radial direction is a null direction of J at a root (J q =
        # 3 r, Euler): projected out of J and of the step.
        Jt = J - (J * q).sum(1)[:, None] * q
        H = (Jt[:, :, None] * Jt[:, None]).sum(0).permute(2, 0, 1) + eye
        g = (Jt * r[:, None]).sum(0).T
        d = gauss_jordan_solve(H, g[..., None])[..., 0].T
        d = d - (d * q).sum(0) * q
        q = q - d
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=0), min=_EPS)
    res = torch.linalg.vector_norm(_constraints((q * Ek).sum(2)), dim=0)
    return q.T.reshape(b, s, 4), res.reshape(b, s)


def _minimal_batched(samples):
    """Five-point solver. samples [B, 5, 4] -> (descs [B, 10, 9], valid
    [B, 10] bool)."""
    dtype = samples.dtype
    x1, y1 = samples[..., 0], samples[..., 1]
    x2, y2 = samples[..., 2], samples[..., 3]
    A = _epipolar_rows(samples[..., :2], samples[..., 2:4], torch.ones_like(x1))
    basis, ns_ok = nullspace_exact(A, 4)  # [B, 4, 9]
    basis, ns_ok = orthonormalize_rows(basis, ns_ok)
    Es = basis.reshape(-1, 4, 3, 3)
    q, res = _gauss_newton(Es)

    # Greedy dedupe into _MAX_SOL solutions (q and -q are one solution);
    # argmin takes the first index on ties, as jnp.argmin.
    score = torch.where(res < 1e-4, res, torch.inf)
    out_q, out_ok = [], []
    for _ in range(_MAX_SOL):
        i = score.argmin(-1, keepdim=True)
        out_ok.append(torch.isfinite(score.gather(-1, i))[:, 0])
        qi = q.gather(1, i[..., None].expand(-1, 1, 4))  # [B, 1, 4]
        out_q.append(qi[:, 0])
        score = torch.where((q * qi).sum(-1).abs() > _DEDUPE_DOT, torch.inf, score)
    Q = torch.stack(out_q, 1)  # [B, 10, 4]
    okv = torch.stack(out_ok, 1)

    E = _combine(Q, Es)
    nrm = torch.sqrt((E * E).sum((-2, -1)))
    E = E / torch.clamp(nrm, min=_EPS)[..., None, None]
    ones = torch.ones_like(x1)
    x1h = torch.stack([x1, y1, ones], -1)[:, None, :, :]  # [B, 1, 5, 3]
    x2h = torch.stack([x2, y2, ones], -1)[:, None, :, :]
    lines = (E[:, :, None, :, :] * x1h[..., None, :]).sum(-1)  # E x1_i: [B, 10, 5, 3]
    epip = (x2h * lines).sum(-1).abs().amax(-1)
    valid = okv & ns_ok[:, None] & torch.isfinite(E).all(-1).all(-1) & (epip < 1e-3)

    # Oriented epipolar constraint on the sample, as the fundamental
    # family's: e2 from the best-conditioned pair of E's columns.
    col_cross = torch.stack([
        torch.linalg.cross(E[..., :, 0], E[..., :, 1], dim=-1),
        torch.linalg.cross(E[..., :, 0], E[..., :, 2], dim=-1),
        torch.linalg.cross(E[..., :, 1], E[..., :, 2], dim=-1),
    ], dim=-2)  # [B, 10, 3(pair), 3]
    pick = torch.nn.functional.one_hot((col_cross * col_cross).sum(-1).argmax(-1), 3)
    e2 = (col_cross * pick.to(dtype)[..., None]).sum(-2)  # [B, 10, 3]
    e2b, x2b = torch.broadcast_tensors(e2[:, :, None, :], x2h)
    s = (torch.linalg.cross(e2b, x2b, dim=-1) * lines).sum(-1)  # [B, 10, 5]
    valid = valid & ((s > 0.0).all(-1) | (s < 0.0).all(-1))
    return E.reshape(-1, _MAX_SOL, 9), valid


def _complement_basis(v):
    """Orthonormal bases [..., 3, 2] of the planes orthogonal to unit
    vectors v [..., 3]."""
    t = torch.nn.functional.one_hot(v.abs().argmin(-1), 3).to(v.dtype)
    a = t - (t * v).sum(-1, keepdim=True) * v
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=_EPS)
    b = torch.linalg.cross(v, a, dim=-1)
    return torch.stack([a, b], -1)


def _project_essential(E):
    """The nearest essential matrix to E [..., 3, 3] (equal leading
    singular values, zero smallest), unit norm, without decomposing the
    degenerate leading singular pair: the smallest singular pair by
    inverse iteration, the leading 2x2 block in the complements by its
    closed-form polar factor (rotation branch for det >= 0, reflection
    otherwise) and s1 + s2."""
    v3 = smallest_eigvec_psd(matmul_small(_t(E), E))
    u3 = smallest_eigvec_psd(matmul_small(E, _t(E)))
    Bv = _complement_basis(v3)
    Bu = _complement_basis(u3)
    M2 = matmul_small(matmul_small(_t(Bu), E), Bv)  # [..., 2, 2]
    a, b = M2[..., 0, 0], M2[..., 0, 1]
    c, d = M2[..., 1, 0], M2[..., 1, 1]
    h_rot = torch.sqrt(torch.clamp((a + d) ** 2 + (b - c) ** 2, min=_EPS))
    h_ref = torch.sqrt(torch.clamp((a - d) ** 2 + (b + c) ** 2, min=_EPS))
    Q_rot = torch.stack([torch.stack([a + d, b - c], -1),
                         torch.stack([c - b, a + d], -1)], -2) / h_rot[..., None, None]
    Q_ref = torch.stack([torch.stack([a - d, b + c], -1),
                         torch.stack([b + c, d - a], -1)], -2) / h_ref[..., None, None]
    pos = (a * d - b * c) >= 0.0
    Q = torch.where(pos[..., None, None], Q_rot, Q_ref)
    ssum = torch.where(pos, h_rot, h_ref)  # s1 + s2
    Ep = 0.5 * ssum[..., None, None] * matmul_small(matmul_small(Bu, Q), _t(Bv))
    nrm = torch.sqrt((Ep * Ep).sum((-2, -1)))
    return Ep / torch.clamp(nrm, min=_EPS)[..., None, None]


def _nonminimal(data, weights):
    """Weighted eight-point solve projected onto the essential manifold
    (calibrated coordinates: no Hartley transform). data [N, 4] or
    [R, N, 4], weights [(R,) ..., N] -> (descs [(R,) ..., 9], valid
    [(R,) ...])."""
    sw = torch.sqrt(torch.clamp(weights, min=0.0))
    A = _epipolar_rows(row_view(data[..., :2], data, weights, 2),
                       row_view(data[..., 2:4], data, weights, 2), sw)
    e = smallest_eigvec_psd(gram(A, A))
    E = _project_essential(e.reshape(*weights.shape[:-1], 3, 3))
    valid = torch.isfinite(E).all(-1).all(-1) & ((weights > 0).sum(-1) >= 8)
    return E.reshape(*weights.shape[:-1], 9), valid


ESSENTIAL = register_family(
    ModelFamily(
        name="essential",
        sample_size=5,
        nonminimal_min=8,
        max_solutions=_MAX_SOL,
        desc_dim=9,
        minimal_solver_batched=_minimal_batched,
        nonminimal_solver=_nonminimal,
        # The squared Sampson distance, the fundamental family's function
        # itself, op for op the kernel's.
        squared_residual=_squared_residual,
        scorer=score_fundamental,
    )
)
