"""The PnP family's warm-started refit, six weighted Gauss-Newton steps on
the reprojection error: the CUDA kernel (csrc/pnp_refine.cu) and its
plain torch version.

`refine(data, weights, init_desc, n_iters)` returns (descs, valid):
data [N, 5] or [R, N, 5] (normalized x, y and world X, Y, Z), weights
[(R,) ..., N], init_desc [(R,) ..., 12] (row-major [R | t]). Every step
projects the points, builds the 2 x 6 Jacobian of each (left update of
R, then t), sums H = sum Jw^T J + 1e-8 I and g = sum Jw^T r over the
points and solves the 6x6 system by LU with partial pivoting; R <-
exp(d_omega) R by Rodrigues, t <- t + d_t. An invalid refit (non-finite,
or fewer than 3 positive weights) returns its start.
models/pnp._refine, the family's `refine_solver`, which the LO, PEARL,
merge and polish refits call, routes here. The JAX package's counterpart
is the `lax.scan` in progressivex_tpu/models/pnp.py:187-241, which XLA
lowers inside its compiled fit; the plain version launches about 98
operations a step, 590 a call, the kernel one.

Dispatch and launch (kernels/_build.py): a CPU tensor takes the plain
version, of any type and shape. On a CUDA tensor the call's middle axes
(the same for the weights and the starts) are flattened into P problems
a row (a copy where they are strided) and the kernel runs or the call
raises (`_check`: float32, contiguous, data [R, N, 5], weights [R, P, N],
init [R, P, 12]). The launch goes to the data's device, on its current
stream, and counts in `_build.LAUNCHES` and `_build.UNITS` (the (row,
instance) problems it refit).

Tolerance against the plain version on the same CUDA tensors: every
point's terms are the plain version's operations, one rounding each, but
the kernel sums the upper triangle of H (and mirrors it) and g over the
points in its own fixed order, where the plain version pairs the padded
point axis in `row_sum`'s tree and forms both triangles; its LU is its
own, the plain version's cuBLAS's. So the two differ in the last bits of
each step's sums and solve, which six steps carry into the pose
(tests/test_torch_pnp_refine_cuda.py states the bound). A refit is
non-finite, and invalid, exactly where the plain version's is.
"""

from __future__ import annotations

import ctypes
import math

import torch

from progressivex_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
# data, weights, starts, R, P, N, steps, descs, valid
_ARGS = (_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P, _P)


def refine_plain(data, weights, init_desc, n_iters: int = 6):
    """The function the kernel computes, in plain torch."""
    from progressivex_tpu_torch.models.base import row_view
    from progressivex_tpu_torch.models.pnp import _pose_desc, _skew, _so3_exp
    from progressivex_tpu_torch.ops.linalg import matmul_small, row_sum

    Pm = init_desc.reshape(*init_desc.shape[:-1], 3, 4)
    R, t = Pm[..., :3], Pm[..., 3]
    Xw = row_view(data[..., 2:5], data, weights, 2)  # [(R,) 1.., N, 3]
    obs = row_view(data[..., :2], data, weights, 2)
    w = torch.clamp(weights, min=0.0)
    eye6 = 1e-8 * torch.eye(6, dtype=data.dtype, device=data.device)
    for _ in range(n_iters):
        q = (Xw[..., :, None, :] * R[..., None, :, :]).sum(-1) + t[..., None, :]  # [.., N, 3]
        z = q[..., 2]
        front = z > 1e-6
        invz = 1.0 / torch.where(front, z, 1.0)
        r = q[..., :2] * invz[..., None] - obs  # [..., N, 2]
        zero = torch.zeros_like(z)
        Jq = torch.stack([  # d proj / d q, [..., N, 2, 3]
            torch.stack([invz, zero, -q[..., 0] * invz * invz], -1),
            torch.stack([zero, invz, -q[..., 1] * invz * invz], -1)], -2)
        # d q / d omega = -[R X]_x (left update), d q / d t = I
        J = torch.cat([matmul_small(Jq, -_skew(q - t[..., None, :])), Jq], -1)
        Jw = J * (w * front)[..., None, None]
        H = row_sum((Jw[..., :, :, None] * J[..., :, None, :]).sum(-3), -3) + eye6
        g = row_sum((Jw * r[..., None]).sum(-2), -2)
        d = torch.linalg.solve_ex(H, -g[..., None])[0][..., 0]
        R = matmul_small(_so3_exp(d[..., :3]), R)
        t = t + d[..., 3:]
    desc = _pose_desc(R, t)
    ok = torch.isfinite(desc).all(-1) & ((w > 0).sum(-1) >= 3)
    return torch.where(ok[..., None], desc, init_desc), ok


def _check(data, weights, init_desc):
    """Raise ValueError unless the kernel takes data [R, N, 5], weights
    [R, P, N] and init_desc [R, P, 12]."""
    for name, x in (("data", data), ("weights", weights), ("init_desc", init_desc)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} of type {x.dtype}: the kernel takes float32")
        if x.ndim != 3:
            raise ValueError(f"{name} of shape {tuple(x.shape)}: expected rank 3")
        if not x.is_contiguous():
            raise ValueError(f"the kernel takes contiguous {name}")
    rows, n, cols = data.shape
    if cols != 5:
        raise ValueError(f"data of shape {tuple(data.shape)}: expected [R, N, 5]")
    if weights.shape[0] != rows or weights.shape[2] != n:
        raise ValueError(f"weights of shape {tuple(weights.shape)}: expected "
                         f"[{rows}, P, {n}]")
    if init_desc.shape != (rows, weights.shape[1], 12):
        raise ValueError(f"init_desc of shape {tuple(init_desc.shape)}: expected "
                         f"[{rows}, {weights.shape[1]}, 12]")


def refine_cuda(data, weights, init_desc, n_iters: int = 6):
    """Launch csrc/pnp_refine.cu's kernel on CUDA tensors data [R, N, 5],
    weights [R, P, N], init_desc [R, P, 12]. Returns (descs
    [R, P, 12], valid [R, P])."""
    _check(data, weights, init_desc)
    dev = data.device
    rows, n = data.shape[:2]
    problems = weights.shape[1]
    out = torch.empty(init_desc.shape, dtype=torch.float32, device=dev)
    ok = torch.empty(init_desc.shape[:-1], dtype=torch.bool, device=dev)
    if rows * problems:
        _build.launch("pnp_refine", dev, rows * problems, _ARGS, data.data_ptr(),
                      weights.data_ptr(), init_desc.data_ptr(), rows, problems, n,
                      int(n_iters), out.data_ptr(), ok.data_ptr())
    return out, ok


def refine(data, weights, init_desc, n_iters: int = 6):
    """The plain version for CPU tensors; for CUDA tensors the kernel, on
    the call's middle axes flattened: weights [(R,) ..., N] and init_desc
    [(R,) ..., 12] with the same middle axes, P their size."""
    return _build.dispatch("pnp_refine", data.device, refine_plain, _refine_flat)(
        data, weights, init_desc, n_iters)


def _refine_flat(data, weights, init_desc, n_iters):
    """`refine_cuda` on the call's middle axes flattened."""
    rows = data.shape[0] if data.ndim == 3 else 1
    n = data.shape[-2]
    p = math.prod(init_desc.shape[data.ndim - 2:-1])
    out, ok = refine_cuda(data.reshape(rows, n, data.shape[-1]).contiguous(),
                          weights.reshape(rows, p, n).contiguous(),
                          init_desc.reshape(rows, p, 12).contiguous(), n_iters)
    return out.reshape(init_desc.shape), ok.reshape(init_desc.shape[:-1])
