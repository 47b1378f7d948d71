"""The smallest eigenvector of small symmetric PSD matrices: the CUDA
kernel (csrc/eigvec_psd.cu) and its plain torch version.

`smallest_eigvec_psd(M [..., n, n], iters)` returns [..., n]: shifted
inverse iteration, `iters` solves by the unrolled Gauss-Jordan of
ops/linalg.py from the start vector (1, ..., n) / |(1, ..., n)|, each
solution over its norm. ops/linalg.smallest_eigvec_psd, which every
weighted refit calls, routes here. The JAX package leaves the solver to
XLA (progressivex_tpu/ops/linalg.py:405); the plain version launches
about 1,460 operations a call at n = 9, the kernel one.

Dispatch and launch (kernels/_build.py): a CPU tensor takes the plain
version, of any type and size; a CUDA tensor launches the kernel or
raises (`_check`: float32, contiguous, square, n in SIZES). The launch
goes to the matrices' device, on its current stream, and counts in
`_build.LAUNCHES` and `_build.UNITS` (the matrices it solved).

Tolerance against the plain version on the same CUDA tensor: the kernel
takes the trace and each squared norm in index order, torch's reductions
in their own, so the two may differ in the last bits of those sums;
every other operation is the plain version's, one rounding each, and a
matrix gives a non-finite result exactly where the plain version does.
"""

from __future__ import annotations

import ctypes

import torch

from progressivex_tpu_torch.kernels import _build

SIZES = (3, 9, 12)
# matrices, batch, n, iters, out
_ARGS = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def _check(M):
    """Raise ValueError unless the kernel takes M [..., n, n]."""
    if M.dtype != torch.float32:
        raise ValueError(f"matrices of type {M.dtype}: the kernel takes float32")
    if M.ndim < 2 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"matrices of shape {tuple(M.shape)}: expected [..., n, n]")
    if M.shape[-1] not in SIZES:
        raise ValueError(f"n = {M.shape[-1]}: the kernel takes n in {SIZES}")
    if not M.is_contiguous():
        raise ValueError("the kernel takes contiguous matrices")


def smallest_eigvec_psd_plain(M, iters: int = 6):
    """The function the kernel computes, in plain torch."""
    from progressivex_tpu_torch.ops.linalg import _EPS, gauss_jordan_solve

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


def smallest_eigvec_psd_cuda(M, iters: int = 6):
    """Launch csrc/eigvec_psd.cu's kernel on CUDA matrices."""
    _check(M)
    dev = M.device
    n = M.shape[-1]
    out = torch.empty(M.shape[:-1], dtype=torch.float32, device=dev)
    batch = out.numel() // n
    if batch:
        _build.launch("eigvec_psd", dev, batch, _ARGS, M.data_ptr(), batch, n, int(iters),
                      out.data_ptr())
    return out


def smallest_eigvec_psd(M, iters: int = 6):
    """The plain version for CPU matrices, the CUDA kernel for CUDA
    matrices."""
    return _build.dispatch("eigvec_psd", M.device, smallest_eigvec_psd_plain,
                           smallest_eigvec_psd_cuda)(M, iters)
