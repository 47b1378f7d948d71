"""The dispatch of ops/linalg.smallest_eigvec_psd (kernels/linalg.py) on
the CPU: a CPU tensor takes the plain version, bit for bit the solver as
it ran before the kernel (`_before`, kept here as it was), and the checks
that guard the CUDA kernel refuse what it does not take without a device
(meta tensors). tests/test_torch_eigvec_cuda.py holds the kernel to the
plain version on the card; tests/test_torch_linalg.py the plain version
to the JAX package's."""

import numpy as np
import pytest
import torch

from progressivex_tpu_torch.kernels import _build
from progressivex_tpu_torch.kernels import linalg as klinalg
from progressivex_tpu_torch.ops import linalg as tl


def _before(M, iters=6):
    n = M.shape[-1]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / n
    shift = torch.clamp(1e-6 * tr, min=1e-12)
    Ms = M + shift[..., None, None] * torch.eye(n, dtype=M.dtype, device=M.device)
    v = torch.arange(1, n + 1, dtype=M.dtype, device=M.device)
    v = (v / torch.linalg.vector_norm(v)).expand(*M.shape[:-2], n)
    for _ in range(iters):
        v = tl.gauss_jordan_solve(Ms, v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    return v


def _grams(shape, n, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    X = r.normal(size=(*shape, 3 * n, n))
    X[..., 0, :] *= 1e3  # one heavy row, as a DLT's pixel-scale rows give
    return torch.from_numpy(np.einsum("...ki,...kj->...ij", X, X).astype(dtype))


@pytest.mark.parametrize("n,shape", [(3, (4, 10)), (9, (1, 20)), (9, (4, 10)), (12, (5,)),
                                     (4, (6,)), (2, ())])
def test_cpu_takes_the_plain_path_bit_for_bit(n, shape):
    M = _grams(shape, n, n)
    M.view(-1, n, n)[0, 0] = 0.0  # a zero row among the batch
    before = dict(_build.LAUNCHES)
    for iters in (6, 2):
        got = tl.smallest_eigvec_psd(M) if iters == 6 else tl.smallest_eigvec_psd(M, iters)
        want = _before(M, iters)
        assert got.shape == (*shape, n)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert _build.LAUNCHES == before  # the plain version is no launch


def test_cpu_degenerate_and_float64_bit_for_bit():
    M = _grams((6,), 9, 1)
    M[1] = 0.0
    M[2, 3, 4] = float("inf")
    M[3, 0, 0] = float("nan")
    M[4, :, 8] = 0.0
    M[4, 8, :] = 0.0
    got = tl.smallest_eigvec_psd(M)
    assert torch.equal(torch.isfinite(got), torch.isfinite(_before(M)))
    assert torch.equal(got.nan_to_num().view(torch.int32),
                       _before(M).nan_to_num().view(torch.int32))
    assert not torch.isfinite(got[2]).any() and not torch.isfinite(got[3]).any()
    assert torch.isfinite(got[[0, 1, 4, 5]]).all()
    M64 = _grams((3,), 9, 2, np.float64)
    assert torch.equal(tl.smallest_eigvec_psd(M64), _before(M64))


@pytest.mark.parametrize("shape,dtype,why", [
    ((4, 9, 9), torch.float64, "float32"),
    ((4, 9, 9), torch.bfloat16, "float32"),
    ((4, 9, 8), torch.float32, "expected"),
    ((9,), torch.float32, "expected"),
    ((4, 4, 4), torch.float32, "n in"),
    ((4, 10, 10), torch.float32, "n in"),
    ((2, 2), torch.float32, "n in"),
])
def test_check_refuses_what_the_kernel_does_not_take(shape, dtype, why):
    M = torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match=why):
        klinalg._check(M)


def test_check_takes_the_sizes_and_refuses_strided_matrices():
    for n in klinalg.SIZES:
        klinalg._check(torch.empty(2, 3, n, n, device="meta"))
    M = torch.empty(4, 9, 9, device="meta")
    with pytest.raises(ValueError, match="contiguous"):
        klinalg._check(M.transpose(-1, -2))
    with pytest.raises(ValueError, match="contiguous"):
        klinalg._check(torch.empty(9, 9, device="meta").expand(4, 9, 9))


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no eigvec_psd kernel"):
        klinalg.smallest_eigvec_psd(torch.empty(2, 9, 9, device="meta"))
