"""The port's CUDA scoring kernels on the card (homography and
fundamental), against their plain torch versions on the same CUDA tensors.

These tests need a CUDA device and nvcc. They import neither JAX nor the
JAX package, so that they also run where JAX is not installed:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Elsewhere they skip. Tolerances: inlier counts exact; scores, dots and
norms rtol 1e-3 and atol 1e-2 (the kernel sums in a fixed warp order, the
plain version in torch's reduction order).
"""

import numpy as np
import pytest
import torch

from progressivex_tpu_torch.kernels import scoring as kscoring
from progressivex_tpu_torch.models import fundamental, homography

TRUNC_SQ, EXPONENT = 25.0, 2.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _case(dev, b=96, n=300, seed=0, family=homography, m=4):
    r = np.random.default_rng(seed)
    data = torch.as_tensor(r.uniform(-50, 50, (n, 4)), dtype=torch.float32)
    idx = torch.as_tensor(r.integers(0, n, (b, m)))
    descs, _ = family._minimal_batched(data[idx])
    descs = descs.reshape(-1, 9)
    descs = descs[torch.isfinite(descs).all(1)][:b]
    compound = torch.as_tensor(r.uniform(0, 1, n), dtype=torch.float32)
    pmask = torch.as_tensor(r.uniform(size=n) > 0.15)
    return [t.to(dev).contiguous() for t in (data, descs, compound, pmask)]


def _check(got, want):
    for g, w, name in zip(got, want, ("scores", "inliers", "dots", "norms")):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if name == "inliers":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-2, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("magsac_levels", [0, 4])
@pytest.mark.parametrize("has_compound", [False, True])
def test_kernel_matches_plain(cuda, magsac_levels, has_compound):
    args = _case(cuda)
    before = kscoring.LAUNCHES["score_homography"]
    got = kscoring.score_homography(*args, TRUNC_SQ, EXPONENT, has_compound,
                                    magsac_levels)
    torch.cuda.synchronize()
    assert kscoring.LAUNCHES["score_homography"] == before + 1
    want = kscoring.score_homography_plain(*args, TRUNC_SQ, EXPONENT,
                                           has_compound, magsac_levels)
    _check(got, want)


@pytest.mark.cuda
def test_kernel_padding_independence(cuda):
    data, descs, compound, pmask = _case(cuda, n=256)
    base = kscoring.score_homography(data, descs, compound, pmask, TRUNC_SQ,
                                     EXPONENT, True)
    bad = torch.where(pmask[:, None], data, 1e6)
    got = kscoring.score_homography(bad, descs, compound, pmask, TRUNC_SQ,
                                    EXPONENT, True)
    for g, b in zip(got, base):
        np.testing.assert_allclose(g.cpu().numpy(), b.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_kernel_rejects_bad_shapes(cuda):
    data, descs, compound, pmask = _case(cuda)
    with pytest.raises(ValueError, match="shapes"):
        kscoring.score_homography(data[:, :3], descs, compound, pmask,
                                  TRUNC_SQ, EXPONENT, True)
    with pytest.raises(ValueError, match="is on"):
        kscoring.score_homography(data, descs.cpu(), compound, pmask,
                                  TRUNC_SQ, EXPONENT, True)


@pytest.mark.cuda
@pytest.mark.parametrize("magsac_levels", [0, 4])
@pytest.mark.parametrize("has_compound", [False, True])
def test_fundamental_kernel_matches_plain(cuda, magsac_levels, has_compound):
    args = _case(cuda, family=fundamental, m=7)
    before = kscoring.LAUNCHES["score_fundamental"]
    got = kscoring.score_fundamental(*args, TRUNC_SQ, EXPONENT, has_compound,
                                     magsac_levels)
    torch.cuda.synchronize()
    assert kscoring.LAUNCHES["score_fundamental"] == before + 1
    want = kscoring.score_fundamental_plain(*args, TRUNC_SQ, EXPONENT,
                                            has_compound, magsac_levels)
    _check(got, want)


@pytest.mark.cuda
def test_fundamental_kernel_padding_independence(cuda):
    data, descs, compound, pmask = _case(cuda, n=256, family=fundamental, m=7)
    base = kscoring.score_fundamental_cuda(data, descs, compound, pmask, TRUNC_SQ,
                                           EXPONENT, True, 4)
    bad = torch.where(pmask[:, None], data, 1e6)
    got = kscoring.score_fundamental_cuda(bad, descs, compound, pmask, TRUNC_SQ,
                                          EXPONENT, True, 4)
    for g, b in zip(got, base):
        np.testing.assert_allclose(g.cpu().numpy(), b.cpu().numpy(), rtol=1e-5)
