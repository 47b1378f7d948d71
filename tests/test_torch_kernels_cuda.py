"""The port's CUDA scoring kernels on the card (homography and
fundamental), against their plain torch versions on the same CUDA tensors.

These tests need a CUDA device and nvcc. They import neither JAX nor the
JAX package, so that they also run where JAX is not installed:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Elsewhere they skip. Tolerances: inlier counts exact; scores, dots and
norms rtol 1e-3 and atol 1e-2 (the kernel sums in a fixed order of lanes,
warps and cluster ranks, the plain version in torch's reduction order).
Two launches on the same inputs must agree bit for bit.
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
@pytest.mark.parametrize("magsac_levels", [0, 3, 4])
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
@pytest.mark.parametrize("magsac_levels", [0, 3, 4])
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


FAMILIES = {"homography": (homography, 4), "fundamental": (fundamental, 7)}


def _shape_case(dev, family, b, n, seed=0):
    """b finite minimal-solve descriptors of `family` on n random points;
    the last 13 points and about 15% of the rest are masked, so the valid
    count is a multiple of no tile size."""
    fam, m = FAMILIES[family]
    r = np.random.default_rng(seed)
    data = torch.as_tensor(r.uniform(-50, 50, (n, 4)), dtype=torch.float32)
    idx = torch.as_tensor(r.integers(0, n, (2 * b, m)))
    descs, _ = fam._minimal_batched(data[idx])
    descs = descs.reshape(-1, 9)
    descs = descs[torch.isfinite(descs).all(1)][:b]
    assert descs.shape[0] == b
    compound = torch.as_tensor(r.uniform(0, 1, n), dtype=torch.float32)
    pmask = torch.as_tensor(r.uniform(size=n) > 0.15) & (torch.arange(n) < n - 13)
    return [t.to(dev).contiguous() for t in (data, descs, compound, pmask)]


def _score(family):
    return getattr(kscoring, f"score_{family}_cuda"), \
        getattr(kscoring, f"score_{family}_plain")


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("b", [1, 4, 5, 256, 600, 1536, 2049])
@pytest.mark.parametrize("n", [128, 300, 384, 2304, 7680])
def test_kernel_shapes_match_plain(cuda, family, b, n):
    """Every tiling the wrapper picks (hypothesis tiles, cluster split,
    ring stages, ragged tails) against the plain version."""
    args = _shape_case(cuda, family, b, n)
    cuda_fn, plain_fn = _score(family)
    got = cuda_fn(*args, TRUNC_SQ, EXPONENT, True, 4)
    torch.cuda.synchronize()
    _check(got, plain_fn(*args, TRUNC_SQ, EXPONENT, True, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("b, n", [(256, 2304), (4, 2304)])
def test_kernel_all_masked(cuda, family, b, n):
    data, descs, compound, pmask = _shape_case(cuda, family, b, n)
    scores, inliers, dots, norms = _score(family)[0](
        data, descs, compound, torch.zeros_like(pmask), TRUNC_SQ, EXPONENT, True, 4)
    for t in (scores, dots, norms):
        assert torch.equal(t, torch.zeros_like(t))
    assert torch.equal(inliers, torch.zeros_like(inliers))


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("b, n", [(256, 2304), (4, 2304), (1536, 256)])
def test_kernel_nan_descriptor_is_isolated(cuda, family, b, n):
    """A NaN descriptor row leaves every other row's outputs unchanged."""
    data, descs, compound, pmask = _shape_case(cuda, family, b, n)
    cuda_fn = _score(family)[0]
    base = cuda_fn(data, descs, compound, pmask, TRUNC_SQ, EXPONENT, True, 4)
    bad = descs.clone()
    bad[1 % b] = float("nan")
    got = cuda_fn(data, bad, compound, pmask, TRUNC_SQ, EXPONENT, True, 4)
    keep = torch.arange(b, device=cuda) != 1 % b
    for g, w in zip(got, base):
        assert torch.equal(g[keep], w[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("b, n", [(256, 2304), (4, 2304), (1536, 256), (4, 7680)])
def test_kernel_is_deterministic(cuda, family, b, n):
    args = _shape_case(cuda, family, b, n)
    cuda_fn = _score(family)[0]
    first = cuda_fn(*args, TRUNC_SQ, EXPONENT, True, 4)
    second = cuda_fn(*args, TRUNC_SQ, EXPONENT, True, 4)
    for g, w in zip(first, second):
        assert torch.equal(g, w)


# Every tiling that kernels/scoring._tiling can pick: K hypotheses a block,
# S blocks a cluster, threads a block.
TILINGS = [(k, s, t) for k in (1, 2, 4) for s in range(1, 9) for t in (128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("b, n", [(5, 2001), (600, 7680), (3, 100)])
def test_every_tiling_matches_plain(cuda, family, b, n):
    """Each (K, S, threads) through the C entry point against the plain
    version, all four outputs: a hypothesis tile past B (K = 4 at B = 5),
    many ring stages (S = 1 at N = 7680), ragged rank ends (N = 2001) and
    cluster ranks with no points (S = 8 at N = 100)."""
    data, descs, compound, pmask = _shape_case(cuda, family, b, n)
    name = f"score_{family}"
    kernel = kscoring._kernel(name)
    want = _score(family)[1](data, descs, compound, pmask, TRUNC_SQ, EXPONENT,
                             True, 4)
    failed = []
    for tiling in TILINGS:
        outs = [torch.full((b,), float("nan"), device=cuda) for _ in range(3)]
        inliers = torch.full((b,), -1, dtype=torch.int32, device=cuda)
        err = kernel(data.data_ptr(), compound.data_ptr(), pmask.data_ptr(),
                     descs.data_ptr(), b, n, TRUNC_SQ, EXPONENT, 1, 4, *tiling,
                     outs[0].data_ptr(), inliers.data_ptr(), outs[1].data_ptr(),
                     outs[2].data_ptr(), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0, f"{tiling}: CUDA error {err}"
        try:
            _check((outs[0], inliers, outs[1], outs[2]), want)
        except AssertionError as e:
            failed.append(f"{tiling}: {e}")
    assert not failed, "\n".join(failed)
