"""Parity of the port's scoring (ops/scoring and the plain version of the
fused kernel, kernels/scoring) with the JAX package's
compound_penalized_scores and with its Pallas kernel run in interpret mode,
on the cases of tests/test_pallas_scoring.py (b=96, n=300).

Tolerances: inlier counts exact; scores, dots and norms rtol 1e-3 and atol
1e-2 (the JAX test's), for float32 sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivex_tpu.models import get_family as jax_family
from progressivex_tpu.ops import pallas_scoring
from progressivex_tpu.ops import scoring as jax_scoring

from progressivex_tpu_torch.kernels import scoring as kscoring
from progressivex_tpu_torch.models.homography import _squared_residual
from progressivex_tpu_torch.ops import scoring

TRUNC_SQ, EXPONENT = 25.0, 2.0


def _case(b=96, n=300, seed=0):
    r = np.random.default_rng(seed)
    fam = jax_family("homography")
    data = r.uniform(-50, 50, (n, 4)).astype(np.float32)
    idx = r.integers(0, n, (b, 4))
    descs, _ = fam.minimal_solver_batched(jnp.array(data)[jnp.array(idx)])
    descs = np.asarray(descs.reshape(-1, 9))
    descs = descs[np.isfinite(descs).all(axis=1)][:b]
    compound = r.uniform(0, 1, n).astype(np.float32)
    pmask = r.uniform(size=n) > 0.15
    return data, descs, compound, pmask


def _check(got, want, label):
    for g, w, name in zip(got, want, ("scores", "inliers", "dots", "norms")):
        g, w = np.asarray(g), np.asarray(w)
        if name == "inliers":
            np.testing.assert_array_equal(g, w, err_msg=f"{label}/{name}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-2,
                                       err_msg=f"{label}/{name}")


def _torch_inputs(data, descs, compound, pmask):
    return (torch.from_numpy(data), torch.from_numpy(descs),
            torch.from_numpy(compound), torch.from_numpy(pmask))


@pytest.mark.parametrize("magsac_levels", [0, 4])
@pytest.mark.parametrize("has_compound", [False, True])
def test_scores_match_jax(magsac_levels, has_compound):
    data, descs, compound, pmask = _case()
    fam = jax_family("homography")
    r2 = jax.vmap(fam.squared_residual, in_axes=(None, 0))(
        jnp.array(data), jnp.array(descs))
    want = jax_scoring.compound_penalized_scores(
        r2, jnp.array(compound), jnp.array(pmask), TRUNC_SQ, EXPONENT,
        has_compound, magsac_levels=magsac_levels)
    td, tdesc, tc, tm = _torch_inputs(data, descs, compound, pmask)
    got = scoring.compound_penalized_scores(
        _squared_residual(td, tdesc), tc, tm, TRUNC_SQ, EXPONENT, has_compound,
        magsac_levels)
    _check(got, want, "ops.scoring")
    got = kscoring.score_homography(td, tdesc, tc, tm, TRUNC_SQ, EXPONENT,
                                    has_compound, magsac_levels)
    _check(got, want, "kernels.scoring (CPU)")


@pytest.mark.parametrize("magsac_levels", [0, 4])
def test_plain_kernel_matches_pallas_interpret(magsac_levels):
    data, descs, compound, pmask = _case()
    for has in (False, True):
        want = pallas_scoring.fused_scores(
            "homography", jnp.array(data), jnp.array(descs), jnp.array(compound),
            jnp.array(pmask), TRUNC_SQ, EXPONENT, has,
            magsac_levels=magsac_levels)
        got = kscoring.score_homography_plain(
            *_torch_inputs(data, descs, compound, pmask), TRUNC_SQ, EXPONENT,
            has, magsac_levels)
        _check(got, want, f"pallas (has_compound={has})")


def test_padding_independence():
    """Masked rows must not influence any reduction."""
    data, descs, compound, pmask = _case(n=256)
    td, tdesc, tc, tm = _torch_inputs(data, descs, compound, pmask)
    base = kscoring.score_homography(td, tdesc, tc, tm, TRUNC_SQ, EXPONENT, True)
    bad = torch.where(tm[:, None], td, 1e6)
    got = kscoring.score_homography(bad, tdesc, tc, tm, TRUNC_SQ, EXPONENT, True)
    for g, b in zip(got, base):
        np.testing.assert_allclose(g.numpy(), b.numpy(), rtol=1e-5)


def test_tanimoto_matches_jax():
    r = np.random.default_rng(4)
    pref = r.uniform(0, 1, (5, 64)).astype(np.float32)
    comp = r.uniform(0, 1, 64).astype(np.float32)
    got = scoring.tanimoto_similarity(torch.from_numpy(pref), torch.from_numpy(comp))
    want = [float(jax_scoring.tanimoto_similarity(jnp.array(p), jnp.array(comp)))
            for p in pref]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    zero = scoring.tanimoto_similarity(torch.zeros(8), torch.zeros(8))
    assert float(zero) == 0.0


def test_cpu_tensor_never_needs_the_compiler(monkeypatch):
    """On CPU tensors the wrapper takes the plain version and launches
    nothing."""
    from progressivex_tpu_torch.kernels import _build

    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(kscoring.LAUNCHES)
    data, descs, compound, pmask = _case(b=8, n=64)
    kscoring.score_homography(*_torch_inputs(data, descs, compound, pmask),
                              TRUNC_SQ, EXPONENT, True, 4)
    assert kscoring.LAUNCHES == before


@pytest.mark.parametrize("b, n", [
    (1, 128), (4, 256), (4, 384), (4, 2304), (4, 7680), (5, 300), (96, 300),
    (256, 384), (256, 2304), (256, 7680), (1536, 256), (2049, 7680)])
def test_tiling_fills_the_card(b, n):
    """The CUDA launch's tiling (pure arithmetic, so it runs here): valid
    tile and cluster sizes, a grid that covers the card's 132 SMs wherever
    B hypotheses and N points allow, and at least 256 points a cluster
    rank."""
    n_sms = 132
    k, cluster, threads = kscoring._tiling(b, n, n_sms)
    assert k in (1, 2, 4) and 1 <= cluster <= 8
    assert threads % 32 == 0 and 32 <= threads <= 256
    blocks = -(-b // k) * cluster
    assert blocks >= min(n_sms, b * min(8, max(1, n // 256)))
    assert cluster == 1 or n / cluster >= 256
    if -(-b // (2 * k)) >= 2 * n_sms and k < 4:
        raise AssertionError(f"K={k} leaves room for a larger hypothesis tile")


@pytest.mark.parametrize("b, n, want", [
    (256, 2304, (1, 1, 256)), (4, 2304, (1, 8, 128)), (256, 384, (1, 1, 128)),
    (4, 384, (1, 1, 128)), (1536, 256, (4, 1, 128)), (4, 256, (1, 1, 128)),
    (256, 7680, (1, 1, 256)), (4, 7680, (1, 8, 256))])
def test_tiling_at_the_path_shapes(b, n, want):
    """The tilings the sweep on an H100 (tools/sweep_score_tiling.py) found
    fastest or within a few percent of it, at the shapes the H and F paths
    launch."""
    assert kscoring._tiling(b, n, 132) == want
