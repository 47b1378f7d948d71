"""Parity of the port's essential-matrix family (models/essential,
ops/linalg.orthonormalize_rows) with the JAX package's, on the same seeded
numpy inputs.

Tolerances: orthonormalize_rows 1e-6; the constraints and their
closed-form Jacobian against `jax.jacfwd` 1e-5 relative to the largest
entry; the five-point solver's solutions as sets up to sign (which starts
converge, and so the dedupe's order, hangs on float32 bits): every valid
JAX solution within 1e-3 of a valid port solution, valid counts equal on
95% of samples, the ground truth recovered on 37 of 40 (the JAX gate,
tests/test_essential.py:52-66); the projection and the eight-point refit
1e-4 up to sign; the residual bit for bit the fundamental family's and
1e-6 relative of the JAX one's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivex_tpu.models import essential as je
from progressivex_tpu.ops import linalg as jl

from progressivex_tpu_torch.kernels.scoring import score_fundamental_plain
from progressivex_tpu_torch.models import essential as te
from progressivex_tpu_torch.models import fundamental as tf
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.ops import linalg as tl
from progressivex_tpu_torch.ops.scoring import compound_penalized_scores


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's own thread pool would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _synth_motion(seed, n=5, noise=0.0):
    """A calibrated two-view motion and n correspondences of it: a copy
    of tests/test_essential.py's generator. Returns (unit E, [n, 4])."""
    r = np.random.default_rng(seed)
    ax = r.normal(size=3)
    ax /= np.linalg.norm(ax)
    th = r.uniform(0.1, 0.5)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    t = r.normal(size=3)
    t /= np.linalg.norm(t)
    Tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = Tx @ R
    X = r.uniform(-1, 1, (n, 3)) + np.array([0, 0, 4.0])
    x1 = X[:, :2] / X[:, 2:3]
    Xc = X @ R.T + t
    x2 = Xc[:, :2] / Xc[:, 2:3]
    corr = np.concatenate([x1, x2], 1)
    corr += r.normal(0, noise, corr.shape)
    return E / np.linalg.norm(E), corr


def _up_to_sign(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def test_orthonormalize_rows_matches_jax():
    r = np.random.default_rng(0)
    basis = r.normal(size=(64, 4, 9)).astype(np.float32)
    basis /= np.linalg.norm(basis, axis=-1, keepdims=True)
    basis[3, 2] = basis[3, 1]  # a dependent row: invalid
    valid = np.ones(64, bool)
    valid[5] = False
    want_b, want_v = jax.vmap(jl.orthonormalize_rows)(jnp.array(basis), jnp.array(valid))
    got_b, got_v = tl.orthonormalize_rows(_t(basis), _t(valid))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    ok = np.asarray(want_v)
    np.testing.assert_allclose(got_b.numpy()[ok], np.asarray(want_b)[ok], rtol=1e-6, atol=1e-6)
    gram = np.einsum("bic,bjc->bij", got_b.numpy()[ok], got_b.numpy()[ok])
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(4), gram.shape), atol=1e-6)


def test_constraints_and_jacobian_match_jacfwd():
    r = np.random.default_rng(1)
    Es = r.normal(size=(32, 4, 3, 3)).astype(np.float32)
    q = r.normal(size=(32, 4)).astype(np.float32)

    def resid(q, Es):
        return je._constraints(jnp.einsum("k,kij->ij", q, Es))

    want_r = jax.vmap(resid)(jnp.array(q), jnp.array(Es))
    want_j = jax.vmap(jax.jacfwd(resid))(jnp.array(q), jnp.array(Es))
    # The port's layout: matrices [3, 3, *lanes], the lanes last.
    E = _t(np.einsum("bk,bkij->ijb", q, Es))
    got_r, got_j = te._constraints_and_jacobian(E, _t(Es.transpose(2, 3, 1, 0)))
    for got, want in ((got_r.T, want_r), (got_j.permute(2, 0, 1), want_j),
                      (te._constraints(E).T, want_r)):
        want = np.asarray(want)
        scale = np.abs(want).max(axis=tuple(range(1, want.ndim)), keepdims=True)
        np.testing.assert_array_less(np.abs(got.numpy() - want) / scale, 1e-5)


def test_five_point_solutions_match_jax():
    """40 noise-free minimal problems through both solvers."""
    gts, samples = zip(*(_synth_motion(seed) for seed in range(40)))
    s = np.array(samples, np.float32)
    want_d, want_v = jax.jit(jax.vmap(je._minimal))(jnp.array(s))
    want_d, want_v = np.asarray(want_d), np.asarray(want_v)
    got_d, got_v = te._minimal_batched(_t(s))
    got_d, got_v = got_d.numpy(), got_v.numpy()
    assert got_d.shape == (40, 10, 9) and got_v.shape == (40, 10)
    assert np.mean(got_v.sum(1) == want_v.sum(1)) >= 0.95
    for i in range(40):
        port = got_d[i][got_v[i]]
        for d in want_d[i][want_v[i]]:
            assert min(_up_to_sign(d, p) for p in port) < 1e-3, f"sample {i}"
    hits = sum(min([_up_to_sign(d.reshape(3, 3), gt) for d in got_d[i][got_v[i]]] + [np.inf])
               < 1e-3 for i, gt in enumerate(gts))
    assert hits >= 37, f"the port recovered {hits}/40 ground truths"


def test_five_point_degenerate_samples_match_jax():
    """Five coincident points (every E through the one point fits them:
    both solvers keep their solutions) and a sample holding NaN (no valid
    solution): the validity flags of both packages agree, nothing raises."""
    _, corr = _synth_motion(3)
    bad = np.repeat(corr[:1], 5, 0)
    nan = corr.copy()
    nan[2, 1] = np.nan
    s = np.stack([bad, nan, corr]).astype(np.float32)
    _, want_v = jax.vmap(je._minimal)(jnp.array(s))
    _, got_v = te._minimal_batched(_t(s))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert not got_v[1].any() and got_v[2].any()


def test_project_essential_matches_jax():
    r = np.random.default_rng(2)
    gts = [_synth_motion(seed)[0] for seed in range(16)]
    M = np.array(gts + [g + r.normal(0, 0.05, (3, 3)) for g in gts], np.float32)
    want = np.asarray(jax.vmap(je._project_essential)(jnp.array(M)))
    got = te._project_essential(_t(M)).numpy()
    for g, w in zip(got, want):
        assert _up_to_sign(g, w) < 1e-4
        s = np.linalg.svd(g.astype(np.float64), compute_uv=False)
        np.testing.assert_allclose(s[0], s[1], rtol=1e-4)
        assert s[2] < 1e-5


def test_nonminimal_matches_jax():
    r = np.random.default_rng(3)
    E_gt, corr = _synth_motion(0, n=60, noise=1e-3)
    data = corr.astype(np.float32)
    w = r.uniform(0, 1, (5, 60)).astype(np.float32)
    w[4, 7:] = 0.0  # 7 weighted points: invalid
    want_d, want_v = jax.vmap(je._nonminimal, in_axes=(None, 0))(jnp.array(data), jnp.array(w))
    got_d, got_v = te._nonminimal(_t(data), _t(w))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    for g, wd in zip(got_d.numpy()[:4], np.asarray(want_d)[:4]):
        assert _up_to_sign(g, wd) < 1e-4
        assert _up_to_sign(g.reshape(3, 3), E_gt) < 0.08
        s = np.linalg.svd(g.reshape(3, 3).astype(np.float64), compute_uv=False)
        np.testing.assert_allclose(s[0], s[1], rtol=1e-4)
    # With a row axis: data [R, N, 4], weights [R, K, N].
    rows_d, rows_v = te._nonminimal(_t(np.stack([data, data])), _t(np.stack([w, w])))
    np.testing.assert_array_equal(rows_d[1].numpy(), got_d.numpy())
    np.testing.assert_array_equal(rows_v[0].numpy(), got_v.numpy())


def test_squared_residual_is_the_fundamental_one():
    data = _synth_motion(5, n=64, noise=1e-3)[1].astype(np.float32)
    descs = np.array([_synth_motion(s)[0].reshape(9) for s in range(8)], np.float32)
    family = get_family("essential")
    got = family.squared_residual(_t(data), _t(descs))
    assert torch.equal(got, tf._squared_residual(_t(data), _t(descs)))
    want = np.asarray(jax.vmap(je._squared_residual, in_axes=(None, 0))(
        jnp.array(data), jnp.array(descs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("magsac_levels", [0, 4])
def test_plain_scorer_is_compound_penalized_scores(magsac_levels):
    r = np.random.default_rng(5)
    data = _t(_synth_motion(6, n=200, noise=1e-3)[1].astype(np.float32))
    descs = _t(np.array([_synth_motion(s)[0].reshape(9) for s in range(12)], np.float32))
    compound = _t(r.uniform(0, 1, 200).astype(np.float32))
    pmask = _t(r.uniform(size=200) > 0.1)
    family = get_family("essential")
    assert family.scorer.__name__ == "score_fundamental"
    args = (compound, pmask, 3.5e-6, 2.0, True, magsac_levels)
    got = family.scorer(data, descs, *args)
    want = compound_penalized_scores(family.squared_residual(data, descs), *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, score_fundamental_plain(data, descs, *args)):
        assert torch.equal(g, w)


def test_family_registration():
    family = get_family("essential")
    assert (family.sample_size, family.nonminimal_min, family.max_solutions,
            family.desc_dim) == (5, 8, 10, 9)
    assert family.refine_solver is None
    assert te._STARTS.dtype == np.float32
    np.testing.assert_array_equal(te._STARTS, np.asarray(je._STARTS))
