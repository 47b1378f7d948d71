"""Parity of the port's fundamental-matrix slice with the JAX package's, on
the same numpy inputs: the cubic solver (ops/linalg.cubic_roots_real), the
family's solvers and residual (models/fundamental), the plain version of
the Sampson scoring kernel (kernels/scoring.score_fundamental) against
compound_penalized_scores and the Pallas kernel in interpret mode, the
PROSAC and P-NAPSAC samplers' invariants, select_restart, and the slice as
a whole: engine.fit with two restarts and P-NAPSAC, fed the JAX package's
own per-restart samples.

Tolerances: validity masks and inlier counts exact; cubic roots rtol 1e-4;
descriptors within atol 1e-3 after scaling to unit Frobenius norm with a
fixed sign (float32 eliminations with sums taken in another order);
scores, dots and norms rtol 1e-3 and atol 1e-2 (tests/test_pallas_scoring.py's);
labels of the whole fit apart on at most 1% of points.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivex_tpu.core import engine as jengine
from progressivex_tpu.core.config import EngineConfig as JConfig
from progressivex_tpu.core.config import make_params as jmake_params
from progressivex_tpu.models import fundamental as jf
from progressivex_tpu.models import get_family as jfamily
from progressivex_tpu.ops import knn as jknn
from progressivex_tpu.ops import linalg as jl
from progressivex_tpu.ops import pallas_scoring
from progressivex_tpu.ops import sampling as jsampling
from progressivex_tpu.ops import scoring as jscoring

from progressivex_tpu_torch import convert
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.core.config import EngineConfig, make_params
from progressivex_tpu_torch.kernels import scoring as kscoring
from progressivex_tpu_torch.models import fundamental as tf
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.ops import linalg as tl
from progressivex_tpu_torch.ops import prng, sampling

DESC_ATOL = 1e-3
LABEL_DISAGREEMENT_MAX = 0.01
TRUNC_SQ, EXPONENT = 25.0, 2.0


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _unit(F):
    F = np.asarray(F, np.float64).reshape(-1, 9)
    F = F / np.linalg.norm(F, axis=1, keepdims=True)
    sign = np.sign(F[np.arange(len(F)), np.abs(F).argmax(1)])
    return F * sign[:, None]


def _rotation(rv):
    theta = np.linalg.norm(rv)
    k = rv / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def _motion(r, n, t, x_shift, noise):
    """n correspondences of one rigid motion (t, a small rotation) seen by
    a 800 px camera, the points spread around image column x_shift."""
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    X = r.uniform(-1, 1, (n, 3)) + [x_shift, 0.0, 5.0]
    x1 = X @ K.T
    x2 = (X @ _rotation(r.normal(size=3) * 0.05).T + t) @ K.T
    p1 = x1[:, :2] / x1[:, 2:] + r.normal(scale=noise, size=(n, 2))
    p2 = x2[:, :2] / x2[:, 2:] + r.normal(scale=noise, size=(n, 2))
    return np.c_[p1, p2]


def _two_motion_scene(seed=0, noise=0.3):
    """Two rigid motions of 100 points each and 56 outliers: [256, 4] f32."""
    r = np.random.default_rng(seed)
    a = _motion(r, 100, np.array([0.6, 0.1, 0.05]), -1.2, noise)
    b = _motion(r, 100, np.array([-0.2, 0.5, 0.1]), 1.2, noise)
    out = np.c_[r.uniform(0, 640, (56, 1)), r.uniform(0, 480, (56, 1)),
                r.uniform(0, 640, (56, 1)), r.uniform(0, 480, (56, 1))]
    return np.concatenate([a, b, out]).astype(np.float32)


# ---------------------------------------------------------------- cubic


CUBICS = {
    "three_real": [(1.0, -6.0, 11.0, -6.0), (2.0, 0.0, -8.0, 1.0)],
    "one_real": [(1.0, 0.0, 1.0, 1.0), (3.0, -1.0, 2.0, 5.0)],
    "repeated": [(1.0, -4.0, 5.0, -2.0), (1.0, 0.0, 0.0, 0.0)],
    "quadratic": [(1e-14, 1.0, -3.0, 2.0), (0.0, 2.0, 1.0, 5.0)],
    "linear": [(0.0, 0.0, 2.0, -4.0), (1e-15, 1e-14, -1.0, 3.0)],
}


@pytest.mark.parametrize("case", sorted(CUBICS))
def test_cubic_roots_match_jax(case):
    coeffs = np.array(CUBICS[case], np.float32)
    want_r, want_v = jax.vmap(jl.cubic_roots_real)(*(jnp.array(c) for c in coeffs.T))
    got_r, got_v = tl.cubic_roots_real(*(_t(c) for c in coeffs.T))
    assert got_r.shape == (len(coeffs), 3)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-4, atol=1e-6)
    # every root marked valid solves its polynomial
    a, b, c, d = (coeffs[:, i:i + 1].astype(np.float64) for i in range(4))
    x = got_r.numpy().astype(np.float64)
    val = a * x ** 3 + b * x ** 2 + c * x + d
    scale = np.abs(np.c_[a, b, c, d]).max(1, keepdims=True)
    assert np.all(np.abs(val[got_v.numpy()]) <= 1e-3 * np.broadcast_to(scale, x.shape)[got_v.numpy()])


def test_batched_hartley_matches_jax():
    r = np.random.default_rng(3)
    pts = r.uniform(0, 500, (40, 2)).astype(np.float32)
    W = r.uniform(0, 1, (3, 5, 40)).astype(np.float32)
    got_p, got_T = tl.hartley_normalize(_t(pts), _t(W))
    assert got_p.shape == (3, 5, 40, 2) and got_T.shape == (3, 5, 3, 3)
    want_p, want_T = jax.vmap(jax.vmap(jl.hartley_normalize, in_axes=(None, 0)),
                              in_axes=(None, 0))(jnp.array(pts), jnp.array(W))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_T.numpy(), np.asarray(want_T), rtol=1e-4, atol=1e-5)


# -------------------------------------------------------------- solvers


def test_minimal_batched_matches_jax():
    """Validity masks equal; descriptors within DESC_ATOL on at least 95%
    of the solutions and within 0.05 on all. The seven-point cubic
    amplifies last-bit differences (sums in another order, XLA's fused
    multiply-adds) on ill-conditioned samples, as tests/test_solvers.py:223
    calibrates between the JAX package's own two seven-point solvers."""
    data = _two_motion_scene()
    r = np.random.default_rng(5)
    local = np.stack([r.choice(100, 7, replace=False) + 100 * (i % 2)
                      for i in range(192)])
    mixed = r.integers(0, len(data), (64, 7))
    samples = data[np.concatenate([local, mixed])]
    dj, vj = jf._minimal_batched(jnp.array(samples))
    dt, vt = tf._minimal_batched(_t(samples))
    assert dt.shape == (256, 3, 9) and vt.shape == (256, 3)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    ok = vt.numpy()
    assert ok[:192].any(1).mean() > 0.9  # single-motion samples solve
    err = np.abs(_unit(dt.numpy()[ok]) - _unit(np.asarray(dj)[ok])).max(1)
    assert (err <= DESC_ATOL).mean() >= 0.95, np.sort(err)[-10:]
    assert err.max() <= 0.05, err.max()
    # Every valid solution interpolates its own sample.
    r2 = tf._squared_residual(_t(samples.reshape(-1, 4)), dt)  # [B, 3, B * 7]
    b = np.arange(256)
    own = r2.reshape(256, 3, 256, 7)[b, :, b]  # [B, 3, 7]
    assert float(own[torch.from_numpy(ok)].sqrt().max()) < 0.05


def test_oriented_check_rejects_bridge_samples():
    """tests/test_solvers.py:341 on the port: single-motion samples keep
    >= 95% acceptance, samples mixing the two motions lose a measurable
    fraction of their models."""
    data = _two_motion_scene()
    r = np.random.default_rng(21)
    pure = np.stack([data[r.choice(100, 7, replace=False)] for _ in range(200)])
    mixed = []
    for _ in range(200):
        k = int(r.integers(2, 6))
        mixed.append(np.concatenate([data[r.choice(100, k, replace=False)],
                                     data[100 + r.choice(100, 7 - k, replace=False)]]))
    _, v_pure = tf._minimal_batched(_t(pure))
    _, v_mixed = tf._minimal_batched(_t(np.stack(mixed)))
    acc_pure = float(v_pure.any(1).double().mean())
    acc_mixed = float(v_mixed.any(1).double().mean())
    assert acc_pure >= 0.95, acc_pure
    assert acc_mixed <= acc_pure - 0.05, (acc_pure, acc_mixed)


def _weights(data, seed):
    r = np.random.default_rng(seed)
    W = r.uniform(0.2, 1, (6, len(data))).astype(np.float32)
    W[:3, 100:] = 0.0  # motion a
    W[3:5, :100] = 0.0  # motion b
    W[3:5, 200:] = 0.0
    W[5] = 0.0
    W[5, :5] = 1.0  # five points: invalid
    return W


def test_nonminimal_and_refine_match_jax():
    data = _two_motion_scene()
    W = _weights(data, 10)
    dj, vj = jax.vmap(jf._nonminimal, in_axes=(None, 0))(jnp.array(data), jnp.array(W))
    dt, vt = tf._nonminimal(_t(data), _t(W))
    assert dt.shape == (6, 9)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    ok = vt.numpy()
    assert ok[:5].all() and not ok[5]
    np.testing.assert_allclose(_unit(dt.numpy()[ok]), _unit(np.asarray(dj)[ok]),
                               atol=DESC_ATOL)
    # Sampson-reweighted refit from the eight-point fits, batched over [2, 3].
    init = np.asarray(dj)[[0, 3, 1, 4, 2, 0]].reshape(2, 3, 9)
    W2 = W[[0, 3, 1, 4, 2, 0]].reshape(2, 3, -1)
    rj, rvj = jax.vmap(jax.vmap(jf._refine, in_axes=(None, 0, 0)),
                       in_axes=(None, 0, 0))(jnp.array(data), jnp.array(W2),
                                             jnp.array(init))
    rt, rvt = tf._refine(_t(data), _t(W2), _t(init))
    assert rt.shape == (2, 3, 9)
    np.testing.assert_array_equal(rvt.numpy(), np.asarray(rvj))
    np.testing.assert_allclose(_unit(rt.numpy().reshape(-1, 9)),
                               _unit(np.asarray(rj).reshape(-1, 9)), atol=DESC_ATOL)
    # The refit explains its motion: median Sampson distance under 1 px.
    r2 = tf._squared_residual(_t(data), rt[0, 0])
    assert float(r2[:100].sqrt().median()) < 1.0


def test_squared_residual_matches_jax():
    data = _two_motion_scene()
    r = np.random.default_rng(7)
    descs = r.normal(size=(5, 9)).astype(np.float32)
    descs[4] = 0.0  # den = 0 everywhere: the 1e-12 clamp
    want = jax.vmap(jf._squared_residual, in_axes=(None, 0))(
        jnp.array(data), jnp.array(descs))
    got = tf._squared_residual(_t(data), _t(descs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert np.all(got.numpy()[4] == 0.0)


# -------------------------------------------------------------- scoring


def _score_case(b=96, n=300, seed=0):
    """tests/test_pallas_scoring.py's case for the fundamental family."""
    r = np.random.default_rng(seed)
    data = r.uniform(-50, 50, (n, 4)).astype(np.float32)
    idx = r.integers(0, n, (b, 7))
    descs, _ = jf._minimal_batched(jnp.array(data)[jnp.array(idx)])
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


@pytest.mark.parametrize("magsac_levels", [0, 4])
@pytest.mark.parametrize("has_compound", [False, True])
def test_score_fundamental_matches_jax(magsac_levels, has_compound):
    data, descs, compound, pmask = _score_case()
    r2 = jax.vmap(jf._squared_residual, in_axes=(None, 0))(
        jnp.array(data), jnp.array(descs))
    want = jscoring.compound_penalized_scores(
        r2, jnp.array(compound), jnp.array(pmask), TRUNC_SQ, EXPONENT,
        has_compound, magsac_levels=magsac_levels)
    targs = (_t(data), _t(descs), _t(compound), _t(pmask))
    got = kscoring.score_fundamental(*targs, TRUNC_SQ, EXPONENT, has_compound,
                                     magsac_levels)
    _check(got, want, "compound_penalized_scores")
    pallas = pallas_scoring.fused_scores(
        "fundamental", jnp.array(data), jnp.array(descs), jnp.array(compound),
        jnp.array(pmask), TRUNC_SQ, EXPONENT, has_compound,
        magsac_levels=magsac_levels)
    _check(kscoring.score_fundamental_plain(*targs, TRUNC_SQ, EXPONENT,
                                            has_compound, magsac_levels),
           pallas, "pallas interpret")


def test_score_fundamental_padding_independence_and_no_build(monkeypatch):
    """Masked rows influence no reduction, and a CPU tensor takes the
    plain version without building or launching a kernel."""
    from progressivex_tpu_torch.kernels import _build

    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(_build.LAUNCHES)
    data, descs, compound, pmask = _score_case(n=256)
    td, tdesc, tc, tm = _t(data), _t(descs), _t(compound), _t(pmask)
    base = kscoring.score_fundamental(td, tdesc, tc, tm, TRUNC_SQ, EXPONENT, True, 4)
    bad = torch.where(tm[:, None], td, 1e6)
    got = kscoring.score_fundamental(bad, tdesc, tc, tm, TRUNC_SQ, EXPONENT, True, 4)
    for g, b in zip(got, base):
        np.testing.assert_allclose(g.numpy(), b.numpy(), rtol=1e-5)
    assert _build.LAUNCHES == before
    assert get_family("fundamental").scorer is kscoring.score_fundamental


# -------------------------------------------------------------- sampling


def test_prosac_prefix_growth():
    n_valid, b, m = 200, 512, 7
    no_table = torch.zeros(1, 1, dtype=torch.int64)  # PROSAC reads none
    idx, ok = sampling.sample_minimal(prng.key(0), 1, b, m, n_valid, no_table, no_table)
    prefix = np.minimum(m + np.ceil((np.arange(b) + 1.0) / b * (n_valid - m)), n_valid)
    assert np.all(idx.numpy().max(1) < prefix)  # row b draws from its prefix
    assert idx.numpy().min() >= 0 and idx.numpy().max() < n_valid
    assert ok.float().mean() > 0.5
    rows = idx[ok].numpy()
    assert all(len(set(r.tolist())) == m for r in rows)
    # the JAX sampler draws from the same prefixes
    jidx, jok = jsampling.prosac_sample(jax.random.PRNGKey(0), b, m, jnp.int32(n_valid))
    assert np.all(np.asarray(jidx).max(1) < prefix)
    # ... and, from the same key, the same samples
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_progressive_napsac_window_and_global_tail():
    r = np.random.default_rng(1)
    n, k, n_valid, b, m = 200, 48, 180, 512, 7
    knn_idx = np.stack([r.permutation(n)[:k] for _ in range(n)]).astype(np.int32)
    knn_mask = r.random((n, k)) < 0.9
    idx, ok = sampling.sample_minimal(prng.key(2), 2, b, m, n_valid, _t(knn_idx),
                                      _t(knn_mask))
    idx, ok = idx.numpy(), ok.numpy()
    n_local = (b * 7) // 8
    frac = np.minimum(np.arange(b) / (n_local - 1), 1.0)
    k_b = np.ceil((m - 1) + frac * (k - (m - 1)))
    local = 0
    for i in range(n_local):
        c = idx[i, 0]
        window = set(knn_idx[c, :int(k_b[i])][knn_mask[c, :int(k_b[i])]].tolist())
        if set(idx[i, 1:].tolist()) <= window:
            local += 1
            assert ok[i] and c < n_valid
    # early windows are narrow: a few fall back to global samples
    assert local >= 0.8 * n_local
    assert idx.min() >= 0 and idx.max() < n
    tail = idx[n_local:][ok[n_local:]]
    assert tail.max() < n_valid  # the last eighth samples the valid prefix
    assert all(len(set(row.tolist())) == m for row in tail)
    idx2, _ = sampling.sample_minimal(prng.key(2), 2, b, m, n_valid, _t(knn_idx),
                                      _t(knn_mask))
    assert np.array_equal(idx, idx2.numpy())
    jidx, _ = jsampling.progressive_napsac_sample(
        jax.random.PRNGKey(2), b, m, jnp.int32(n_valid), jnp.asarray(knn_idx),
        jnp.asarray(knn_mask))
    np.testing.assert_array_equal(idx, np.asarray(jidx))


# -------------------------------------------------------------- restarts


@pytest.mark.parametrize("rule", ["energy", "energy+5k", "energy+0.5k"])
def test_select_restart_matches_jax(rule):
    energy = np.array([100.0, 97.0, 96.5, 104.0], np.float32)
    n_models = np.array([2, 2, 3, 2], np.int32)
    want = int(jengine.select_restart(energy, None, rule, n_models))
    assert engine.select_restart(energy, rule, n_models) == want
    assert engine.select_restart(energy[:1], rule, n_models[:1]) == 0


def test_select_restart_rejects_unknown_rules():
    with pytest.raises(ValueError, match="unknown restart_rule"):
        engine.select_restart(np.zeros(2, np.float32), "agreement", [1, 1])
    with pytest.raises(ValueError, match="needs n_models"):
        engine.select_restart(np.zeros(2, np.float32), "energy+5k")


def test_prosac_indices_map_through_the_spatial_sort():
    """PROSAC draws in the caller's (quality) order; a banded fit sorts the
    points, so its indices go through `rank` (JAX engine.py:884-890): a
    PROSAC fit equals a uniform-sampler fit handed the mapped indices."""
    data = _two_motion_scene()
    n = len(data)
    cfg = EngineConfig(family="fundamental", n_hypotheses=64, max_rounds=2,
                              pearl_iters=1, icm_sweeps=1, potts_band=8,
                              sampler_id=1)
    params = make_params(threshold=1.0, confidence=0.5, spatial_weight=0.3,
                                neighborhood_radius=50.0, min_inliers=15,
                                scoring_exponent=1.0, n_valid=n)
    td, tm, tw = _t(data), torch.ones(n, dtype=torch.bool), torch.ones(n)
    no_table = torch.zeros(1, 1, dtype=torch.int64)  # PROSAC reads none
    idx, ok = sampling.sample_minimal(prng.split(prng.key(0), 2), 1, 64, 7, n, no_table,
                                      no_table)
    empty = (torch.zeros(0, 64, 7, dtype=torch.long), torch.zeros(0, 64, dtype=torch.bool))
    fam = get_family("fundamental")
    got = engine.fit(fam, cfg, params, td, tm, tw, presampled=(idx, ok, *empty))
    _, rank = engine.spatial_order(td, tm)
    want = engine.fit(fam, dataclasses.replace(cfg, sampler_id=0), params, td, tm, tw,
                      presampled=(rank[idx], ok, *empty))
    assert got.n_models == want.n_models >= 1
    assert torch.equal(got.labels, want.labels)
    assert torch.equal(got.descs, want.descs)


# ---------------------------------------------------------------- slice


def test_slice_matches_jax_with_replayed_restart_samples():
    """engine.fit with family "fundamental", P-NAPSAC and two restarts on
    the two-motion scene, fed the JAX package's own samples of each restart
    (engine.py:579-600 and :854-883 with n_subbatches = 1)."""
    data = _two_motion_scene()
    n = len(data)
    jcfg = JConfig(family="fundamental", n_hypotheses=96, max_rounds=3,
                   pearl_iters=2, icm_sweeps=2, sampler_id=2, n_restarts=2,
                   magsac_levels=4, final_relabel=2, restart_rule="energy+5k")
    jparams = jmake_params(threshold=1.0, confidence=0.5, spatial_weight=0.3,
                           neighborhood_radius=50.0, max_tanimoto=0.4,
                           min_inliers=15, max_models=4, scoring_exponent=1.0,
                           n_valid=n)
    cfg = convert.engine_config(dataclasses.asdict(jcfg))
    params = convert.runtime_params(jparams._asdict())
    mask = np.ones(n, bool)
    weights = np.ones(n, np.float32)
    key = jax.random.PRNGKey(0)
    jfam = jfamily("fundamental")
    want = jax.jit(lambda d, m, w, k: jengine.fit(jfam, jcfg, jparams, d, m, w, k))(
        jnp.array(data), jnp.array(mask), jnp.array(weights), key)

    samp_idx, samp_mask = jknn.knn_graph(
        jnp.array(data), jnp.array(mask), jparams.neighborhood_radius,
        max(jcfg.knn_k, jcfg.sampler_k))
    presampled = []
    for k in jax.random.split(key, jcfg.n_restarts):
        idx_all, ok_all = jax.vmap(lambda kk: jsampling.sample_minimal(
            kk, jcfg.sampler_id, jcfg.n_hypotheses, jfam.sample_size,
            jnp.array(mask), jparams.n_valid, samp_idx, samp_mask))(
            jax.random.split(k, jcfg.max_rounds))
        presampled.append(convert.presampled(
            np.asarray(idx_all), np.asarray(ok_all),
            np.zeros((0, jcfg.n_hypotheses, 7), np.int32),
            np.zeros((0, jcfg.n_hypotheses), bool), device="cpu"))
    got = engine.fit(get_family("fundamental"), cfg, params, _t(data), _t(mask),
                     _t(weights), presampled=presampled)
    # the port's own draw from the same key is that replay, bit for bit
    drawn = engine.fit(get_family("fundamental"), cfg, params, _t(data), _t(mask),
                       _t(weights), key=convert.key_from_jax(np.asarray(key), device="cpu"))
    for f in ("descs", "active", "labels", "energy"):
        assert torch.equal(getattr(drawn, f), getattr(got, f)), f

    # The winner: the JAX package returns the winning restart's energy.
    assert len(got.restart_energies) == 2
    np.testing.assert_allclose(got.restart_energies[got.restart],
                               float(want.energy), rtol=1e-4)
    np.testing.assert_allclose(float(got.energy), float(want.energy), rtol=1e-4)
    assert got.n_models == int(want.n_models) >= 2
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    disagree = np.mean(got.labels.numpy() != np.asarray(want.labels))
    assert disagree <= LABEL_DISAGREEMENT_MAX, disagree
    act = got.active.numpy()
    np.testing.assert_allclose(_unit(got.descs.numpy()[act]),
                               _unit(np.asarray(want.descs)[act]), atol=DESC_ATOL)

