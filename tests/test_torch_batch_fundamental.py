"""The fundamental-matrix slice on the port's row axis: F's restarts as
rows of one fit, and `findTwoViewMotionsBatched`.

- `engine.fit` with two restarts runs them as the two rows of one
  `fit_rows` call; on the same presampled draws it must pick the same
  winner as the restarts run one after another (one `fit_rows` call
  each), with the same energies.
- The row-batched plain Sampson scorer against `fused_scores` in
  interpret mode, vmapped over three rows.
- Batch invariance of `findTwoViewMotionsBatched`, exact on the CPU: a
  scene alone and inside a two-scene batch, four restarts a scene as rows.

This file compiles no JAX engine program (the JAX F engine compile takes
minutes): the restart test holds the port to itself.

Tolerances: energies rtol 1e-5; the winner, model counts, active slots,
labels and descriptors exact (the same rows computed in the same order);
scores, dots and norms rtol 1e-3 and atol 1e-2 with inlier counts exact
(tests/test_pallas_scoring.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from progressivex_tpu.models import fundamental as jf
from progressivex_tpu.ops import pallas_scoring

import progressivex_tpu_torch
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.core.config import EngineConfig, make_params
from progressivex_tpu_torch.kernels import scoring as kscoring
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.ops import knn, sampling


def _rotation(rv):
    theta = np.linalg.norm(rv)
    k = rv / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def _motion(r, n, t, x_shift, noise):
    """n correspondences of one rigid motion seen by a 800 px camera
    (tests/test_torch_fundamental.py's recipe)."""
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    X = r.uniform(-1, 1, (n, 3)) + [x_shift, 0.0, 5.0]
    x1 = X @ K.T
    x2 = (X @ _rotation(r.normal(size=3) * 0.05).T + t) @ K.T
    p1 = x1[:, :2] / x1[:, 2:] + r.normal(scale=noise, size=(n, 2))
    p2 = x2[:, :2] / x2[:, 2:] + r.normal(scale=noise, size=(n, 2))
    return np.c_[p1, p2]


def _two_motion_scene(seed=0, n_out=56, noise=0.3):
    """Two rigid motions of 100 points each and n_out outliers."""
    r = np.random.default_rng(seed)
    a = _motion(r, 100, np.array([0.6, 0.1, 0.05]), -1.2, noise)
    b = _motion(r, 100, np.array([-0.2, 0.5, 0.1]), 1.2, noise)
    out = np.c_[r.uniform(0, 640, (n_out, 1)), r.uniform(0, 480, (n_out, 1)),
                r.uniform(0, 640, (n_out, 1)), r.uniform(0, 480, (n_out, 1))]
    return np.concatenate([a, b, out]).astype(np.float32)


def test_restarts_as_rows_match_sequential_restarts():
    """Two P-NAPSAC restarts drawn once, then fitted as the two rows of
    engine.fit and one after another: the same winner, energies within
    rtol 1e-5, and the winner's fit."""
    data = _two_motion_scene()
    n = len(data)
    cfg = EngineConfig(family="fundamental", n_hypotheses=64, max_rounds=3,
                       pearl_iters=2, icm_sweeps=2, sampler_id=2, n_restarts=2,
                       magsac_levels=4, final_relabel=2, restart_rule="energy+5k",
                       max_models=4)
    params = make_params(threshold=1.0, confidence=0.5, spatial_weight=0.3,
                         neighborhood_radius=50.0, max_tanimoto=0.4, min_inliers=15,
                         max_models=4, scoring_exponent=1.0, n_valid=n)
    fam = get_family("fundamental")
    td, tm, tw = torch.from_numpy(data), torch.ones(n, dtype=torch.bool), torch.ones(n)
    samp_idx, samp_mask = knn.knn_graph(td, tm, params.neighborhood_radius,
                                        max(cfg.knn_k, cfg.sampler_k))
    gen = torch.Generator().manual_seed(3)
    empty = (torch.zeros(0, 64, 7, dtype=torch.long), torch.zeros(0, 64, dtype=torch.bool))
    runs = []
    for _ in range(cfg.n_restarts):
        draws = [sampling.sample_minimal(gen, cfg.sampler_id, 64, 7, n, samp_idx,
                                         samp_mask) for _ in range(cfg.max_rounds)]
        runs.append((torch.stack([d[0] for d in draws]),
                     torch.stack([d[1] for d in draws]), *empty))
    got = engine.fit(fam, cfg, params, td, tm, tw, presampled=runs)

    one_cfg = dataclasses.replace(cfg, n_restarts=1)
    seq = [engine.row_result(engine.fit_rows(
        fam, one_cfg, params, td[None], tm[None], tw[None],
        presampled=tuple(t[None] for t in run)), 0) for run in runs]
    energies = [float(r.energy) for r in seq]
    best = engine.select_restart(energies, cfg.restart_rule, [r.n_models for r in seq])
    assert got.restart == best
    np.testing.assert_allclose(got.restart_energies, energies, rtol=1e-5)
    want = seq[best]
    assert got.n_models == want.n_models >= 1
    assert got.rounds_run == want.rounds_run
    assert torch.equal(got.active, want.active)
    assert torch.equal(got.labels, want.labels)
    assert torch.equal(got.descs, want.descs)
    np.testing.assert_equal(got.round_log, want.round_log)  # NaN == NaN


def test_row_batched_sampson_scorer_matches_pallas_interpret():
    r = np.random.default_rng(1)
    rows, b, n = 3, 96, 300
    data = r.uniform(-50, 50, (rows, n, 4)).astype(np.float32)
    idx = r.integers(0, n, (rows, b // 3, 7))
    descs = np.stack([np.asarray(jf._minimal_batched(
        jnp.array(data[j])[jnp.array(idx[j])])[0]).reshape(-1, 9) for j in range(rows)])
    descs = np.nan_to_num(descs, nan=0.0, posinf=0.0, neginf=0.0)
    compound = r.uniform(0, 1, (rows, n)).astype(np.float32)
    pmask = r.uniform(size=(rows, n)) > 0.15
    trunc_sq = np.array([25.0, 9.0, 16.0], np.float32)
    has = np.array([False, True, True])
    want = jax.vmap(lambda d, ds, c, pm, t, h: pallas_scoring.fused_scores(
        "fundamental", d, ds, c, pm, t, 1.0, h, magsac_levels=4))(
        jnp.array(data), jnp.array(descs), jnp.array(compound), jnp.array(pmask),
        jnp.array(trunc_sq), jnp.array(has))
    got = kscoring.score_fundamental(
        torch.from_numpy(data), torch.from_numpy(descs), torch.from_numpy(compound),
        torch.from_numpy(pmask), torch.from_numpy(trunc_sq), 1.0,
        torch.from_numpy(has), 4)
    for g, w, name in zip(got, want, ("scores", "inliers", "dots", "norms")):
        assert g.shape == (rows, descs.shape[1])
        if name == "inliers":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-2,
                                       err_msg=name)


def test_batched_two_view_motions_are_batch_invariant():
    """A scene alone and inside a batch with a smaller scene of the same
    pad level, four restarts a scene as rows (eight rows): the same
    models and labels, exactly."""
    scenes = [_two_motion_scene(0), _two_motion_scene(1, n_out=20)]
    kw = dict(threshold=1.0, conf=0.5, spatial_coherence_weight=0.3,
              neighborhood_ball_radius=50.0, max_iters=64, minimum_point_number=15,
              maximum_model_number=4, sampler_id=2, scoring_exponent=1.0,
              max_rounds=2, pearl_iters=1, random_seed=2, device="cpu")
    batch = progressivex_tpu_torch.findTwoViewMotionsBatched(scenes, **kw)
    alone = progressivex_tpu_torch.findTwoViewMotionsBatched(scenes[:1], **kw)
    assert [labels.shape for _, labels in batch] == [(256,), (220,)]
    for models, _ in batch:
        assert models.shape[0] % 3 == 0 and models.shape[0] >= 3
        assert np.isfinite(models).all()
    np.testing.assert_array_equal(alone[0][0], batch[0][0])
    np.testing.assert_array_equal(alone[0][1], batch[0][1])
