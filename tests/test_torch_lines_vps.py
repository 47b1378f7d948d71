"""Parity of the port's 2D-line and vanishing-point families (models/line2d,
models/vanishing_point, the ops/linalg functions they need) with the JAX
package's, on the same seeded numpy inputs, and of the slice as a whole:
`fit_rows` on a small lines scene fed the JAX package's own samples.

Tolerances: functions rtol 1e-5 and atol 1e-5 (solutions up to sign, since
a line normal's and a homogeneous VP's sign are free), validity flags
exact; the replayed fit the same number of models and active slots as
the JAX fit, labels apart on at most 1% of points, lines within rtol and
atol 1e-4 (c is in pixels).
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
from progressivex_tpu.eval import extras as jextras
from progressivex_tpu.models import get_family as jfamily
from progressivex_tpu.ops import knn as jknn
from progressivex_tpu.ops import linalg as jl
from progressivex_tpu.ops import sampling as jsampling

from progressivex_tpu_torch import convert
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.eval import extras
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.ops import linalg as tl

RTOL = ATOL = 1e-5
LABEL_DISAGREEMENT_MAX = 0.01
FAMILIES = ("line2d", "vanishing_point")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _signed(v):
    """Each row of v [..., D] with its largest-magnitude entry positive."""
    v = np.asarray(v, np.float64)
    idx = np.abs(v).argmax(-1)[..., None]
    return v * np.sign(np.take_along_axis(v, idx, -1))


def test_smallest_eigvec_2x2_and_normalize_vec_match_jax():
    r = np.random.default_rng(0)
    A = r.normal(size=(64, 2, 5)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1)
    M[0] = np.eye(2, dtype=np.float32) * 3.0  # isotropic: the x axis
    M[1] = 0.0
    want = jax.vmap(jl.smallest_eigvec_2x2)(jnp.array(M))
    got = tl.smallest_eigvec_2x2(_t(M))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy()[:2], [[1.0, 0.0], [1.0, 0.0]])
    v = r.normal(size=(16, 3)).astype(np.float32)
    v[0] = 0.0
    np.testing.assert_allclose(tl.normalize_vec(_t(v)).numpy(),
                               np.asarray(jl.normalize_vec(jnp.array(v))),
                               rtol=RTOL, atol=ATOL)


def _family_inputs(name, r):
    """Seeded data for one family: data [N, d], minimal samples [B, 2, d]
    (the first degenerate: a repeated point, or a segment of zero length
    at the origin, whose line vanishes), weights [W, N] and descriptors
    [W, 3]."""
    n = 120
    if name == "line2d":
        data = r.uniform(0, 400, (n, 2)).astype(np.float32)
    else:
        data = r.uniform(0, 640, (n, 4)).astype(np.float32)
    samples = data[r.integers(0, n, (48, 2))]
    if name == "line2d":
        samples[0, 1] = samples[0, 0]
    else:
        samples[0, 0] = 0.0
    weights = r.uniform(0, 1, (5, n)).astype(np.float32)
    weights[1, :100] = 0.0
    weights[2] = 0.0
    weights[2, :1] = 1.0  # fewer than two points
    descs = r.normal(size=(5, 3)).astype(np.float32)
    return data, samples, weights, descs


@pytest.mark.parametrize("name", FAMILIES)
def test_family_functions_match_jax(name):
    r = np.random.default_rng(3)
    data, samples, weights, descs = _family_inputs(name, r)
    jf, tf = jfamily(name), get_family(name)

    jd, jv = jax.vmap(jf.minimal_solver)(jnp.array(samples))
    td, tv = tf.minimal_solver_batched(_t(samples))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ok = tv.numpy()
    assert not ok[0] and ok.sum() >= 40
    np.testing.assert_allclose(_signed(td.numpy()[ok]), _signed(np.asarray(jd)[ok]),
                               rtol=RTOL, atol=ATOL)

    jd, jv = jax.vmap(jf.nonminimal_solver, in_axes=(None, 0))(
        jnp.array(data), jnp.array(weights))
    td, tv = tf.nonminimal_solver(_t(data), _t(weights))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.numpy().tolist() == [True, True, False, True, True]
    ok = tv.numpy()
    np.testing.assert_allclose(_signed(td.numpy()[ok]), _signed(np.asarray(jd)[ok]),
                               rtol=RTOL, atol=ATOL)

    want = jax.vmap(jf.squared_residual, in_axes=(None, 0))(jnp.array(data), jnp.array(descs))
    got = tf.squared_residual(_t(data), _t(descs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=ATOL)
    # With a row axis: two rows, their own data.
    rows = np.stack([data, data[::-1].copy()])
    got_rows = tf.squared_residual(_t(rows), _t(np.stack([descs, descs])))
    np.testing.assert_allclose(got_rows[1].numpy(), got.numpy()[:, ::-1], rtol=1e-6)


def test_scene_makers_match_jax():
    for seed in (0, 3):
        for got, want in zip(extras.make_lines_scene(seed=seed),
                             jextras.make_lines_scene(seed=seed)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(extras.make_vp_scene(seed=seed), jextras.make_vp_scene(seed=seed)):
            np.testing.assert_array_equal(got, want)
    pts, gt = extras.make_lines_scene()
    assert pts.shape == (3180, 2) and gt.shape == (3180,)
    segs, gt, vps = extras.make_vp_scene()
    assert segs.shape == (216, 4) and vps.shape == (3, 2)


@pytest.mark.parametrize("sampler_id", [0, 3])
def test_fit_rows_lines_matches_jax_with_replayed_samples(sampler_id):
    """engine.fit on a small lines scene (3 lines of 60 points, 40
    outliers, pad 256, per-point weights), fed the JAX package's own
    samples: uniform, and NAPSAC on the kNN graph (engine.py:854-883)."""
    pts, _ = extras.make_lines_scene(n_lines=3, per_line=60, n_outliers=40, seed=1)
    n, n_pad = len(pts), 256
    data = np.zeros((n_pad, 2), np.float32)
    data[:n] = pts
    mask = np.arange(n_pad) < n
    weights = np.where(mask, np.random.default_rng(2).uniform(0.5, 1.0, n_pad), 0.0
                       ).astype(np.float32)
    jcfg = JConfig(family="line2d", n_hypotheses=64, max_rounds=5, pearl_iters=2,
                   sampler_id=sampler_id)
    jparams = jmake_params(threshold=2.0, confidence=0.9, min_inliers=10, n_valid=n)
    key = jax.random.PRNGKey(4)
    jfam = jfamily("line2d")
    want = jax.jit(lambda d, m, w, k: jengine.fit(jfam, jcfg, jparams, d, m, w, k))(
        jnp.array(data), jnp.array(mask), jnp.array(weights), key)
    samp_idx, samp_mask = jknn.knn_graph(jnp.array(data), jnp.array(mask),
                                         jparams.neighborhood_radius,
                                         max(jcfg.knn_k, jcfg.sampler_k))
    idx_all, ok_all = jax.vmap(lambda k: jsampling.sample_minimal(
        k, jcfg.sampler_id, jcfg.n_hypotheses, jfam.sample_size, jnp.array(mask),
        jparams.n_valid, samp_idx, samp_mask))(jax.random.split(key, jcfg.max_rounds))
    pre = convert.presampled(np.asarray(idx_all), np.asarray(ok_all),
                             np.zeros((0, jcfg.n_hypotheses, 2), np.int32),
                             np.zeros((0, jcfg.n_hypotheses), bool), device="cpu")
    got = engine.fit(get_family("line2d"), convert.engine_config(dataclasses.asdict(jcfg)),
                     convert.runtime_params(jparams._asdict()), _t(data), _t(mask),
                     _t(weights), presampled=pre)

    assert got.n_models == int(want.n_models) == 3
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    assert got.rounds_run == int(want.rounds_run)
    assert np.mean(got.labels.numpy() != np.asarray(want.labels)) <= LABEL_DISAGREEMENT_MAX
    act = got.active.numpy()
    np.testing.assert_allclose(_signed(got.descs.numpy()[act]),
                               _signed(np.asarray(want.descs)[act]), rtol=1e-4, atol=1e-4)
