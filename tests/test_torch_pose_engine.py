"""Parity of the engine features the 6D-pose path brings (core/engine: the
principal-axis sort and the kNN graph on graph coordinates, `_final_polish`
with and without `polish_trim`, `_polish_research`, and a fit through all
of them) with the JAX package's, on a small synthetic scene of two posed
objects seen by one camera.

The scene is find6DPoses' layout: data rows [x, y, X, Y, Z] in normalized
image coordinates, graph rows [u, v, X, Y, Z] in pixels and world
millimetres; both objects' points fill the same world cube, so only the
pixels tell them apart in the graph. 260 points pad to 384, over
128 + 2 * potts_band at potts_band = 64, so the fit takes the banded path
and sorts on the graph rows.

Tolerances: the sort exactly; kNN indices equal on 99% of entries (ties
at pixel scale), the radius mask exactly; polished poses rtol 1e-4 and
atol 1e-4; the replayed fit the same number of models and active slots,
labels apart on at most 1% of points, poses rtol 1e-3 and atol 1e-3.
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
from progressivex_tpu.models import get_family as jfamily
from progressivex_tpu.ops import knn as jknn
from progressivex_tpu.ops import sampling as jsampling

from progressivex_tpu_torch import convert
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.core.config import rows_params
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.ops import knn

N_PAD = 384
K_CAM = np.array([[800.0, 0.0, 320.0], [0.0, 800.0, 240.0], [0.0, 0.0, 1.0]])
LABEL_DISAGREEMENT_MAX = 0.01


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rotation(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _scene(seed=0, noise=0.5, half=30.0):
    """Two objects of 120 and 80 points in a world cube of side 2 * half
    mm, posed 500 and 600 mm in front of the camera, `noise` px of noise,
    and 60 outliers. Returns
    (data [N_PAD, 5], graph [N_PAD, 5], mask, gt labels [N_PAD] with
    outliers and padding at 2, poses [2, 12])."""
    r = np.random.default_rng(seed)
    poses = [(_rotation(np.array([0.2, -0.3, 0.1])), np.array([-40.0, 10.0, 500.0])),
             (_rotation(np.array([-0.4, 0.2, 0.5])), np.array([50.0, -20.0, 600.0]))]
    pix, world, gt = [], [], []
    for i, ((R, t), count) in enumerate(zip(poses, (120, 80))):
        X = r.uniform(-half, half, (count, 3))
        q = (X @ R.T + t) @ K_CAM.T
        pix.append(q[:, :2] / q[:, 2:] + r.normal(scale=noise, size=(count, 2)))
        world.append(X)
        gt += [i] * count
    pix.append(r.uniform([0, 0], [640, 480], (60, 2)))
    world.append(r.uniform(-half, half, (60, 3)))
    gt += [2] * 60
    pix, world = np.concatenate(pix), np.concatenate(world)
    n = len(pix)
    norm = (np.c_[pix, np.ones(n)] @ np.linalg.inv(K_CAM).T)[:, :2]
    data = np.zeros((N_PAD, 5), np.float32)
    graph = np.zeros((N_PAD, 5), np.float32)
    data[:n] = np.c_[norm, world]
    graph[:n] = np.c_[pix, world]
    mask = np.arange(N_PAD) < n
    labels = np.full(N_PAD, 2, np.int64)
    labels[:n] = gt
    descs = np.stack([np.c_[R, t].reshape(12) for R, t in poses]).astype(np.float32)
    return data, graph, mask, labels, descs


def _configs(**kw):
    jcfg = JConfig(family="pnp", n_hypotheses=64, max_rounds=4, pearl_iters=2,
                   sampler_id=0, lo_spatial_lambda=0.0, potts_band=64, **kw)
    jparams = jmake_params(threshold=2.0 / 800.0, confidence=0.9, spatial_weight=0.1,
                           neighborhood_radius=20.0, max_tanimoto=0.9, min_inliers=10,
                           n_valid=260)
    return (jcfg, jparams, convert.engine_config(dataclasses.asdict(jcfg)),
            convert.runtime_params(jparams._asdict()))


def test_sort_and_knn_on_graph_coordinates_match_jax():
    """The banded fit's principal-axis sort (progressivex_tpu/core/engine.py:
    537-551) and kNN graph (:565-567) on the graph rows."""
    _, graph, mask, _, _ = _scene()
    gd, pm = jnp.array(graph), jnp.array(mask)
    m = pm.astype(gd.dtype)
    mu = jnp.sum(gd * m[:, None], axis=0) / jnp.maximum(jnp.sum(m), 1.0)
    xc = (gd - mu) * m[:, None]
    cov = xc.T @ xc
    v = jnp.ones((gd.shape[1],), gd.dtype)
    for _ in range(8):
        v = cov @ v
        v = v / jnp.maximum(jnp.linalg.norm(v), 1e-20)
    want = np.asarray(jnp.argsort(jnp.where(pm, (gd - mu) @ v, jnp.inf)))
    perm, rank = engine.spatial_order(_t(graph), _t(mask))
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(rank.numpy()[want], np.arange(N_PAD))
    # The sort follows the pixels: it is not the sort of the data rows.
    assert not np.array_equal(engine.spatial_order(_t(_scene()[0]), _t(mask))[0].numpy(), want)

    gs, ms = graph[want], mask[want]
    ji, jm = jknn.knn_graph(jnp.array(gs), jnp.array(ms), 20.0, 48)
    ti, tm = knn.knn_graph(_t(gs), _t(ms), 20.0, 48)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.mean(ti.numpy() == np.asarray(ji)) >= 0.99


def _polish_inputs(perturb_seed=1, **scene):
    """The scene's two poses, perturbed, a spurious third slot that is not
    active, and labels with 15 outliers given to instance 0."""
    data, _, mask, labels, descs = _scene(**scene)
    r = np.random.default_rng(perturb_seed)
    k_slots = 10
    d = np.zeros((k_slots, 12), np.float32)
    for i in range(2):
        P = descs[i].reshape(3, 4).astype(np.float64)
        P[:, :3] = _rotation(r.normal(scale=0.02, size=3)) @ P[:, :3]
        P[:, 3] += r.normal(scale=2.0, size=3)
        d[i] = P.reshape(12)
    d[2] = descs[1]
    active = np.zeros(k_slots, bool)
    active[:2] = True
    lab = np.where(labels == 2, k_slots, labels)
    lab[200:215] = 0
    lab[~mask] = k_slots
    return data, mask, d, active, lab


@pytest.mark.parametrize("trim", [0.0, 0.2])
def test_final_polish_matches_jax(trim):
    data, mask, descs, active, labels = _polish_inputs()
    jcfg, jparams, cfg, params = _configs(final_polish=3, polish_trim=trim)
    w = mask.astype(np.float32)
    want = jax.jit(lambda d: jengine._final_polish(
        jfamily("pnp"), jcfg, jparams, jnp.array(data), jnp.array(mask), jnp.array(w),
        d, jnp.array(active), jnp.array(labels)))(jnp.array(descs))
    got = engine._final_polish(get_family("pnp"), cfg, rows_params(params, 1, "cpu"),
                               _t(data)[None], _t(mask)[None], _t(w)[None], _t(descs)[None],
                               _t(active)[None], _t(labels)[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert not np.array_equal(got.numpy()[:2], descs[:2])  # the passes moved them
    np.testing.assert_array_equal(got.numpy()[2:], descs[2:])  # inactive slots stay


def test_polish_research_matches_jax():
    """On objects 300 mm wide at 0.05 px of noise, on a scene whose
    re-search sample of instance 0 is well spread in the image (the
    samples here are one triple for every sample: the hash permutations of
    so few samples start alike; a near-collinear triple makes P3P
    ill-conditioned in float32), so that both packages refine the same
    candidate the same way."""
    data, mask, descs, active, labels = _polish_inputs(2, seed=1, noise=0.05, half=150.0)
    jcfg, jparams, cfg, params = _configs(polish_research=16)
    w = mask.astype(np.float32)
    want = jax.jit(lambda d: jengine._polish_research(
        jfamily("pnp"), jcfg, jparams, jnp.array(data), jnp.array(mask), jnp.array(w),
        d, jnp.array(active), jnp.array(labels)))(jnp.array(descs))
    # Two rows, the second the first with its slots' poses rolled, so
    # that a row's result is its own.
    rolled = np.roll(descs, 1, 0)
    rolled_active = np.roll(active, 1)
    rolled_labels = np.where(labels < 10, (labels + 1) % 10, labels)
    got = engine._polish_research(
        get_family("pnp"), cfg, rows_params(params, 2, "cpu"),
        _t(np.stack([data, data])), _t(np.stack([mask, mask])), _t(np.stack([w, w])),
        _t(np.stack([descs, rolled])), _t(np.stack([active, rolled_active])),
        _t(np.stack([labels, rolled_labels])))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.roll(got[1].numpy(), -1, 0), got[0].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert not np.array_equal(np.asarray(want)[:2], descs[:2])  # an instance was replaced


def test_fit_with_graph_data_and_final_polish_matches_jax():
    """engine.fit on the two-pose scene, banded on the graph rows, with
    three final polish passes, fed the JAX package's own samples."""
    data, graph, mask, gt, _ = _scene()
    jcfg, jparams, cfg, params = _configs(final_polish=3)
    w = mask.astype(np.float32)
    key = jax.random.PRNGKey(3)
    jfam = jfamily("pnp")
    want = jax.jit(lambda d, m, ww, k, g: jengine.fit(jfam, jcfg, jparams, d, m, ww, k, g))(
        jnp.array(data), jnp.array(mask), jnp.array(w), key, jnp.array(graph))
    idx_all, ok_all = jax.vmap(lambda k: jsampling.sample_minimal(
        k, jcfg.sampler_id, jcfg.n_hypotheses, jfam.sample_size, jnp.array(mask),
        jparams.n_valid, None, None))(jax.random.split(key, jcfg.max_rounds))
    pre = convert.presampled(np.asarray(idx_all), np.asarray(ok_all),
                             np.zeros((0, jcfg.n_hypotheses, 3), np.int32),
                             np.zeros((0, jcfg.n_hypotheses), bool), device="cpu")
    got = engine.fit(get_family("pnp"), cfg, params, _t(data), _t(mask), _t(w),
                     presampled=pre, graph_data=_t(graph))

    assert got.n_models == int(want.n_models) == 2
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    assert got.rounds_run == int(want.rounds_run)
    labels = got.labels.numpy()
    assert np.mean(labels != np.asarray(want.labels)) <= LABEL_DISAGREEMENT_MAX
    act = got.active.numpy()
    np.testing.assert_allclose(got.descs.numpy()[act], np.asarray(want.descs)[act],
                               rtol=1e-3, atol=1e-3)
    # Each true object is one instance.
    for obj in range(2):
        assert np.mean(labels[gt == obj] == np.bincount(labels[gt == obj]).argmax()) > 0.9
