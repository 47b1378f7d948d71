"""Parity of the port's engine (core/pearl, core/engine) with the JAX
package's, started from the same state.

- `pearl_run` from the same descriptors, carried over by `convert`.
- The slice as a whole: the synthetic two-homography scene
  (`__graft_entry__._scene(256)`) under `entry()`'s configuration, with
  the JAX package's own samples replayed through `presampled`.

Tolerances: the same number of models and active slots; labels that
disagree on at most 1% of points; descriptors within atol 1e-3 after
scaling to unit Frobenius norm with a fixed sign (float32 eliminations
with sums taken in another order).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivex_tpu.core import engine as jengine
from progressivex_tpu.core import pearl as jpearl
from progressivex_tpu.core.config import EngineConfig as JConfig
from progressivex_tpu.core.config import make_params as jmake_params
from progressivex_tpu.models import get_family as jfamily
from progressivex_tpu.ops import knn as jknn
from progressivex_tpu.ops import labeling as jlab
from progressivex_tpu.ops import sampling as jsampling

from progressivex_tpu_torch import convert
from progressivex_tpu_torch.core import engine, pearl
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.ops import knn, labeling

_spec = importlib.util.spec_from_file_location(
    "__graft_entry__",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "__graft_entry__.py"))
graft = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(graft)

LABEL_DISAGREEMENT_MAX = 0.01
DESC_ATOL = 1e-3


def _unit(H):
    H = np.asarray(H, np.float64).reshape(-1, 9)
    H = H / np.linalg.norm(H, axis=1, keepdims=True)
    sign = np.sign(H[np.arange(len(H)), np.abs(H).argmax(1)])
    return H * sign[:, None]


def _entry_setup():
    """entry()'s configuration and scene (__graft_entry__.py:35-57)."""
    n = 256
    jcfg = JConfig(family="homography", n_hypotheses=128, max_rounds=4,
                   pearl_iters=2, icm_sweeps=2, sampler_id=0)
    jparams = jmake_params(threshold=3.0, confidence=0.9, min_inliers=20, n_valid=n)
    cfg = convert.engine_config(dataclasses.asdict(jcfg))
    params = convert.runtime_params(jparams._asdict())
    return n, jcfg, jparams, cfg, params, graft._scene(n)


def test_pearl_run_matches_jax():
    n, jcfg, jparams, cfg, params, data = _entry_setup()
    mask = np.ones(n, bool)
    weights = np.ones(n, np.float32)
    # Start from the scene's two true homographies, perturbed, plus a
    # spurious third instance that PEARL should reject.
    H1 = np.array([[1.0, 0.0, 40.0], [0.0, 1.0, -10.0], [0.0, 0.0, 1.0]])
    H2 = np.array([[0.9, 0.1, -20.0], [-0.1, 1.1, 30.0], [0.0, 0.0, 1.0]])
    H3 = np.array([[1.0, 0.0, -60.0], [0.0, 1.0, 70.0], [0.0, 0.0, 1.0]])
    r = np.random.default_rng(0)
    descs = np.zeros((cfg.max_models, 9), np.float32)
    for i, H in enumerate((H1, H2, H3)):
        descs[i] = (H + r.normal(scale=[[1e-3, 1e-3, 0.5]] * 2 + [[0, 0, 0]])
                    ).reshape(9)
    active = np.zeros(cfg.max_models, bool)
    active[:3] = True
    labels = np.full(n, cfg.max_models, np.int32)

    jfam = jfamily("homography")
    jidx, jmask = jknn.knn_graph(jnp.array(data), jnp.array(mask),
                                 jparams.neighborhood_radius, jcfg.knn_k)
    jadj = jlab.adjacency_from_knn(jidx, jmask)
    want = jax.jit(lambda d, a, l: jpearl.pearl_run(
        jfam, jcfg, jparams, jnp.array(data), jnp.array(mask),
        jnp.array(weights), d, a, l, jadj))(
        jnp.array(descs), jnp.array(active), jnp.array(labels))

    state = convert.fit_state(descs, active, labels, np.zeros(n, np.float32),
                              device="cpu")
    tdata = torch.from_numpy(data)
    tmask = torch.from_numpy(mask)
    tidx, tknn_mask = knn.knn_graph(tdata, tmask, params.neighborhood_radius, cfg.knn_k)
    tadj = labeling.adjacency_from_knn(tidx, tknn_mask)
    got = pearl.pearl_run(get_family("homography"), cfg, params, tdata, tmask,
                          torch.from_numpy(weights), state["descs"],
                          state["active"], state["labels"], tadj)

    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    assert int(got.active.sum()) == 2
    assert np.mean(got.labels.numpy() != np.asarray(want.labels)) <= LABEL_DISAGREEMENT_MAX
    act = got.active.numpy()
    np.testing.assert_allclose(_unit(got.descs.numpy()[act]),
                               _unit(np.asarray(want.descs)[act]), atol=DESC_ATOL)
    np.testing.assert_allclose(float(got.energy), float(want.energy), rtol=1e-3)


def test_slice_matches_jax_with_replayed_samples():
    """engine.fit on entry()'s scene and config, fed the JAX package's own
    minimal samples (engine.py:854-883 with n_subbatches = 1)."""
    n, jcfg, jparams, cfg, params, data = _entry_setup()
    mask = np.ones(n, bool)
    weights = np.ones(n, np.float32)
    key = jax.random.PRNGKey(0)
    jfam = jfamily("homography")
    want = jax.jit(lambda d, m, w, k: jengine.fit(jfam, jcfg, jparams, d, m, w, k))(
        jnp.array(data), jnp.array(mask), jnp.array(weights), key)

    samp_idx, samp_mask = jknn.knn_graph(
        jnp.array(data), jnp.array(mask), jparams.neighborhood_radius,
        max(jcfg.knn_k, jcfg.sampler_k))
    idx_all, ok_all = jax.vmap(lambda k: jsampling.sample_minimal(
        k, jcfg.sampler_id, jcfg.n_hypotheses, jfam.sample_size, jnp.array(mask),
        jparams.n_valid, samp_idx, samp_mask))(jax.random.split(key, jcfg.max_rounds))
    pre = convert.presampled(np.asarray(idx_all), np.asarray(ok_all),
                             np.zeros((0, jcfg.n_hypotheses, 4), np.int32),
                             np.zeros((0, jcfg.n_hypotheses), bool), device="cpu")
    got = engine.fit(get_family("homography"), cfg, params, torch.from_numpy(data),
                     torch.from_numpy(mask), torch.from_numpy(weights),
                     presampled=pre)

    assert got.n_models == int(want.n_models) == 2
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    assert got.rounds_run == int(want.rounds_run)
    disagree = np.mean(got.labels.numpy() != np.asarray(want.labels))
    assert disagree <= LABEL_DISAGREEMENT_MAX, disagree
    act = got.active.numpy()
    np.testing.assert_allclose(_unit(got.descs.numpy()[act]),
                               _unit(np.asarray(want.descs)[act]), atol=DESC_ATOL)
    descs, labels = engine.compact_result(got, n)
    assert descs.shape == (2, 9) and labels.shape == (n,) and labels.max() <= 2


def test_fit_needs_samples():
    n, _, _, cfg, params, data = _entry_setup()
    with pytest.raises(ValueError, match="key or presampled"):
        engine.fit(get_family("homography"), cfg, params, torch.from_numpy(data),
                   torch.ones(n, dtype=torch.bool), torch.ones(n))


def test_split_and_merge_match_jax():
    """split_instances on a bridge state (one instance holding two
    spatially disjoint structures), then merge_instances on the result;
    both moves are deterministic, so the packages must agree."""
    _, jcfg, jparams, cfg, params, _ = _entry_setup()
    r = np.random.default_rng(3)
    Hs = [np.array([[1.0, 0.0, 40.0], [0.0, 1.0, -10.0], [0.0, 0.0, 1.0]]),
          np.array([[0.9, 0.1, -20.0], [-0.1, 1.1, 30.0], [0.0, 0.0, 1.0]])]
    parts = []
    for H, x0 in zip(Hs, (0.0, 300.0)):
        p1 = r.uniform(0, 120, (100, 2)) + [x0, 0.0]
        ph = np.c_[p1, np.ones(100)] @ H.T
        parts.append(np.c_[p1, ph[:, :2] / ph[:, 2:] + r.normal(scale=0.5, size=(100, 2))])
    data = np.concatenate(parts + [r.uniform(0, 420, (56, 4))]).astype(np.float32)
    n = len(data)
    mask = np.ones(n, bool)
    weights = np.ones(n, np.float32)
    descs = np.zeros((cfg.max_models, 9), np.float32)
    descs[0] = Hs[0].reshape(9)
    active = np.zeros(cfg.max_models, bool)
    active[0] = True
    labels = np.full(n, cfg.max_models, np.int32)
    labels[:200] = 0  # the bridge: both structures in slot 0

    jfam = jfamily("homography")
    jidx, jmask = jknn.knn_graph(jnp.array(data), jnp.array(mask),
                                 jparams.neighborhood_radius, jcfg.knn_k)
    jadj = jlab.adjacency_from_knn(jidx, jmask)
    jargs = (jnp.array(data), jnp.array(mask), jnp.array(weights))
    j_split = jax.jit(lambda d, a, l: jpearl.split_instances(
        jfam, jcfg, jparams, *jargs, d, a, l, jadj, n_rounds=1))(
        jnp.array(descs), jnp.array(active), jnp.array(labels))
    j_merge = jax.jit(lambda d, a, l: jpearl.merge_instances(
        jfam, jcfg, jparams, *jargs, d, a, l, jadj))(*j_split)

    tfam = get_family("homography")
    tdata, tmask = torch.from_numpy(data), torch.from_numpy(mask)
    tidx, tknn_mask = knn.knn_graph(tdata, tmask, params.neighborhood_radius, cfg.knn_k)
    tadj = labeling.adjacency_from_knn(tidx, tknn_mask)
    state = convert.fit_state(descs, active, labels, np.zeros(n), device="cpu")
    targs = (tdata, tmask, torch.from_numpy(weights))
    t_split = pearl.split_instances(tfam, cfg, params, *targs, state["descs"],
                                    state["active"], state["labels"], tadj,
                                    n_rounds=1)
    t_merge = pearl.merge_instances(tfam, cfg, params, *targs, *t_split, tadj)

    for (td, ta, tl), (jd, ja, jl), k in ((t_split, j_split, 2), (t_merge, j_merge, 2)):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert int(ta.sum()) == k
        assert np.mean(tl.numpy() != np.asarray(jl)) <= LABEL_DISAGREEMENT_MAX
        act = ta.numpy()
        np.testing.assert_allclose(_unit(td.numpy()[act]), _unit(np.asarray(jd)[act]),
                                   atol=DESC_ATOL)
