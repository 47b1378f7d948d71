"""Parity of the port's grid-cell neighborhood (ops/knn.grid_graph, the
engine's `neighborhood="grid"`) with the JAX package's.

- `grid_graph` against the JAX function on the same points: the same
  masks and, per point, the same set of masked-in neighbors (ties of
  equal distance may come in another order under `torch.topk` than under
  `lax.top_k`), with padding, negative and large coordinates and a row
  axis of 2.
- The same-cell semantics check of tests/test_banded.py on the port.
- A small H fit with `neighborhood="grid"` on the JAX package's own
  minimal samples, against the JAX engine: the same models, labels apart
  on at most 1% of points, descriptors within atol 1e-3 after scaling to
  unit Frobenius norm with a fixed sign.
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
from progressivex_tpu.core.config import EngineConfig as JConfig
from progressivex_tpu.core.config import make_params as jmake_params
from progressivex_tpu.models import get_family as jfamily
from progressivex_tpu.ops import knn as jknn
from progressivex_tpu.ops import sampling as jsampling

from progressivex_tpu_torch import convert
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.ops import knn

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


def _points(n, seed, offset, scale, d=2):
    r = np.random.default_rng(seed)
    pts = (r.uniform(-scale, scale, (n, d)) + offset).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-(n // 12):] = False
    return pts, mask


@pytest.mark.parametrize("n", [96, 300])
@pytest.mark.parametrize("offset,scale,cell,k", [
    (0.0, 50.0, 24.0, 8),  # small coordinates, some negative; k caps cells
    (-4.0e5, 3.0e2, 151.0, 64),  # negative and large
    (2.5e6, 1.0e3, 480.0, 64),  # large: cell ids wrap in int32
])
def test_grid_graph_matches_jax(n, offset, scale, cell, k):
    """Where k caps a cell, the kept neighbors are the k nearest, and a
    near-tie at the k-th distance may fall either way under another
    summation order: the sets' distances agree. At large coordinates the
    distances themselves are float32 noise, so k there exceeds every
    cell's population and the set is the whole cell: that holds the
    cell ids to the JAX package's exactly."""
    rows = [_points(n, seed, offset, scale) for seed in (0, 1)]
    pts = np.stack([p for p, _ in rows])
    mask = np.stack([m for _, m in rows])
    t_idx, t_mask = knn.grid_graph(torch.from_numpy(pts), torch.from_numpy(mask), cell, k)
    t_idx, t_mask = t_idx.numpy(), t_mask.numpy()
    for r in range(2):
        j_idx, j_mask = jknn.grid_graph(jnp.array(pts[r]), jnp.array(mask[r]), cell, k)
        j_idx, j_mask = np.asarray(j_idx), np.asarray(j_mask)
        np.testing.assert_array_equal(t_mask[r], j_mask)
        p64 = pts[r].astype(np.float64)
        for i in range(n):
            t_set, j_set = t_idx[r, i][t_mask[r, i]], j_idx[i][j_mask[i]]
            if t_mask[r, i].sum() < k:  # the whole cell
                assert set(t_set) == set(j_set), (r, i)
            else:
                dist = [np.sort(((p64[s] - p64[i]) ** 2).sum(-1)) for s in (t_set, j_set)]
                np.testing.assert_allclose(*dist, rtol=1e-4, err_msg=f"{(r, i)}")
        assert t_mask[r].sum() > 2 * n  # cells hold several points


def test_cell_ids_wrap_like_int32():
    pts = torch.tensor([[-3.5, 1.0e6], [100.0, -2.0e5], [7.9e8, -1.2e9]])
    got = knn.cell_ids(pts, 1.0).numpy()
    cells = np.floor(pts.numpy() / 1.0).astype(np.int64)
    primes = np.array([73856093, 19349663], np.int64)
    want = ((cells * primes).sum(-1) + 2**31) % 2**32 - 2**31
    np.testing.assert_array_equal(got, want.astype(np.int32))
    j = np.asarray(jnp.sum(jnp.floor(jnp.array(pts.numpy()) / 1.0).astype(jnp.int32)
                           * jnp.array(primes, jnp.int32), axis=1))
    np.testing.assert_array_equal(got, j)


def test_grid_graph_same_cell_semantics():
    """tests/test_banded.py::test_grid_graph_same_cell_semantics on the
    port: neighbors are exactly same-cell points (k-capped, nearest
    first), self-edges masked, padding masked."""
    r = np.random.default_rng(0)
    n, cell = 96, 10.0
    pts = r.uniform(0, 50, (n, 2))
    mask = np.ones(n, bool)
    mask[-8:] = False
    k = 6
    idx, m = knn.grid_graph(torch.from_numpy(pts.astype(np.float32)),
                            torch.from_numpy(mask), cell, k)
    idx, m = idx.numpy(), m.numpy()
    cells = np.floor(pts.astype(np.float32) / cell).astype(int)
    for i in range(n):
        if not mask[i]:
            continue
        nbrs = idx[i][m[i]]
        assert i not in nbrs
        for j in nbrs:
            assert mask[j]
            assert (cells[j] == cells[i]).all(), (i, j)
        pop = sum(1 for j in range(n)
                  if mask[j] and j != i and (cells[j] == cells[i]).all())
        assert m[i].sum() == min(k, pop), (i, pop)
        # nearest first: the kept neighbors are the k closest of the cell
        if pop > k:
            d_all = sorted(np.sum((pts[j] - pts[i]) ** 2) for j in range(n)
                           if mask[j] and j != i and (cells[j] == cells[i]).all())
            d_kept = sorted(np.sum((pts[j] - pts[i]) ** 2) for j in nbrs)
            np.testing.assert_allclose(d_kept, d_all[:k], rtol=1e-5)
    assert not m[~mask].any()


def test_grid_fit_matches_jax_with_replayed_samples():
    """engine.fit with neighborhood="grid" (cell width 150 on entry()'s
    two-homography scene), fed the JAX package's own minimal samples."""
    n = 256
    jcfg = JConfig(family="homography", n_hypotheses=128, max_rounds=4,
                   pearl_iters=2, icm_sweeps=2, sampler_id=0, neighborhood="grid")
    jparams = jmake_params(threshold=3.0, confidence=0.9, min_inliers=20,
                           neighborhood_radius=150.0, n_valid=n)
    cfg = convert.engine_config(dataclasses.asdict(jcfg))
    params = convert.runtime_params(jparams._asdict())
    assert cfg.neighborhood == "grid"
    data = graft._scene(n)
    mask = np.ones(n, bool)
    weights = np.ones(n, np.float32)
    key = jax.random.PRNGKey(0)
    jfam = jfamily("homography")
    want = jax.jit(lambda d, m, w, k: jengine.fit(jfam, jcfg, jparams, d, m, w, k))(
        jnp.array(data), jnp.array(mask), jnp.array(weights), key)

    samp_idx, samp_mask = jknn.grid_graph(
        jnp.array(data), jnp.array(mask), jparams.neighborhood_radius,
        max(jcfg.knn_k, jcfg.sampler_k))
    idx_all, ok_all = jax.vmap(lambda k: jsampling.sample_minimal(
        k, jcfg.sampler_id, jcfg.n_hypotheses, jfam.sample_size, jnp.array(mask),
        jparams.n_valid, samp_idx, samp_mask))(jax.random.split(key, jcfg.max_rounds))
    pre = convert.presampled(np.asarray(idx_all), np.asarray(ok_all),
                             np.zeros((0, jcfg.n_hypotheses, 4), np.int32),
                             np.zeros((0, jcfg.n_hypotheses), bool), device="cpu")
    got = engine.fit(get_family("homography"), cfg, params, torch.from_numpy(data),
                     torch.from_numpy(mask), torch.from_numpy(weights), presampled=pre)

    assert got.n_models == int(want.n_models) == 2
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    disagree = np.mean(got.labels.numpy() != np.asarray(want.labels))
    assert disagree <= LABEL_DISAGREEMENT_MAX, disagree
    act = got.active.numpy()
    np.testing.assert_allclose(_unit(got.descs.numpy()[act]),
                               _unit(np.asarray(want.descs)[act]), atol=DESC_ATOL)
