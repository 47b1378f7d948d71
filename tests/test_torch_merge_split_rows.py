"""Parity of the port's row-axis merge and split moves (core/pearl
`split_instances`, `merge_instances` on [R, ...] inputs) with `jax.vmap`
of the JAX package's, started from the same states.

Three rows of 256 points: the bridge state of
`tests/test_torch_engine.py::test_split_and_merge_match_jax` (one instance
holding two spatially disjoint structures) at thresholds 3 and 4.5, and a
clean two-structure state. Each row has its own kNN graph and threshold.
One split round, then the merge rounds, in both packages.

Tolerances (those of test_torch_engine.py): the same active slots;
labels that disagree on at most 1% of points; descriptors within atol
1e-3 after scaling to unit Frobenius norm with a fixed sign. A row run
alone gives the same bits as the same row in the batch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivex_tpu.core import pearl as jpearl
from progressivex_tpu.core.config import EngineConfig as JConfig
from progressivex_tpu.core.config import make_params as jmake_params
from progressivex_tpu.models import get_family as jfamily
from progressivex_tpu.ops import knn as jknn
from progressivex_tpu.ops import labeling as jlab

from progressivex_tpu_torch import convert
from progressivex_tpu_torch.core import pearl
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.ops import knn, labeling

LABEL_DISAGREEMENT_MAX = 0.01
DESC_ATOL = 1e-3
THRESHOLDS = (3.0, 4.5, 3.0)
HS = (np.array([[1.0, 0.0, 40.0], [0.0, 1.0, -10.0], [0.0, 0.0, 1.0]]),
      np.array([[0.9, 0.1, -20.0], [-0.1, 1.1, 30.0], [0.0, 0.0, 1.0]]))


def _unit(H):
    H = np.asarray(H, np.float64).reshape(-1, 9)
    H = H / np.linalg.norm(H, axis=1, keepdims=True)
    sign = np.sign(H[np.arange(len(H)), np.abs(H).argmax(1)])
    return H * sign[:, None]


def _scene(seed):
    r = np.random.default_rng(seed)
    parts = []
    for H, x0 in zip(HS, (0.0, 300.0)):
        p1 = r.uniform(0, 120, (100, 2)) + [x0, 0.0]
        ph = np.c_[p1, np.ones(100)] @ H.T
        parts.append(np.c_[p1, ph[:, :2] / ph[:, 2:] + r.normal(scale=0.5, size=(100, 2))])
    return np.concatenate(parts + [r.uniform(0, 420, (56, 4))]).astype(np.float32)


def _states(k_slots):
    """Three rows: (data, descs, active, labels) each."""
    rows = []
    for seed, clean in ((3, False), (3, False), (5, True)):
        data = _scene(seed)
        descs = np.zeros((k_slots, 9), np.float32)
        active = np.zeros(k_slots, bool)
        labels = np.full(len(data), k_slots, np.int32)
        descs[0] = HS[0].reshape(9)
        active[0] = True
        labels[:200] = 0  # the bridge: both structures in slot 0
        if clean:
            descs[1] = HS[1].reshape(9)
            active[1] = True
            labels[100:200] = 1
        rows.append((data, descs, active, labels))
    return [np.stack(t) for t in zip(*rows)]


@pytest.fixture(scope="module")
def setup():
    # Four slots (the bridge's, its split-off half, two free), to keep
    # the JAX compile of the vmapped moves short.
    jcfg = JConfig(family="homography", n_hypotheses=128, max_rounds=4,
                   max_models=4, pearl_iters=2, icm_sweeps=2, sampler_id=0)
    jparams = jmake_params(threshold=3.0, confidence=0.9, min_inliers=20, n_valid=256)
    cfg = convert.engine_config(dataclasses.asdict(jcfg))
    params = convert.runtime_params(jparams._asdict())
    data, descs, active, labels = _states(cfg.max_models)
    n_rows, n = labels.shape
    mask = np.ones((n_rows, n), bool)
    weights = np.ones((n_rows, n), np.float32)
    th = np.array(THRESHOLDS, np.float32)

    jfam = jfamily("homography")

    def jmoves(d, m, wt, ds, a, lab, t):
        jp = jparams._replace(threshold=t)
        idx, km = jknn.knn_graph(d, m, jp.neighborhood_radius, jcfg.knn_k)
        adj = jlab.adjacency_from_knn(idx, km)
        split = jpearl.split_instances(jfam, jcfg, jp, d, m, wt, ds, a, lab, adj,
                                       n_rounds=1)
        return jpearl.merge_instances(jfam, jcfg, jp, d, m, wt, *split, adj)

    jout = jax.jit(jax.vmap(jmoves))(*(jnp.array(x) for x in (
        data, mask, weights, descs, active, labels, th)))
    jout = [np.asarray(x) for x in jout]

    tfam = get_family("homography")

    def tmoves(rows):
        tdata = torch.from_numpy(data[rows])
        tmask = torch.from_numpy(mask[rows])
        tw = torch.from_numpy(weights[rows])
        p = params._replace(threshold=th[rows])
        idx, km = knn.knn_graph(tdata, tmask, p.neighborhood_radius, cfg.knn_k)
        adj = labeling.adjacency_from_knn(idx, km)
        state = (torch.from_numpy(descs[rows]), torch.from_numpy(active[rows]),
                 torch.from_numpy(labels[rows]).long())
        split = pearl.split_instances(tfam, cfg, p, tdata, tmask, tw, *state, adj,
                                      n_rounds=1)
        return pearl.merge_instances(tfam, cfg, p, tdata, tmask, tw, *split, adj)

    return jout, tmoves, tmoves(list(range(n_rows)))


def test_row_axis_moves_match_jax_vmap(setup):
    jout, _, batch = setup
    n_rows = len(THRESHOLDS)
    td, ta, tl = (t.numpy() for t in batch)
    jd, ja, jl = jout
    for r in range(n_rows):
        np.testing.assert_array_equal(ta[r], ja[r], err_msg=f"row {r}")
        assert ta[r].sum() == 2, f"row {r}"
        assert np.mean(tl[r] != jl[r]) <= LABEL_DISAGREEMENT_MAX, f"row {r}"
        act = ta[r]
        np.testing.assert_allclose(_unit(td[r][act]), _unit(jd[r][act]), atol=DESC_ATOL,
                                   err_msg=f"row {r}")


@pytest.mark.parametrize("row", [0, 1, 2])
def test_row_alone_matches_batch(setup, row):
    _, tmoves, batch = setup
    alone = tmoves([row])
    for b, a in zip(batch, alone):
        assert torch.equal(b[row], a[0])
