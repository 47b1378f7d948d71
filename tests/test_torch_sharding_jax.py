"""The port's hypothesis parallelism against the JAX package's, on the CPU.

- The proposal (`engine._make_propose`) with two replicas and LO on, on
  an explicit index pool, for line2d and homography, against the JAX
  package's named-vmap form of the hyp axis (tests/test_sharding.py:
  167-177): every replica's sub-batch search, top-T and LO, then the
  all_gather + argmax.
- The slice: homography on entry()'s scene and configuration (256
  points, B = 128, 4 rounds) with two replicas, against
  tests/test_sharding.py:48-65's emulation of a (1, 2) mesh, each JAX
  replica's own samples (fold_in(key, h), progressivex_tpu/core/
  engine.py:850-880) replayed through `presampled`.
- The lane plan under PROGX_BENCH_DEVICES against the JAX package's
  `_prepare_lane_batches` on a 4-device mesh (which compiles nothing).

Tolerances (tests/test_torch_engine.py's): descriptors within atol 1e-3
after scaling to unit norm with a fixed sign; proposal scores rtol 1e-4;
the slice with the same number of models and active slots and labels
apart on at most 1% of points.
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
from progressivex_tpu.eval import adelaide as jadelaide
from progressivex_tpu.models import get_family as jfamily
from progressivex_tpu.ops import knn as jknn
from progressivex_tpu.ops import labeling as jlab
from progressivex_tpu.ops import sampling as jsampling
from progressivex_tpu.ops.scoring import truncated_preference as jtruncated_preference

from progressivex_tpu_torch import convert
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.core.config import rows_params
from progressivex_tpu_torch.eval import adelaide, synth_adelaide
from progressivex_tpu_torch.models import get_family

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "__graft_entry__", os.path.join(REPO, "__graft_entry__.py"))
graft = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(graft)

LABEL_DISAGREEMENT_MAX = 0.01
DESC_ATOL = 1e-3


def _unit(d, dim):
    d = np.asarray(d, np.float64).reshape(-1, dim)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    sign = np.sign(d[np.arange(len(d)), np.abs(d).argmax(1)])
    return d * sign[:, None]


def _line_scene(n=128, seed=9):
    r = np.random.default_rng(seed)
    t = r.uniform(0, 100, n // 2)
    l1 = np.stack([t, 0.5 * t], 1)
    t2 = r.uniform(0, 100, n - n // 2)
    l2 = np.stack([t2, -0.3 * t2 + 60.0], 1)
    return (np.concatenate([l1, l2]) + r.normal(scale=0.2, size=(n, 2))).astype(np.float32)


CASES = {
    # family: (scene, threshold, min inliers, points of each structure,
    # the first of which is the compound instance; outliers follow them)
    "line2d": (lambda: _line_scene(), 1.0, 20, 64),
    "homography": (lambda: graft._scene(256), 3.0, 20, 85),
}


@pytest.mark.parametrize("family_name", ["line2d", "homography"])
def test_hyp_proposal_with_lo_matches_jax(family_name):
    """Two replicas of B = 64 samples, LO on (T = 4, two steps, spatial
    lambda 0.5) on the kNN adjacency, one instance already in the
    compound preference: both packages' winners and summed draws."""
    make, thr, min_inl, per = CASES[family_name]
    data = make()
    n, b, h = data.shape[0], 64, 2
    mask = np.ones(n, bool)
    weights = np.ones(n, np.float32)
    jfam = jfamily(family_name)
    m = jfam.sample_size
    jcfg = JConfig(family=family_name, n_hypotheses=b, hyp_axis="hyp", sampler_id=0)
    jparams = jmake_params(threshold=thr, confidence=0.95, min_inliers=min_inl, n_valid=n)
    r = np.random.default_rng(3)
    idx = r.integers(0, 2 * per, (h, b, m)).astype(np.int32)  # outliers left out
    ok = np.ones((h, b), bool)
    jidx, jmask = jknn.knn_graph(jnp.array(data), jnp.array(mask),
                                 jparams.neighborhood_radius, jcfg.knn_k)
    adj = np.array(jlab.adjacency_from_knn(jidx, jmask))
    compound = np.zeros(n, np.float32)
    compound[:per] = 1.0  # the first structure is already accepted
    ie = np.zeros((0, b, m), np.int32)
    oe = np.zeros((0, b), bool)

    def per_dev(i):
        return jengine._proposal(jfam, jcfg, jparams, jnp.array(data), jnp.array(mask),
                                 jnp.array(weights), jnp.array(idx)[i], jnp.array(ok)[i],
                                 jnp.array(ie), jnp.array(oe), jnp.array(adj),
                                 jnp.array(compound), jnp.ones((), bool))

    reps = jax.jit(jax.vmap(per_dev, axis_name="hyp"))(jnp.arange(h))
    want = [np.asarray(x[0]) for x in reps]

    cfg = convert.engine_config(dataclasses.asdict(jcfg))
    params = rows_params(convert.runtime_params(jparams._asdict()), 1, "cpu")
    family = get_family(family_name)
    tdata = torch.from_numpy(data)[None]
    propose = engine._make_propose(
        family, cfg, params, tdata, torch.from_numpy(mask)[None],
        torch.from_numpy(weights)[None], torch.from_numpy(adj)[None],
        (torch.from_numpy(idx).long()[None, :, None], torch.from_numpy(ok)[None, :, None],
         torch.zeros(1, h, 0, b, m, dtype=torch.long),
         torch.zeros(1, h, 0, b, dtype=torch.bool)))
    desc, score, drawn = propose(0, torch.from_numpy(compound)[None],
                                 torch.ones(1, dtype=torch.bool))
    got = [x[0].numpy() for x in (desc, score, score > engine._NEG / 2,
                                  family.squared_residual(tdata, desc), drawn)]
    assert bool(got[2]) and bool(want[2])
    dim = jfam.desc_dim
    np.testing.assert_allclose(_unit(got[0], dim), _unit(want[0], dim), atol=DESC_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    assert int(got[4]) == int(want[4]) == h * b
    # the winner is a model of the second structure, not of the compound's
    pref = np.asarray(jtruncated_preference(jnp.array(got[3]), 2.25 * thr * thr))
    assert pref[per:2 * per].sum() > pref[:per].sum()


def test_hyp_slice_matches_jax_emulation():
    """The homography fit of entry()'s scene with a hyp axis of two,
    against the JAX package's named-vmap emulation of a (1, 2) mesh, the
    JAX replicas' samples replayed."""
    n = 256
    h = 2
    jcfg = JConfig(family="homography", n_hypotheses=128, max_rounds=4,
                   pearl_iters=2, icm_sweeps=2, sampler_id=0)
    jcfg_h = dataclasses.replace(jcfg, hyp_axis="hyp")
    jparams = jmake_params(threshold=3.0, confidence=0.9, min_inliers=20, n_valid=n)
    data = graft._scene(n)
    mask = np.ones(n, bool)
    weights = np.ones(n, np.float32)
    key = jax.random.PRNGKey(0)
    jfam = jfamily("homography")

    def one_scene(d, m, wt, k):
        reps = jax.vmap(lambda _: jengine.fit(jfam, jcfg_h, jparams, d, m, wt, k),
                        axis_name="hyp")(jnp.arange(h))
        return jax.tree.map(lambda x: x[0], reps)

    want = jax.jit(one_scene)(jnp.array(data), jnp.array(mask), jnp.array(weights), key)

    samp_idx, samp_mask = jknn.knn_graph(
        jnp.array(data), jnp.array(mask), jparams.neighborhood_radius,
        max(jcfg.knn_k, jcfg.sampler_k))

    def replica_draws(rep):
        keys = jax.random.split(jax.random.fold_in(key, rep), jcfg.max_rounds)
        return jax.vmap(lambda k: jsampling.sample_minimal(
            k, jcfg.sampler_id, jcfg.n_hypotheses, jfam.sample_size, jnp.array(mask),
            jparams.n_valid, samp_idx, samp_mask))(keys)

    draws = [replica_draws(rep) for rep in range(h)]
    idx_all = np.stack([np.asarray(d[0]) for d in draws])[None]  # [1, H, rounds, B, 4]
    ok_all = np.stack([np.asarray(d[1]) for d in draws])[None]
    pre = (torch.from_numpy(idx_all).long(), torch.from_numpy(ok_all),
           torch.zeros(1, h, 0, jcfg.n_hypotheses, 4, dtype=torch.long),
           torch.zeros(1, h, 0, jcfg.n_hypotheses, dtype=torch.bool))
    cfg = convert.engine_config(dataclasses.asdict(jcfg_h))
    params = convert.runtime_params(jparams._asdict())
    res = engine.fit_rows(get_family("homography"), cfg, params,
                          torch.from_numpy(data)[None], torch.from_numpy(mask)[None],
                          torch.from_numpy(weights)[None], presampled=pre)
    got = engine.row_result(res, 0)

    assert got.n_models == int(want.n_models) == 2
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    assert got.rounds_run == int(want.rounds_run)
    assert got.total_iters == int(want.total_iters)
    disagree = np.mean(got.labels.numpy() != np.asarray(want.labels))
    assert disagree <= LABEL_DISAGREEMENT_MAX, disagree
    act = got.active.numpy()
    np.testing.assert_allclose(_unit(got.descs.numpy()[act], 9),
                               _unit(np.asarray(want.descs)[act], 9), atol=DESC_ATOL)
    assert got.samples_drawn == h * jcfg.n_hypotheses * got.rounds_run


@pytest.fixture(scope="module")
def synth_roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("synth")
    return {p: synth_adelaide.ensure_synth_dataset(p, root=str(base)) for p in "HF"}


@pytest.mark.parametrize("problem", ["H", "F"])
def test_lane_plan_with_bench_devices_equals_jax(synth_roots, problem, monkeypatch):
    """PROGX_BENCH_DEVICES=4 at lane target 1: every batch of the JAX
    package's plan on its 4-device mesh, lanes raised to the axis size."""
    monkeypatch.setenv("PROGX_BENCH_DEVICES", "4")
    root = synth_roots[problem]
    jbatches, _ = jadelaide._prepare_lane_batches(problem, root, 0, 1, None)
    _, names, _ = adelaide.discover_scenes(problem, root)
    sizes = [len(adelaide.load_corr_scene(nm, root=root)[1]) for nm in names]
    plan = adelaide.lane_plan(problem, sizes, 1, n_devices=4)
    assert len(plan) == len(jbatches)
    for b, jb in zip(plan, jbatches):
        assert (b.n_pad, b.lanes, b.rows) == (jb.n_pad, jb.lanes, jb.ns)
        assert b.scenes == tuple(jb._build_args[5]) and b.lanes >= 4
