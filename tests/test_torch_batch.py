"""The port's row axis and batched front ends (core/engine.fit_rows,
api_batch) against the JAX package's, and the front ends' surface.

- `fit_rows` on three small homography scenes of one pad level (the
  `tests/test_batch_mesh._scenes` recipe, n = 160, one scene cut to 130
  points so that n_valid differs inside the bucket, two thresholds), fed
  the JAX package's own per-row samples, against the rows of
  `api_batch._compiled_fit_rows` (no mesh).
- Batch invariance of `findHomographiesBatched`, exact on the CPU: a scene
  alone, inside a three-scene batch and replicated to four lanes.
- The row-batched plain scorer against `fused_scores` in interpret mode,
  vmapped over three rows with a threshold and a compound flag a row.
- The keyword names and defaults of the ten ported front ends against
  the JAX functions', `n_restarts` on `findHomographies`,
  `PROGX_MAX_SUBBATCHES`, and input validation.

Tolerances (tests/test_torch_engine.py's): per row the same number of
models and the same active slots, labels apart on at most 1% of points,
descriptors within atol 1e-3 after scaling to unit Frobenius norm with a
fixed sign; scores, dots and norms rtol 1e-3 and atol 1e-2 with inlier
counts exact (tests/test_pallas_scoring.py's).
"""

import dataclasses
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivex_tpu import api as japi
from progressivex_tpu import api_batch as japi_batch
from progressivex_tpu.core.config import EngineConfig as JConfig
from progressivex_tpu.core.config import make_params as jmake_params
from progressivex_tpu.models import get_family as jfamily
from progressivex_tpu.ops import pallas_scoring
from progressivex_tpu.ops import sampling as jsampling

import progressivex_tpu_torch
from progressivex_tpu_torch import api, api_batch, convert
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.kernels import scoring as kscoring
from progressivex_tpu_torch.models import get_family

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABEL_DISAGREEMENT_MAX = 0.01
DESC_ATOL = 1e-3


def _unit(H):
    H = np.asarray(H, np.float64).reshape(-1, 9)
    H = H / np.linalg.norm(H, axis=1, keepdims=True)
    sign = np.sign(H[np.arange(len(H)), np.abs(H).argmax(1)])
    return H * sign[:, None]


def _scenes(n_scenes=3, n=160, seed=0):
    """tests/test_batch_mesh._scenes: two homographies of n // 3 points
    each (0.5 px noise) and uniform outliers in a 200 px square."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_scenes):
        Hs = [np.array([[1.0, 0.05 * s, 30.0], [0.0, 1.0, -5.0 * s], [0.0, 0.0, 1.0]]),
              np.array([[0.9, 0.1, -20.0], [-0.1, 1.1, 30.0], [0.0, 0.0, 1.0]])]
        per = n // 3
        corrs = []
        for H in Hs:
            p1 = rng.uniform(0, 200, (per, 2))
            ph = np.concatenate([p1, np.ones((per, 1))], 1) @ H.T
            p2 = ph[:, :2] / ph[:, 2:3] + rng.normal(scale=0.5, size=(per, 2))
            corrs.append(np.concatenate([p1, p2], 1))
        corrs.append(rng.uniform(0, 200, (n - 2 * per, 4)))
        out.append(np.concatenate(corrs))
    return out


def _mixed_scenes():
    scenes = _scenes()
    scenes[1] = scenes[1][:130]  # n_valid differs inside the bucket
    return scenes


def test_fit_rows_matches_jax_rows_with_replayed_samples():
    """engine.fit_rows on three rows of pad level 256 (n_valid 160, 130,
    160; thresholds 3.0, 2.5, 3.0), fed the samples the JAX package draws
    for the same rows inside `_compiled_fit_rows`: row (scene s, restart 0)
    keyed fold_in(fold_in(fold_in(PRNGKey(seed), n_pad), s), 0), split into
    max_rounds round keys by engine.fit."""
    scenes = _mixed_scenes()
    n_pad, rows, seed = 256, len(scenes), 7
    thresholds = np.array([3.0, 2.5, 3.0], np.float32)
    jcfg = JConfig(family="homography", n_hypotheses=64, max_rounds=3,
                   pearl_iters=2, icm_sweeps=2, sampler_id=0)
    jparams = jmake_params(threshold=3.0, confidence=0.9, min_inliers=20, n_valid=0)
    data = np.zeros((rows, n_pad, 4), np.float32)
    mask = np.zeros((rows, n_pad), bool)
    for j, sc in enumerate(scenes):
        data[j, :len(sc)] = sc
        mask[j, :len(sc)] = True
    weights = mask.astype(np.float32)
    nv = mask.sum(1).astype(np.int32)
    base = jax.random.fold_in(jax.random.PRNGKey(seed), n_pad)
    keys = jnp.stack([jax.random.fold_in(jax.random.fold_in(base, s), 0)
                      for s in range(rows)])
    run = japi_batch._compiled_fit_rows("homography", jcfg, n_pad, rows, False)
    want = run(jnp.array(data), jnp.array(mask), jnp.array(weights), keys, jparams,
               jnp.array(nv), jnp.array(thresholds), jnp.array(data))
    want = jax.tree.map(np.asarray, want)

    jfam = jfamily("homography")
    idx_all, ok_all = [], []
    for j in range(rows):
        ii, oo = jax.vmap(lambda k, j=j: jsampling.sample_minimal(
            k, jcfg.sampler_id, jcfg.n_hypotheses, jfam.sample_size,
            jnp.array(mask[j]), jnp.int32(nv[j]), None, None))(
            jax.random.split(keys[j], jcfg.max_rounds))
        idx_all.append(np.asarray(ii))
        ok_all.append(np.asarray(oo))
    pre = convert.presampled_rows(
        np.stack(idx_all), np.stack(ok_all),
        np.zeros((rows, 0, jcfg.n_hypotheses, 4), np.int32),
        np.zeros((rows, 0, jcfg.n_hypotheses), bool), device="cpu")
    cfg = convert.engine_config(dataclasses.asdict(jcfg))
    params = convert.runtime_params(jparams._asdict())._replace(
        n_valid=nv, threshold=thresholds)
    got = engine.fit_rows(get_family("homography"), cfg, params, torch.from_numpy(data),
                          torch.from_numpy(mask), torch.from_numpy(weights),
                          presampled=pre)

    assert got.labels.shape == (rows, n_pad)
    for j in range(rows):
        assert int(got.n_models[j]) == int(want.n_models[j]) >= 2, j
        np.testing.assert_array_equal(got.active[j].numpy(), want.active[j])
        disagree = np.mean(got.labels[j].numpy() != want.labels[j])
        assert disagree <= LABEL_DISAGREEMENT_MAX, (j, disagree)
        act = got.active[j].numpy()
        np.testing.assert_allclose(_unit(got.descs[j].numpy()[act]),
                                   _unit(want.descs[j][act]), atol=DESC_ATOL)
        one = engine.row_result(got, j)
        assert one.rounds_run == int(want.rounds_run[j])
        assert len(one.round_log.accepted) == one.rounds_run


KW = dict(threshold=3.0, conf=0.9, max_iters=128, minimum_point_number=20,
          maximum_model_number=4, sampler_id=0, max_rounds=4, pearl_iters=2,
          random_seed=5, device="cpu")


def test_batched_front_end_is_batch_invariant():
    """A scene's descriptors and labels, exactly, alone, inside a
    three-scene batch of mixed sizes (four lanes: the fourth replicates
    the first scene, seed and all) and as the first of four copies (each
    copy another scene index, so another seed): its rows' seeds come from
    (seed, pad level, scene index, restart), and a finished row is frozen
    while the others run. Then four identical rows with one seed through
    engine.fit_rows: four identical results."""
    scenes = _mixed_scenes()
    batch = progressivex_tpu_torch.findHomographiesBatched(scenes, **KW)
    alone = progressivex_tpu_torch.findHomographiesBatched(scenes[:1], **KW)
    copies = progressivex_tpu_torch.findHomographiesBatched([scenes[0]] * 4, **KW)
    assert len(batch) == 3
    for (descs, labels), sc in zip(batch, scenes):
        assert descs.shape[1] == 3 and descs.shape[0] % 3 == 0
        assert labels.shape == (len(sc),)
        assert descs.shape[0] // 3 >= 2
    for other in (alone[0], copies[0]):
        np.testing.assert_array_equal(other[0], batch[0][0])
        np.testing.assert_array_equal(other[1], batch[0][1])

    n_pad, sc = 256, scenes[0]
    cfg = engine.EngineConfig(family="homography", n_hypotheses=64, max_rounds=4,
                              pearl_iters=2, sampler_id=0)
    params = engine.RuntimeParams(*api_batch.make_params(
        threshold=3.0, confidence=0.9, min_inliers=20, n_valid=len(sc)))
    data = torch.zeros(4, n_pad, 4)
    data[:, :len(sc)] = torch.as_tensor(sc, dtype=torch.float32)
    mask = torch.arange(n_pad).expand(4, n_pad) < len(sc)
    keys = api_batch.row_keys(KW["random_seed"], n_pad, [0] * 4, [0] * 4)
    rows = engine.fit_rows(get_family("homography"), cfg, params, data, mask,
                           mask.float(), keys=keys)
    for r in range(1, 4):
        assert torch.equal(rows.labels[r], rows.labels[0])
        assert torch.equal(rows.descs[r], rows.descs[0])


def test_row_batched_plain_scorer_matches_pallas_interpret():
    """score_homography_plain over [3, B, N] rows, a threshold and a
    compound flag a row, against the Pallas kernel (interpret mode on the
    CPU) vmapped over the same rows."""
    r = np.random.default_rng(0)
    rows, b, n = 3, 96, 300
    data = r.uniform(-50, 50, (rows, n, 4)).astype(np.float32)
    idx = r.integers(0, n, (rows, b, 4))
    fam = jfamily("homography")
    descs = np.stack([np.asarray(fam.minimal_solver_batched(
        jnp.array(data[j])[jnp.array(idx[j])])[0]).reshape(-1, 9) for j in range(rows)])
    descs = np.nan_to_num(descs, nan=0.0, posinf=0.0, neginf=0.0)
    compound = r.uniform(0, 1, (rows, n)).astype(np.float32)
    pmask = r.uniform(size=(rows, n)) > 0.15
    trunc_sq = np.array([25.0, 16.0, 36.0], np.float32)
    has = np.array([True, False, True])
    for m in (0, 4):
        want = jax.vmap(lambda d, ds, c, pm, t, h: pallas_scoring.fused_scores(
            "homography", d, ds, c, pm, t, 2.0, h, magsac_levels=m))(
            jnp.array(data), jnp.array(descs), jnp.array(compound), jnp.array(pmask),
            jnp.array(trunc_sq), jnp.array(has))
        got = kscoring.score_homography(
            torch.from_numpy(data), torch.from_numpy(descs), torch.from_numpy(compound),
            torch.from_numpy(pmask), torch.from_numpy(trunc_sq), 2.0,
            torch.from_numpy(has), m)
        for g, w, name in zip(got, want, ("scores", "inliers", "dots", "norms")):
            assert g.shape == (rows, b)
            if name == "inliers":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                           atol=1e-2, err_msg=f"m={m} {name}")


FRONT_ENDS = [
    (api.findHomographies, japi.findHomographies),
    (api.findTwoViewMotions, japi.findTwoViewMotions),
    (api.findLines, japi.findLines),
    (api.findVanishingPoints, japi.findVanishingPoints),
    (api.find6DPoses, japi.find6DPoses),
    (api.findEssentialMatrices, japi.findEssentialMatrices),
    (api_batch.findHomographiesBatched, japi_batch.findHomographiesBatched),
    (api_batch.findTwoViewMotionsBatched, japi_batch.findTwoViewMotionsBatched),
    (api_batch.findLinesBatched, japi_batch.findLinesBatched),
    (api_batch.findVanishingPointsBatched, japi_batch.findVanishingPointsBatched),
    (api_batch.find6DPosesBatched, japi_batch.find6DPosesBatched),
    (api_batch.findEssentialMatricesBatched, japi_batch.findEssentialMatricesBatched),
]


@pytest.mark.parametrize("port_fn, jax_fn", FRONT_ENDS, ids=lambda f: f.__name__)
def test_front_end_keywords_match_jax(port_fn, jax_fn):
    """The same keyword names and defaults as the JAX function, over all
    twelve front ends; `device` is the only extra one, and none is
    missing."""
    def kws(fn):
        return {name: p.default for name, p in inspect.signature(fn).parameters.items()}

    got, want = kws(port_fn), kws(jax_fn)
    assert set(got) - set(want) == {"device"}
    assert set(want) - set(got) == set()
    for name in set(got) & set(want):
        assert got[name] == want[name], name
    assert got["device"] is None


def test_find_homographies_takes_n_restarts():
    """n_restarts on findHomographies (two rows), here with two proposal
    sub-batches a round (256 hypotheses each), so that the per-row k* loop
    runs too."""
    scene = _scenes(1)[0]
    H, labels, stats = progressivex_tpu_torch.findHomographies(
        scene, threshold=3.0, conf=0.9, max_iters=512, minimum_point_number=20,
        sampler_id=0, max_rounds=2, pearl_iters=1, n_restarts=2, max_subbatches=2,
        device="cpu", with_statistics=True)
    assert len(stats.restart_energies) == 2 and stats.restart in (0, 1)
    assert H.shape == (3 * stats.model_number, 3) and labels.shape == (len(scene),)


def test_max_subbatches_reads_the_environment():
    code = ("from progressivex_tpu_torch import api; "
            "print(api._MAX_SUBBATCHES, api._n_subbatches(10000, 512))")
    env = dict(os.environ, PROGX_MAX_SUBBATCHES="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "2"]
    assert api._MAX_SUBBATCHES == int(os.environ.get("PROGX_MAX_SUBBATCHES", "1"))


def test_batched_input_validation():
    """tests/test_batch_api.py:186 on the port, plus the JAX package's
    mesh errors (too few devices, a mesh without a "scenes" axis),
    unknown keywords, and the engine options."""
    with pytest.raises(ValueError):
        progressivex_tpu_torch.findHomographiesBatched([np.zeros((3, 4))], device="cpu")
    with pytest.raises(ValueError):
        progressivex_tpu_torch.findTwoViewMotionsBatched([np.zeros((10, 3))], device="cpu")
    scene = _scenes(1)[0]
    with pytest.raises(ValueError, match=r"need \d+ devices, have"):
        progressivex_tpu_torch.findHomographiesBatched(
            [scene], n_devices=torch.cuda.device_count() + 2, device="cpu")
    with pytest.raises(ValueError, match="scenes"):
        progressivex_tpu_torch.findHomographiesBatched([scene], mesh=object(), device="cpu")
    with pytest.raises(TypeError):
        progressivex_tpu_torch.findHomographiesBatched([scene], not_a_kwarg=1, device="cpu")
    engine._check_slice(engine.EngineConfig(family="homography", hyp_axis="hyps"))
    with pytest.raises(ValueError, match="neighborhood"):
        engine._check_slice(engine.EngineConfig(family="homography", neighborhood="ball"))
    engine._check_slice(engine.EngineConfig(family="homography", neighborhood="grid"))
    with pytest.raises(ValueError, match="per-row sample shapes"):
        convert.presampled_rows(np.zeros((2, 8, 4)), np.zeros((2, 8), bool),
                                np.zeros((0, 8, 4)), np.zeros((0, 8), bool), device="cpu")
    assert api_batch._next_pow2(3) == 4 and api_batch._next_pow2(1) == 1
    keys = api_batch.row_keys(0, 256, [1, 0], [0, 1])
    assert not torch.equal(keys[0], keys[1])
