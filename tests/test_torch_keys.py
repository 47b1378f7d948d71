"""The port's key chains against the JAX package's: for the same
`random_seed`, the samples that a port fit consumes equal, element for
element, those that the JAX package's fit draws from its own keys on the
same kNN tables.

Each case runs a port front end on the CPU until its draw
(`engine.draw`, stopped there) and records the rows' keys, counts, kNN
tables and samples. The JAX side derives the same fit's keys with
jax.random alone, as the JAX package's front ends and `_fit_prepared`
derive them (progressivex_tpu/api.py:263, core/engine.py:579-591 and
:850-885, api_batch.py:212-227, parallel/sharding.py:43-92), and draws
with `progressivex_tpu.ops.sampling.sample_minimal` on the recorded
tables. No JAX fit is compiled.

Cases: findHomographies under the H protocol (one restart),
findTwoViewMotions with four restarts, a batched call's rows (scene ids,
a filler lane, two restarts), a hyp-2 fit's replicas
(parallel/sharding.fit_batch on a virtual mesh), and a config with
n_subbatches > 1 (its extension batches).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import progressivex_tpu_torch as px
from progressivex_tpu.ops import sampling as jax_sampling
from progressivex_tpu_torch.convert import key_from_jax
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.core.config import EngineConfig, make_params
from progressivex_tpu_torch.eval.adelaide import scene_kwargs
from progressivex_tpu_torch.io.data import load_corr_scene
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.parallel import sharding


class _Stop(Exception):
    pass


@pytest.fixture
def draws(monkeypatch):
    """Stop every fit at its draw; yields the list of recorded draws
    (cfg, family, keys, n_valid, samp_idx, samp_mask, samples)."""
    seen, orig = [], engine.draw

    def record(family, cfg, n_valid, keys, prep):
        out = orig(family, cfg, n_valid, keys, prep)
        seen.append({"cfg": cfg, "m": family.sample_size, "keys": keys.numpy(),
                     "n_valid": n_valid.numpy(), "samp_idx": prep.samp_idx.numpy(),
                     "samp_mask": prep.samp_mask.numpy(),
                     "samples": [t.numpy() for t in out]})
        raise _Stop

    monkeypatch.setattr(engine, "draw", record)
    return seen


def _jax_run(key, cfg, m, n_valid, samp_idx, samp_mask):
    """One run's samples as `_fit_prepared` draws them from `key` (already
    folded with the hyp axis index where there is one)."""
    def pool(keys):
        return jax.vmap(lambda k: jax_sampling.sample_minimal(
            k, cfg.sampler_id, cfg.n_hypotheses, m, None, jnp.int32(n_valid),
            jnp.asarray(samp_idx), jnp.asarray(samp_mask)))(keys)

    idx_all, ok_all = pool(jax.random.split(key, cfg.max_rounds))
    n_sub = max(int(cfg.n_subbatches), 1)
    if n_sub > 1:
        idx_ext, ok_ext = pool(jax.random.split(jax.random.fold_in(key, 0x5B), n_sub - 1))
    else:
        idx_ext = np.zeros((0, cfg.n_hypotheses, m), np.int32)
        ok_ext = np.zeros((0, cfg.n_hypotheses), bool)
    return [np.asarray(t) for t in (idx_all, ok_all, idx_ext, ok_ext)]


def _assert_rows(rec, row_keys, hyp=None):
    """Every row r of the recorded draw equals the JAX draw from
    row_keys[r] (a jax key), replica h of it from fold_in(key, h)."""
    cfg, m = rec["cfg"], rec["m"]
    assert rec["keys"].shape[0] == len(row_keys)
    for r, key in enumerate(row_keys):
        assert np.array_equal(rec["keys"][r].reshape(-1, 2)[0],
                              np.asarray(jax.random.key_data(key)).astype(np.int64))
        reps = [None] if hyp is None else range(hyp)
        for h in reps:
            k = key if h is None else jax.random.fold_in(key, h)
            want = _jax_run(k, cfg, m, rec["n_valid"][r], rec["samp_idx"][r],
                            rec["samp_mask"][r])
            got = [t[r] if h is None else t[r, h] for t in rec["samples"]]
            for g, w in zip(got, want):
                assert g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def _corrs(scene, n):
    return load_corr_scene(scene)[0][:n]


@pytest.mark.parametrize("seed", [0, 3])
def test_find_homographies_draws_the_jax_samples(seed, draws):
    corrs = _corrs("oldclassicswing", 300)
    with pytest.raises(_Stop):
        px.findHomographies(corrs, **scene_kwargs(len(corrs), "H"), random_seed=seed,
                            device="cpu")
    rec, = draws
    assert rec["cfg"].sampler_id == 3
    _assert_rows(rec, [jax.random.PRNGKey(seed)])


def test_find_two_view_motions_restarts_draw_the_jax_samples(draws):
    corrs = _corrs("book", 300)
    kw = dict(scene_kwargs(len(corrs), "F"), n_restarts=4)
    with pytest.raises(_Stop):
        px.findTwoViewMotions(corrs, **kw, random_seed=5, device="cpu")
    rec, = draws
    assert rec["cfg"].sampler_id == 2
    _assert_rows(rec, list(jax.random.split(jax.random.PRNGKey(5), 4)))


def test_batched_rows_draw_the_jax_samples(draws):
    scenes = [_corrs("oldclassicswing", 200), _corrs("unionhouse", 220),
              _corrs("unihouse", 240)]
    with pytest.raises(_Stop):
        px.findHomographiesBatched(scenes, max_iters=200, max_rounds=3, n_restarts=2,
                                   sampler_id=3, random_seed=7, device="cpu")
    rec, = draws
    n_pad, lanes, lane_ids = 256, 4, [0, 1, 2, 0]  # lane 3 fills with scene 0
    base = jax.random.fold_in(jax.random.PRNGKey(7), n_pad)
    keys = [jax.random.fold_in(jax.random.fold_in(base, s), r)
            for r in range(2) for s in lane_ids]
    assert rec["keys"].shape[0] == 2 * lanes
    _assert_rows(rec, keys)
    # the filler lane draws its original's samples
    for t in rec["samples"]:
        np.testing.assert_array_equal(t[3], t[0])


def test_hyp_replicas_draw_the_jax_samples(draws):
    data = torch.as_tensor(np.stack([_corrs("oldclassicswing", 256),
                                     _corrs("unionhouse", 256)]), dtype=torch.float32)
    mask = torch.ones(2, 256, dtype=torch.bool)
    cfg = EngineConfig(family="homography", n_hypotheses=64, max_rounds=3,
                       n_restarts=2, sampler_id=2)
    params = make_params(threshold=4.0, confidence=0.5, min_inliers=10, n_valid=256,
                         neighborhood_radius=200.0)
    seeds = jnp.stack([jax.random.PRNGKey(11), jax.random.PRNGKey(12)])
    keys = key_from_jax(np.asarray(jax.random.key_data(seeds)), device="cpu")
    with pytest.raises(_Stop):
        sharding.fit_batch("homography", cfg, params, data, mask, torch.ones(2, 256),
                           keys, mesh=sharding.make_mesh(1, 2, devices=["cpu"] * 2))
    rec, = draws
    assert rec["keys"].shape == (4, 2, 2)
    row_keys = [k for s in seeds for k in jax.random.split(s, 2)]
    _assert_rows(rec, row_keys, hyp=2)


def test_extension_batches_draw_the_jax_samples(draws):
    corrs = _corrs("unihouse", 300)
    kw = dict(scene_kwargs(len(corrs), "H"), max_iters=3000, max_subbatches=4)
    with pytest.raises(_Stop):
        px.findHomographies(corrs, **kw, random_seed=2, device="cpu")
    rec, = draws
    assert rec["cfg"].n_subbatches > 1
    assert rec["samples"][2].shape[1] == rec["cfg"].n_subbatches - 1
    _assert_rows(rec, [jax.random.PRNGKey(2)])


@pytest.mark.parametrize("sampler_id", [0, 1])
def test_uniform_and_prosac_rows_draw_the_jax_samples(sampler_id, draws):
    corrs = _corrs("book", 300)
    kw = dict(scene_kwargs(len(corrs), "F"), sampler_id=sampler_id, n_restarts=2)
    with pytest.raises(_Stop):
        px.findTwoViewMotions(corrs, **kw, random_seed=9, device="cpu")
    rec, = draws
    _assert_rows(rec, list(jax.random.split(jax.random.PRNGKey(9), 2)))


def test_a_fit_without_keys_or_samples_raises():
    cfg = dataclasses.replace(EngineConfig(family="homography"), max_rounds=1)
    data = torch.zeros(1, 16, 4)
    with pytest.raises(ValueError, match="keys or presampled"):
        engine.fit_rows(get_family("homography"), cfg, make_params(n_valid=16),
                        data, torch.ones(1, 16, dtype=torch.bool), torch.ones(1, 16))
