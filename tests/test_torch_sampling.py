"""The port's samplers (ops/sampling) against the JAX package's
(progressivex_tpu/ops/sampling.py): for sampler ids 0-3, the same keys
and the same numpy kNN tables give the same (idx, ok) element for
element, for one key, under a vmap over round keys, with n_valid < m,
and with per-row tables (the engine's row axis). They are also held to
the invariants that tests/test_sampling.py holds the JAX samplers to:
index ranges, the suffix-padding invariant (draws come from the valid
prefix), distinct members, NAPSAC companions drawn from the center's
valid neighborhood, and determinism for one key (PROSAC's prefix and
P-NAPSAC's window are tested in tests/test_torch_fundamental.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivex_tpu.ops import sampling as jsampling

from progressivex_tpu_torch.convert import key_from_jax
from progressivex_tpu_torch.ops import prng, sampling

N, K, N_VALID, B, M = 200, 48, 180, 256, 4


def _knn_tables(seed=0):
    r = np.random.default_rng(seed)
    return (r.integers(0, N, (N, K)).astype(np.int32),
            r.random((N, K)) < 0.8)


def _draw(sampler_id, seed, knn_idx, knn_mask, n_valid=N_VALID, m=M):
    return sampling.sample_minimal(prng.key(seed), sampler_id, B, m, n_valid,
                                   torch.from_numpy(knn_idx),
                                   torch.from_numpy(knn_mask))


def _jax_draw(sampler_id, key, knn_idx, knn_mask, n_valid=N_VALID, m=M):
    idx, ok = jsampling.sample_minimal(key, sampler_id, B, m, None, jnp.int32(n_valid),
                                       jnp.array(knn_idx), jnp.array(knn_mask))
    return np.asarray(idx), np.asarray(ok)


@pytest.mark.parametrize("m", [2, 4, 7])
@pytest.mark.parametrize("sampler_id", [0, 1, 2, 3])
def test_samples_equal_the_jax_package(sampler_id, m):
    knn_idx, knn_mask = _knn_tables(seed=m)
    for seed in (0, 17):
        idx, ok = _draw(sampler_id, seed, knn_idx, knn_mask, m=m)
        jidx, jok = _jax_draw(sampler_id, jax.random.PRNGKey(seed), knn_idx, knn_mask, m=m)
        np.testing.assert_array_equal(idx.numpy(), jidx)
        np.testing.assert_array_equal(ok.numpy(), jok)


@pytest.mark.parametrize("sampler_id", [0, 1, 2, 3])
def test_samples_equal_the_jax_package_under_a_vmap(sampler_id):
    """One call over round keys [R, 2] equals jax.vmap(sample_minimal) over
    them, as the engine draws a fit's rounds."""
    knn_idx, knn_mask = _knn_tables(seed=5)
    keys = jax.random.split(jax.random.PRNGKey(sampler_id), 6)
    jidx, jok = jax.vmap(lambda k: jsampling.sample_minimal(
        k, sampler_id, B, 7, None, jnp.int32(N_VALID), jnp.array(knn_idx),
        jnp.array(knn_mask)))(keys)
    idx, ok = sampling.sample_minimal(
        key_from_jax(np.asarray(jax.random.key_data(keys)), device="cpu"), sampler_id,
        B, 7, N_VALID, torch.from_numpy(knn_idx), torch.from_numpy(knn_mask))
    assert idx.shape == (6, B, 7) and ok.shape == (6, B)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("sampler_id", [0, 1, 2, 3])
def test_too_few_valid_points_equal_the_jax_package(sampler_id):
    """n_valid < m: the JAX package's fallbacks and flags, element for
    element."""
    knn_idx, knn_mask = _knn_tables(seed=3)
    idx, ok = _draw(sampler_id, 8, knn_idx, knn_mask, n_valid=3, m=7)
    jidx, jok = _jax_draw(sampler_id, jax.random.PRNGKey(8), knn_idx, knn_mask,
                          n_valid=3, m=7)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(ok.numpy(), jok)


@pytest.mark.parametrize("sampler_id", [0, 1, 2, 3])
def test_per_row_tables_equal_the_jax_package(sampler_id):
    """Rows with tables and counts of their own ([R, N, K], [R]) and keys
    [R, T, 2]: row r equals the JAX sampler on row r's table."""
    tables = [_knn_tables(seed=s) for s in (11, 12)]
    counts = np.array([N_VALID, 150])
    keys = jax.random.split(jax.random.PRNGKey(30 + sampler_id), 6).reshape(2, 3, 2)
    idx, ok = sampling.sample_minimal(
        key_from_jax(np.asarray(jax.random.key_data(keys)), device="cpu"), sampler_id,
        B, M, torch.as_tensor(counts), torch.as_tensor(np.stack([t[0] for t in tables])),
        torch.as_tensor(np.stack([t[1] for t in tables])))
    for r in range(2):
        for t in range(3):
            jidx, jok = _jax_draw(sampler_id, keys[r, t], *tables[r], n_valid=counts[r])
            np.testing.assert_array_equal(idx[r, t].numpy(), jidx)
            np.testing.assert_array_equal(ok[r, t].numpy(), jok)


@pytest.mark.parametrize("sampler_id", [0, 1, 2, 3])
def test_valid_indices_and_determinism(sampler_id):
    knn_idx, knn_mask = _knn_tables()
    idx, ok = _draw(sampler_id, 3, knn_idx, knn_mask)
    assert idx.shape == (B, M) and ok.shape == (B,) and ok.dtype == torch.bool
    assert bool(ok.any())
    rows = idx[ok].numpy()
    assert rows.min() >= 0 and rows.max() < N
    # centers and uniform draws come from the valid prefix
    assert rows[:, 0].max() < N_VALID
    if sampler_id in (0, 1):
        assert rows.max() < N_VALID
        assert all(len(set(r.tolist())) == M for r in rows)
    idx2, ok2 = _draw(sampler_id, 3, knn_idx, knn_mask)
    assert torch.equal(idx, idx2) and torch.equal(ok, ok2)
    idx3, _ = _draw(sampler_id, 4, knn_idx, knn_mask)
    assert not torch.equal(idx, idx3)
    # The JAX sampler satisfies the same invariants on the same tables.
    jidx, jok = _jax_draw(sampler_id, jax.random.PRNGKey(3), knn_idx, knn_mask)
    jrows = jidx[jok]
    assert jrows.min() >= 0 and jrows.max() < N and jrows[:, 0].max() < N_VALID


def test_napsac_companions_are_valid_neighbors():
    knn_idx, knn_mask = _knn_tables(seed=1)
    idx, ok = _draw(3, 5, knn_idx, knn_mask)
    idx, ok = idx.numpy(), ok.numpy()
    local = 0
    for row, good in zip(idx, ok):
        c = row[0]
        allowed = set(knn_idx[c][knn_mask[c]].tolist())
        if good and len(allowed) >= M - 1 and set(row[1:].tolist()) <= allowed:
            local += 1
            # distinct slots of the center's neighborhood
            slots = [np.flatnonzero((knn_idx[c] == j) & knn_mask[c]) for j in row[1:]]
            assert all(len(s) for s in slots)
    # every center here has ~38 valid slots, so every sample is local
    assert local == B


def test_napsac_falls_back_to_uniform():
    knn_idx, knn_mask = _knn_tables(seed=2)
    knn_mask[:] = False  # no neighborhood anywhere
    idx, ok = _draw(3, 6, knn_idx, knn_mask)
    rows = idx[ok].numpy()
    assert len(rows) > B // 2
    assert rows.max() < N_VALID
    assert all(len(set(r.tolist())) == M for r in rows)


def test_too_few_valid_points_and_unknown_sampler():
    knn_idx, knn_mask = _knn_tables()
    _, ok = _draw(0, 0, knn_idx, knn_mask, n_valid=3)
    assert not bool(ok.any())
    with pytest.raises(ValueError, match="Unknown sampler id"):
        _draw(4, 0, knn_idx, knn_mask)
