"""The port's samplers (ops/sampling) held to the invariants that
tests/test_sampling.py holds the JAX package's samplers to: index ranges,
the suffix-padding invariant (draws come from the valid prefix), distinct
members, NAPSAC companions drawn from the center's valid neighborhood,
and determinism for one seed, for all four sampler ids (PROSAC's prefix
and P-NAPSAC's window are tested in tests/test_torch_fundamental.py). torch.Generator and jax.random give other
numbers for the same seed, so values are not compared across packages;
the JAX samplers run on the same tables as a check of the invariants
themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progressivex_tpu.ops import sampling as jsampling

from progressivex_tpu_torch.ops import sampling

N, K, N_VALID, B, M = 200, 48, 180, 256, 4


def _knn_tables(seed=0):
    r = np.random.default_rng(seed)
    return (r.integers(0, N, (N, K)).astype(np.int32),
            r.random((N, K)) < 0.8)


def _draw(sampler_id, seed, knn_idx, knn_mask, n_valid=N_VALID):
    gen = torch.Generator().manual_seed(seed)
    return sampling.sample_minimal(gen, sampler_id, B, M, n_valid,
                                   torch.from_numpy(knn_idx),
                                   torch.from_numpy(knn_mask))


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
    jidx, jok = jsampling.sample_minimal(
        jax.random.PRNGKey(3), sampler_id, B, M, None, jnp.int32(N_VALID),
        jnp.array(knn_idx), jnp.array(knn_mask))
    jrows = np.asarray(jidx)[np.asarray(jok)]
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
