"""The essential slice as a whole against the JAX package: the two-motion
gauntlet scene at seed 1 (tests/test_gauntlet.py:160-191), at the
gauntlet's keywords with its three restarts, through both front ends on
the CPU.

On this scene the draw decides the mode a run lands in (over random seeds
0-9 the JAX package's ME spans 0.010-0.045; `tools/seed_spread.py`,
PERF.md), so the two packages are compared on the same samples. The port
draws the JAX package's samples for the same random_seed (its three
restarts' keys split as progressivex_tpu/core/engine.py:590-591 and
:853-861 split them, ops/prng.py): the test holds the port's draw to
the JAX package's, element for element, then its fit must give the same
number of motions and an ME within 0.03 of the JAX package's.

This file holds the one compile of the JAX essential front end that the
port's tests make (several minutes on one core), kept apart so that
pytest-xdist's --dist loadfile runs it beside the other files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import progressivex_tpu
from progressivex_tpu.io.metrics import misclassification
from progressivex_tpu.ops import sampling as jsampling

import progressivex_tpu_torch
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.eval import extras

ME_SLACK = 0.03
SEED = 1


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's own thread pool would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(n_valid, n_hyp=409, n_restarts=3, max_rounds=10):
    """The JAX front end's samples for random_seed SEED: the `presampled`
    tuple of the port's engine, one row a restart."""
    keys = jax.random.split(jax.random.PRNGKey(SEED), n_restarts)
    dummy = jnp.zeros((1, 1), jnp.int32)
    idx, ok = [], []
    for k in keys:
        i, o = jax.vmap(lambda kk: jsampling.sample_minimal(
            kk, 0, n_hyp, 5, None, jnp.int32(n_valid), dummy, dummy))(
            jax.random.split(k, max_rounds))
        idx.append(np.asarray(i))
        ok.append(np.asarray(o))
    return (torch.from_numpy(np.stack(idx)).long(), torch.from_numpy(np.stack(ok)),
            torch.zeros(n_restarts, 0, n_hyp, 5, dtype=torch.long),
            torch.zeros(n_restarts, 0, n_hyp, dtype=torch.bool))


def test_gauntlet_two_motions_seed_1_matches_jax(monkeypatch):
    corrs, gt = extras.gauntlet_scene("two", SEED)
    K = extras.gauntlet_camera()
    jE, jlab = progressivex_tpu.findEssentialMatrices(corrs, K, K, **extras.ESSENTIAL_KW,
                                                      random_seed=SEED)
    jk, jme = jE.shape[0] // 3, misclassification(jlab, gt)

    drawn, draw = [], engine.draw

    def recording(*args):
        drawn.append(draw(*args))
        return drawn[-1]

    monkeypatch.setattr(engine, "draw", recording)
    E, lab = progressivex_tpu_torch.findEssentialMatrices(
        corrs, K, K, **extras.ESSENTIAL_KW, random_seed=SEED, device="cpu")
    assert len(drawn) == 1
    for got, want in zip(drawn[0], _jax_draws(len(corrs))):
        assert torch.equal(got, want)
    k, me = E.shape[0] // 3, misclassification(lab, gt)
    assert k == jk, f"on the JAX draw the port found {k} motions, the JAX package {jk}"
    assert abs(me - jme) <= ME_SLACK, f"ME {me:.4f} against the JAX package's {jme:.4f}"
