"""The port's essential-matrix front ends on the CPU: findEssentialMatrices
held to tests/test_essential.py's end-to-end gates, findEssentialMatricesBatched
alone against the same scene listed first in a batch, the host
preprocessing (K^-1 normalization, threshold over the mean focal length,
the pixel graph) against the JAX front ends' own, and the input errors.
The JAX front ends are only intercepted here, never compiled.
"""

import numpy as np
import pytest
import torch

import progressivex_tpu.api as japi
import progressivex_tpu.api_batch as japi_batch

import progressivex_tpu_torch
from progressivex_tpu_torch import api, api_batch
from progressivex_tpu_torch.eval import extras

from test_torch_essential import _synth_motion


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's own thread pool would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])


def test_find_essential_matrices_two_motions():
    """tests/test_essential.py:99-126's scene and gates: two calibrated
    motions of 120 points and 60 outliers, K >= 2, and each motion's
    largest cluster holds more than 60 of its 120 points."""
    rng = np.random.default_rng(0)
    corrs, gt = [], []
    for mi in range(2):
        _, corr = _synth_motion(mi + 10, n=120, noise=5e-4)
        px1 = (np.concatenate([corr[:, :2], np.ones((120, 1))], 1) @ K.T)[:, :2]
        px2 = (np.concatenate([corr[:, 2:], np.ones((120, 1))], 1) @ K.T)[:, :2]
        corrs.append(np.concatenate([px1, px2], 1))
        gt += [mi + 1] * 120
    corrs.append(rng.uniform(0, 640, (60, 4)))
    gt = np.array(gt + [0] * 60)
    Es, labels = progressivex_tpu_torch.findEssentialMatrices(
        np.concatenate(corrs), K, K, threshold=1.5, minimum_point_number=20,
        maximum_model_number=3, max_iters=1000, random_seed=0, device="cpu")
    k = Es.shape[0] // 3
    assert k >= 2, f"expected >= 2 essential matrices, got {k}"
    assert Es.shape == (3 * k, 3) and np.isfinite(Es).all() and labels.shape == gt.shape
    for mi in (1, 2):
        lab = labels[gt == mi]
        top = np.bincount(lab[lab < k], minlength=k).max() if (lab < k).any() else 0
        assert top > 60, f"motion {mi}: largest cluster {top}/120"
    for E in Es.reshape(k, 3, 3):
        s = np.linalg.svd(E, compute_uv=False)
        np.testing.assert_allclose(s[0], s[1], rtol=1e-3)
        assert s[2] < 1e-4


def test_batched_alone_equals_listed_first():
    scenes = [extras.make_multi_motion_scene(n_motions=2, pts_per=50, outlier_frac=0.3,
                                             seed=s)[0] for s in (0, 1)]
    Ks = [K, K * np.array([[1.1], [1.1], [1.0]])]
    kw = dict(threshold=1.5, minimum_point_number=20, maximum_model_number=2,
              max_iters=64, random_seed=3, device="cpu")
    both = progressivex_tpu_torch.findEssentialMatricesBatched(scenes, Ks, Ks, **kw)
    alone = progressivex_tpu_torch.findEssentialMatricesBatched(scenes[:1], Ks[:1], Ks[:1],
                                                               **kw)
    assert len(both) == 2 and len(alone) == 1
    np.testing.assert_array_equal(alone[0][0], both[0][0])
    np.testing.assert_array_equal(alone[0][1], both[0][1])
    for E, labels in both:
        assert E.shape[1] == 3 and E.shape[0] % 3 == 0 and np.isfinite(E).all()
        assert labels.shape == (len(scenes[0]),)


def _capture(monkeypatch, module, name):
    """Replace module.name by a recorder that returns an empty fit."""
    seen = {}

    def record(*args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        n = [len(d) for d in args[1]] if name == "_run_batched" else len(args[1])
        if name == "_run_batched":
            return [(np.zeros((0, 9), np.float32), np.zeros(m, np.int32)) for m in n]
        return np.zeros((0, 9), np.float32), np.zeros(n, np.int32), None

    monkeypatch.setattr(module, name, record)
    return seen


def test_preprocessing_matches_the_jax_front_ends(monkeypatch):
    corrs, _ = extras.gauntlet_scene("two", 1)
    K2 = np.array([[760.0, 0, 300], [0, 790.0, 250], [0, 0, 1]])
    jax_seen = _capture(monkeypatch, japi, "_run")
    port_seen = _capture(monkeypatch, api, "_run")
    japi.findEssentialMatrices(corrs, K, K2, **extras.ESSENTIAL_KW)
    api.findEssentialMatrices(corrs, K, K2, **extras.ESSENTIAL_KW, device="cpu")
    assert port_seen["args"][0] == jax_seen["args"][0] == "essential"
    np.testing.assert_array_equal(port_seen["args"][1], jax_seen["args"][1])
    want = dict(jax_seen["kwargs"])
    got = dict(port_seen["kwargs"])
    assert got.pop("device") == "cpu"
    np.testing.assert_array_equal(got.pop("graph_data"), want.pop("graph_data"))
    assert got == want
    assert got["threshold"] == 1.5 / (0.25 * (800 + 800 + 760 + 790))

    jax_seen = _capture(monkeypatch, japi_batch, "_run_batched")
    port_seen = _capture(monkeypatch, api_batch, "_run_batched")
    scenes = [corrs, extras.gauntlet_scene("three", 1)[0]]
    japi_batch.findEssentialMatricesBatched(scenes, [K, K2], K, threshold=2.0)
    api_batch.findEssentialMatricesBatched(scenes, [K, K2], K, threshold=2.0, device="cpu")
    for g, w in zip(port_seen["args"][1], jax_seen["args"][1]):
        np.testing.assert_array_equal(g, w)
    want = dict(jax_seen["kwargs"])
    got = dict(port_seen["kwargs"])
    assert got.pop("device") == "cpu"
    for g, w in zip(got.pop("graph_datas"), want.pop("graph_datas")):
        np.testing.assert_array_equal(g, w)
    assert got == want


def test_input_errors():
    corrs, _ = extras.gauntlet_scene("two", 0)
    for bad in (corrs[:4], corrs[:, :3], corrs[None]):
        with pytest.raises(ValueError, match="corrs"):
            progressivex_tpu_torch.findEssentialMatrices(bad, K, K, device="cpu")
        with pytest.raises(ValueError, match="every corrs"):
            progressivex_tpu_torch.findEssentialMatricesBatched([corrs, bad], K, K,
                                                                device="cpu")
    with pytest.raises(ValueError, match="K1/K2"):
        progressivex_tpu_torch.findEssentialMatrices(corrs, K[:2], K, device="cpu")
    with pytest.raises(ValueError, match="K1/K2"):
        progressivex_tpu_torch.findEssentialMatricesBatched([corrs], [K], [K[:, :2]],
                                                            device="cpu")
    with pytest.raises(ValueError, match="length mismatch"):
        progressivex_tpu_torch.findEssentialMatricesBatched([corrs], [K, K], K, device="cpu")
    with pytest.raises(ValueError, match=r"need \d+ devices, have"):
        progressivex_tpu_torch.findEssentialMatricesBatched(
            [corrs], K, K, n_devices=torch.cuda.device_count() + 2, device="cpu")
