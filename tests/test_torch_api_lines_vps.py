"""The port's findLines and findVanishingPoints against the JAX package's on
the CPU, on the synthetic scenes of eval/extras at the JAX package's bench
keywords, and the new front ends' device rule.

The port draws the JAX package's samples for a seed (ops/prng.py), and
the two runs part only where float32 rounding does: the
misclassification error must be within 0.03 of the JAX package's at the
same seed (the limit of `chip_smoke.py`), the model count within one.
"""

import numpy as np
import pytest
import torch

import progressivex_tpu
from progressivex_tpu.io.metrics import misclassification

import progressivex_tpu_torch
from progressivex_tpu_torch.eval import extras

ME_SLACK = 0.03


@pytest.mark.parametrize("entry, make, kw", [
    ("findLines", lambda: extras.make_lines_scene(seed=0), extras.LINES_KW),
    ("findVanishingPoints", lambda: extras.make_vp_scene(seed=0)[:2], extras.VP_KW),
], ids=["lines", "vps"])
def test_front_end_me_matches_jax(entry, make, kw):
    data, gt = make()
    w_models, w_labels = getattr(progressivex_tpu, entry)(data, **kw, random_seed=0)
    models, labels, stats = getattr(progressivex_tpu_torch, entry)(
        data, **kw, random_seed=0, with_statistics=True, device="cpu")
    assert models.shape[1] == 3 and labels.shape == gt.shape
    np.testing.assert_allclose(np.linalg.norm(models[:, :2 if entry == "findLines" else 3],
                                              axis=1), 1.0, rtol=1e-5)
    me, want = misclassification(labels, gt), misclassification(w_labels, gt)
    assert me <= want + ME_SLACK, (me, want)
    assert abs(models.shape[0] - w_models.shape[0]) <= 1
    assert stats.model_number == models.shape[0] and stats.rounds_run >= models.shape[0]


def test_line_weights_and_sampler_remap():
    """Per-point weights reach the fit (a zero weight keeps a point out of
    every refit, so zero-weight clutter changes nothing of the lines'
    support), and samplers 2 and 3 both run NAPSAC, as in the JAX package."""
    pts, gt = extras.make_lines_scene(n_lines=3, per_line=60, n_outliers=40, seed=1)
    kw = dict(threshold=2.0, conf=0.9, minimum_point_number=10, max_iters=64,
              random_seed=2, device="cpu")
    plain = progressivex_tpu_torch.findLines(pts, sampler_id=2, **kw)
    napsac = progressivex_tpu_torch.findLines(pts, sampler_id=3, **kw)
    np.testing.assert_array_equal(plain[1], napsac[1])
    weights = np.where(gt == 0, 0.0, 1.0)
    lines, labels = progressivex_tpu_torch.findLines(pts, weights, sampler_id=0, **kw)
    assert lines.shape[0] == 3 and misclassification(labels, gt) <= 0.05
    with pytest.raises(ValueError):
        progressivex_tpu_torch.findLines(np.zeros((1, 2)), device="cpu")
    with pytest.raises(ValueError):
        progressivex_tpu_torch.findVanishingPoints(np.zeros((5, 3)), device="cpu")


def test_new_front_ends_default_to_cuda():
    """Every new entry point runs on the card unless device="cpu" is
    passed, and raises without one; there is no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run on it")
    pts, _ = extras.make_lines_scene(n_lines=2, per_line=20, n_outliers=5)
    segs = extras.make_vp_scene()[0]
    xy = np.random.default_rng(0).uniform(0, 100, (10, 2))
    xyz = np.random.default_rng(1).uniform(0, 1, (10, 3))
    K = np.diag([500.0, 500.0, 1.0])
    calls = [
        lambda: progressivex_tpu_torch.findLines(pts),
        lambda: progressivex_tpu_torch.findVanishingPoints(segs),
        lambda: progressivex_tpu_torch.find6DPoses(xy, xyz, K),
        lambda: progressivex_tpu_torch.findLinesBatched([pts]),
        lambda: progressivex_tpu_torch.findVanishingPointsBatched([segs]),
        lambda: progressivex_tpu_torch.find6DPosesBatched([xy], [xyz], K),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _pose_scene(f, seed):
    """A posed 300 mm object (80 points, 0.3 px noise) and 20 outliers,
    seen by a camera of focal length f: (pixels [100, 2], world [100, 3], K)."""
    r = np.random.default_rng(seed)
    K = np.array([[f, 0.0, 320.0], [0.0, f, 240.0], [0.0, 0.0, 1.0]])
    X = r.uniform(-150, 150, (100, 3))
    q = (X + np.array([10.0, -20.0, 900.0])) @ K.T
    pix = q[:, :2] / q[:, 2:] + r.normal(scale=0.3, size=(100, 2))
    pix[80:] = r.uniform(0, 640, (20, 2))
    return pix, X, K


def test_batched_front_ends_are_batch_invariant():
    """On the CPU a scene's result is the same bits alone and listed first
    in a batch (its rows' seeds come from its index in the list), with
    per-point weights for lines, and with a K a scene (another focal
    length, so another normalized threshold a row) or one shared K for
    poses; a batched pose run finds the posed object."""
    kw = dict(threshold=2.0, conf=0.9, minimum_point_number=10, max_iters=64,
              max_rounds=4, random_seed=3, device="cpu")
    a, _ = extras.make_lines_scene(n_lines=3, per_line=60, n_outliers=40, seed=1)
    b, _ = extras.make_lines_scene(n_lines=2, per_line=50, n_outliers=20, seed=2)
    wa = np.random.default_rng(0).uniform(0.5, 1.0, len(a))
    batch = progressivex_tpu_torch.findLinesBatched([a, b], [wa, None], **kw)
    alone = progressivex_tpu_torch.findLinesBatched([a], [wa], **kw)
    for got, want in zip(alone[0], batch[0]):
        np.testing.assert_array_equal(got, want)
    assert batch[1][1].shape == (len(b),) and batch[0][0].shape[1] == 3

    pkw = dict(max_iters=64, max_rounds=3, random_seed=0, device="cpu")
    s0, s1 = _pose_scene(800.0, 0), _pose_scene(1200.0, 1)
    batch = progressivex_tpu_torch.find6DPosesBatched(
        [s0[0], s1[0]], [s0[1], s1[1]], [s0[2], s1[2]], **pkw)
    alone = progressivex_tpu_torch.find6DPosesBatched([s0[0]], [s0[1]], s0[2], **pkw)
    for got, want in zip(alone[0], batch[0]):
        np.testing.assert_array_equal(got, want)
    for (poses, labels), (pix, X, K) in zip(batch, (s0, s1)):
        assert poses.shape[1] == 4 and labels.shape == (100,)
        t = poses[:3, 3]
        assert np.abs(t - [10.0, -20.0, 900.0]).max() < 10.0
        assert np.mean(labels[:80] == 0) > 0.9
    with pytest.raises(ValueError, match="length mismatch"):
        progressivex_tpu_torch.find6DPosesBatched([s0[0]], [s0[1], s1[1]], s0[2], **pkw)
