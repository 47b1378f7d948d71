"""Live progress (`progress_callback`) and `Statistics.phase_times` of the
port's single-scene front ends, against the JAX package's.

The events of a small findLines call (tests/test_live_progress.py's
scene) are compared with the JAX package's: the same keys, the same count
and rounds, one event a restart and round with several restarts (the
vmapped JAX loop emits one a lane). Every single-scene front end then
runs once with a callback and `with_statistics="phases"` on a small scene:
at least one event a round run, and `phase_times` with the JAX package's
keys, its parts adding up to its total.
"""

import numpy as np
import pytest
import torch

import progressivex_tpu
from progressivex_tpu.core import engine as jengine
from progressivex_tpu.io.profiling import DEFAULT_SCOPES as JAX_SCOPES

import progressivex_tpu_torch
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.eval import extras

@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's own thread pool would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EVENT_KEYS = {"round", "accepted", "inliers", "tanimoto", "score", "energy", "n_active",
              "labels"}
PHASE_KEYS = {f"{s}_ms" for s in JAX_SCOPES} | {"other_ms", "total_device_ms"}


def _lines(n=128, seed=0):
    """tests/test_live_progress.py's two-line scene."""
    r = np.random.default_rng(seed)
    t = r.uniform(0, 100, n // 2)
    l1 = np.stack([t, 0.5 * t + 5], 1)
    t2 = r.uniform(0, 100, n - n // 2)
    l2 = np.stack([t2, -0.3 * t2 + 60.0], 1)
    return np.concatenate([l1, l2]) + r.normal(scale=0.2, size=(n, 2))


LINES_KW = dict(threshold=1.0, conf=0.95, minimum_point_number=20, max_iters=128,
                random_seed=0)


@pytest.mark.parametrize("n_restarts", [1, 2])
def test_progress_events_match_jax(n_restarts):
    pts = _lines()
    want, got = [], []
    jdescs, _, jstats = progressivex_tpu.findLines(
        pts, **LINES_KW, n_restarts=n_restarts, progress_callback=want.append,
        with_statistics=True)
    descs, _, stats = progressivex_tpu_torch.findLines(
        pts, **LINES_KW, n_restarts=n_restarts, progress_callback=got.append,
        with_statistics=True, device="cpu")
    assert jengine.LIVE_CALLBACK is None and engine.LIVE_CALLBACK is None
    assert stats.rounds_run == jstats.rounds_run and len(descs) == len(jdescs)
    assert len(got) == len(want) == n_restarts * stats.rounds_run
    assert [e["round"] for e in got] == [e["round"] for e in want]
    for g, w in zip(got, want):
        assert set(g) == set(w) == EVENT_KEYS
        assert (g["accepted"], g["inliers"], g["n_active"]) == \
            (w["accepted"], w["inliers"], w["n_active"])
        assert g["labels"].shape == w["labels"].shape
        for key in ("tanimoto", "score", "energy"):
            assert type(g[key]) is type(w[key]) is float
    assert got[-1]["n_active"] == len(descs)


def test_no_callback_no_events_and_the_slot_is_cleared():
    pts = _lines(seed=1)
    events = []
    progressivex_tpu_torch.findLines(pts, **LINES_KW, device="cpu")
    assert events == [] and engine.LIVE_CALLBACK is None

    def boom(event):
        raise RuntimeError("consumer failed")

    with pytest.raises(RuntimeError, match="consumer failed"):
        progressivex_tpu_torch.findLines(pts, **LINES_KW, progress_callback=boom,
                                         device="cpu")
    assert engine.LIVE_CALLBACK is None
    _, _, stats = progressivex_tpu_torch.findLines(pts, **LINES_KW, with_statistics=True,
                                                   device="cpu")
    assert stats.phase_times is None


def _homography_scene():
    r = np.random.default_rng(0)
    corrs = []
    for H in (np.array([[1.0, 0.05, 30.0], [0.0, 1.0, -5.0], [0.0, 0.0, 1.0]]),
              np.array([[0.9, 0.1, -20.0], [-0.1, 1.1, 30.0], [0.0, 0.0, 1.0]])):
        p1 = r.uniform(0, 200, (50, 2))
        ph = np.concatenate([p1, np.ones((50, 1))], 1) @ H.T
        corrs.append(np.concatenate([p1, ph[:, :2] / ph[:, 2:3]
                                     + r.normal(scale=0.5, size=(50, 2))], 1))
    corrs.append(r.uniform(0, 200, (30, 4)))
    return np.concatenate(corrs)


def _pose_scene():
    """Two poses of 60 world points each in front of a 500 px camera."""
    r = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    xy, xyz = [], []
    for t in ([0.3, -0.2, 5.0], [-0.6, 0.3, 6.0]):
        X = r.uniform(-1, 1, (60, 3))
        q = X + np.array(t)
        p = q @ K.T
        xy.append(p[:, :2] / p[:, 2:3] + r.normal(scale=0.5, size=(60, 2)))
        xyz.append(X)
    return np.concatenate(xy), np.concatenate(xyz), K


def _call(name):
    """(entry point, positional inputs, keywords) of one small fit a front end."""
    corrs2, _ = extras.make_multi_motion_scene(n_motions=2, pts_per=60, outlier_frac=0.3,
                                               seed=0)
    K = extras.gauntlet_camera()
    small = dict(max_iters=64, random_seed=0, maximum_model_number=2)
    return {
        "findHomographies": ((_homography_scene(),), dict(small, threshold=3.0,
                                                          max_rounds=3)),
        "findTwoViewMotions": ((corrs2,), dict(small, n_restarts=2, threshold=2.0,
                                               max_rounds=3)),
        "findEssentialMatrices": ((corrs2, K, K), dict(small, threshold=1.5, split_pass=0,
                                                       minimum_point_number=20)),
        "findLines": ((_lines(),), dict(LINES_KW)),
        "findVanishingPoints": ((extras.make_vp_scene(seed=0)[0],),
                                dict(extras.VP_KW, max_iters=64)),
        "find6DPoses": (_pose_scene(), dict(small, n_restarts=2)),
    }[name]


@pytest.mark.parametrize("name", ["findHomographies", "findTwoViewMotions",
                                  "findEssentialMatrices", "findLines",
                                  "findVanishingPoints", "find6DPoses"])
def test_every_front_end_reports_progress_and_phase_times(name):
    inputs, kw = _call(name)
    events = []
    _, labels, stats = getattr(progressivex_tpu_torch, name)(
        *inputs, **kw, progress_callback=events.append, with_statistics="phases",
        device="cpu")
    n_restarts = kw.get("n_restarts", 1)
    assert stats.rounds_run >= 1
    assert stats.rounds_run * n_restarts <= len(events)
    assert len(events) % n_restarts == 0
    assert all(set(e) == EVENT_KEYS for e in events)
    pt = stats.phase_times
    assert set(pt) == PHASE_KEYS
    assert pt["total_device_ms"] > 0.0 and pt["progx_proposal_ms"] > 0.0
    parts = sum(v for k, v in pt.items() if k != "total_device_ms")
    assert parts == pytest.approx(pt["total_device_ms"], rel=0.02, abs=0.01)
    assert labels.shape == (len(inputs[0]),)
