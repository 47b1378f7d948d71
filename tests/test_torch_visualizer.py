"""The port's progress and labeling views (progressivex_tpu_torch/io/
visualizer.py) against the JAX package's, on the CPU.

- draw_labeling (points; correspondences over two images side by side;
  correspondences in two panels) and draw_round_log write PNGs with
  `save=`; both packages' PNGs must decode to the same pixels.
- LiveProgress logs the same line per event as the JAX package's, apart
  from the package name in its prefix, renders the same PNG per round
  with data, and as the port's findLines callback on the CPU sees one
  event per round run.

Matplotlib is needed and not installed by the tests (skipped without it).
"""

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
image = pytest.importorskip("PIL.Image")

from progressivex_tpu.io import visualizer as jvis  # noqa: E402

from progressivex_tpu_torch import findLines  # noqa: E402
from progressivex_tpu_torch.io import visualizer as vis  # noqa: E402


def _pixels(path):
    return np.asarray(image.open(path))


def _lines_scene(n=128, seed=0):
    """tests/test_live_progress.py's two-line scene."""
    r = np.random.default_rng(seed)
    t = r.uniform(0, 100, n // 2)
    l1 = np.stack([t, 0.5 * t + 5], 1)
    t2 = r.uniform(0, 100, n - n // 2)
    l2 = np.stack([t2, -0.3 * t2 + 60.0], 1)
    return np.concatenate([l1, l2]) + r.normal(scale=0.2, size=(n, 2))


@pytest.fixture(scope="module")
def fit():
    pts = _lines_scene()
    events = []
    descs, labels, stats = findLines(
        pts, threshold=1.0, conf=0.95, minimum_point_number=20, max_iters=128,
        random_seed=0, with_statistics=True, progress_callback=events.append,
        device="cpu")
    return pts, descs, labels, stats, events


def _corrs_case(kind):
    r = np.random.default_rng(3)
    n = 60
    corrs = r.uniform(0, 100, (n, 4 if kind != "points" else 2))
    labels = r.integers(0, 4, n)  # 3 instances, label 3 the outliers
    imgs = (None, None)
    if kind == "two images":
        imgs = (r.uniform(0, 1, (100, 120)), r.uniform(0, 1, (90, 110)))
    return corrs, labels, imgs


@pytest.mark.parametrize("kind", ["points", "two images", "two panels"])
def test_draw_labeling_same_pixels(tmp_path, kind):
    corrs, labels, (img1, img2) = _corrs_case(kind)
    paths = [str(tmp_path / f"{p}.png") for p in ("port", "jax")]
    for draw, path in zip((vis.draw_labeling, jvis.draw_labeling), paths):
        assert draw(corrs, labels, img1=img1, img2=img2, title=kind, save=path) == path
    assert np.array_equal(_pixels(paths[0]), _pixels(paths[1]))


def test_draw_round_log_same_pixels(tmp_path, fit):
    stats = fit[3]
    assert stats.iterations
    paths = [str(tmp_path / f"{p}.png") for p in ("port", "jax")]
    for draw, path in zip((vis.draw_round_log, jvis.draw_round_log), paths):
        assert draw(stats, title="lines", save=path) == path
    assert np.array_equal(_pixels(paths[0]), _pixels(paths[1]))


def test_draw_round_log_without_rounds():
    class Empty:
        iterations = []

    with pytest.raises(ValueError):
        vis.draw_round_log(Empty(), save="unused.png")


def test_live_progress_log_lines(capsys, fit):
    events = fit[4]
    port, jax_view = vis.LiveProgress(log=True), jvis.LiveProgress(log=True)
    for ev in events:
        port(ev)
    ours = capsys.readouterr().err.splitlines()
    for ev in events:
        jax_view(ev)
    theirs = capsys.readouterr().err.splitlines()
    assert len(ours) == len(events) >= 1
    assert ours == [line.replace("[progressivex_tpu]", "[progressivex_tpu_torch]")
                    for line in theirs]
    assert port.events == events


def test_live_progress_renders_rounds(tmp_path, fit):
    pts, events = fit[0], fit[4]
    for name, cls in (("port", vis.LiveProgress), ("jax", jvis.LiveProgress)):
        view = cls(data=pts, save_pattern=str(tmp_path / (name + "_{round:02d}.png")),
                   log=False)
        for ev in events:
            view(ev)
    for ev in events:
        r = ev["round"]
        assert np.array_equal(_pixels(tmp_path / f"port_{r:02d}.png"),
                              _pixels(tmp_path / f"jax_{r:02d}.png"))


def test_live_progress_as_the_callback_of_find_lines(capsys):
    pts = _lines_scene(seed=1)
    view = vis.LiveProgress(log=True)
    descs, _, stats = findLines(
        pts, threshold=1.0, conf=0.95, minimum_point_number=20, max_iters=128,
        random_seed=0, with_statistics=True, progress_callback=view, device="cpu")
    assert len(view.events) == stats.rounds_run >= 1
    assert view.events[-1]["n_active"] == descs.shape[0]
    lines = capsys.readouterr().err.splitlines()
    assert sum(line.startswith("[progressivex_tpu_torch] round ") for line in lines) \
        == len(view.events)
