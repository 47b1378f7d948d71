"""The real-image demo of the port (progressivex_tpu_torch/examples/
demo_real_images.py) and chip_smoke.py's rendered images, on the CPU.

- The renderer (chip_smoke.py's render_h_pair and render_facade, loaded by
  path) and the demo's matches on its H pair give the SHA-256 digests that
  chip_smoke.py holds the card's run to (REAL_IMAGES_DIGEST).
- The port demo's input functions (OpenCV left out: cv2=None) give the
  inputs the JAX demo (examples/demo_real_images.py) hands its fits, bit for
  bit, on the rendered images written as the photographs' PNG files; and on
  the bundled breadcube.txt matches when the image pair is missing.
- The port's demo runs end to end on the CPU and meets the JAX demo's
  asserts, and skips loudly without images.
- The port's homography fit of the rendered matches on the CPU has an ME
  against the rendered labels within 0.03 of the JAX package's on the same
  matches (431 matches, pad 512: the one JAX compile of this file).
"""

import importlib.util
import os
import shutil

import jax
import numpy as np
import pytest

import progressivex_tpu

from progressivex_tpu_torch.examples import demo_real_images as demo
from progressivex_tpu_torch.io.detect import load_grayscale
from progressivex_tpu_torch.io.metrics import misclassification

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ME_SLACK = 0.03


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
jdemo = _load("jax_demo_real_images", os.path.join(REPO, "examples", "demo_real_images.py"))


@pytest.fixture(scope="module")
def rendered():
    view1, view2, regions = smoke.render_h_pair()
    facade = smoke.render_facade()
    corrs, _ = demo.homography_inputs(view1.astype(np.float32), view2.astype(np.float32))
    return view1, view2, regions, facade, corrs


@pytest.fixture()
def img_dir(tmp_path, rendered):
    image = pytest.importorskip("PIL.Image")
    view1, view2, _, facade, _ = rendered
    for name, img in (("breadcube1.png", view1), ("breadcube2.png", view2),
                      ("unihouse1.png", facade)):
        image.fromarray(img).save(str(tmp_path / name))
    return str(tmp_path)


def test_rendered_images_and_matches_have_their_digests(rendered):
    view1, view2, regions, facade, corrs = rendered
    assert view1.shape == view2.shape == smoke.H_PAIR_SHAPE
    assert facade.shape == smoke.FACADE_SHAPE
    assert smoke.real_image_digests(view1, view2, facade, corrs) == smoke.REAL_IMAGES_DIGEST
    labels = smoke.h_pair_labels(corrs, regions)
    assert len(corrs) <= 512 and np.bincount(labels).min() >= 12


def _captured(monkeypatch, find, result):
    """Replace progressivex_tpu.<find> with a stub that records its inputs
    and returns `result`."""
    calls = []

    def stub(*args, **kw):
        calls.append((args, kw))
        return result

    monkeypatch.setattr(progressivex_tpu, find, stub)
    return calls


def _same(a, b):
    return np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)


def test_line_inputs_equal_the_jax_demo(monkeypatch, img_dir):
    calls = _captured(monkeypatch, "findLines", (np.zeros((4, 3)), np.zeros(4000, int)))
    jdemo.demo_lines(None, img_dir)
    got = demo.line_inputs(load_grayscale(os.path.join(img_dir, "unihouse1.png")), cv2=None)
    assert _same(got, calls[0][0][0]) and len(got) == demo.LINE_POINTS


def test_vp_inputs_equal_the_jax_demo(monkeypatch, img_dir):
    calls = _captured(monkeypatch, "findVanishingPoints", (np.zeros((2, 3)), np.zeros(1, int)))
    jdemo.demo_vanishing_points(None, img_dir)
    segs, weights = demo.vp_inputs(load_grayscale(os.path.join(img_dir, "unihouse1.png")),
                                   cv2=None)
    (jsegs,), jkw = calls[0]
    assert _same(segs, jsegs) and _same(weights, jkw["weights"])


def test_homography_inputs_equal_the_jax_demo(monkeypatch, img_dir, rendered):
    calls = _captured(monkeypatch, "findHomographies", (np.zeros((6, 3)), np.zeros(1, int)))
    jdemo.demo_homographies(None, img_dir)
    corrs, source = demo.homography_inputs(
        load_grayscale(os.path.join(img_dir, "breadcube1.png")),
        load_grayscale(os.path.join(img_dir, "breadcube2.png")), cv2=None)
    assert _same(corrs, calls[0][0][0]) and _same(corrs, rendered[4])
    assert source.startswith(f"{len(corrs)} numpy-pipeline matches")


def test_bundled_matches_without_the_image_pair(monkeypatch, tmp_path, capsys):
    shutil.copy(os.path.join(REPO, "data", "breadcube", "breadcube.txt"), tmp_path)
    calls = _captured(monkeypatch, "findHomographies", (np.zeros((6, 3)), np.zeros(1, int)))
    jdemo.demo_homographies(None, str(tmp_path))
    hs, labels = demo.demo_homographies(None, str(tmp_path), device="cpu")
    raw = np.loadtxt(os.path.join(tmp_path, "breadcube.txt"))
    assert _same(calls[0][0][0], raw[:, [0, 1, 3, 4]])
    assert hs.shape[0] // 3 >= 2 and len(labels) == len(raw)
    assert "242 bundled real matches" in capsys.readouterr().out


def test_the_demo_runs_on_the_cpu(img_dir, capsys):
    out = demo.main(img_dir=img_dir, which="all", device="cpu")
    assert out["lines"][0].shape[0] >= 4
    assert out["vps"][0].shape[0] >= 2
    assert out["homographies"][0].shape[0] // 3 >= 2
    printed = capsys.readouterr().out
    assert "[lines]" in printed and "[vps]" in printed and "[homographies]" in printed


def test_the_demo_skips_without_images(tmp_path, capsys):
    assert demo.main(img_dir=str(tmp_path), which="all", device="cpu") == {
        "lines": None, "vps": None, "homographies": None}
    assert capsys.readouterr().err.count("SKIP") == 4  # facade twice, pair, breadcube.txt


def test_the_demo_reads_no_images_unless_told_where(capsys):
    assert demo.main(which="all", device="cpu") == {
        "lines": None, "vps": None, "homographies": None}
    assert capsys.readouterr().err.count("no image directory given") == 4


def test_homography_fit_me_against_jax_on_cpu(rendered):
    _, _, regions, _, corrs = rendered
    gt = smoke.h_pair_labels(corrs, regions)
    hs, labels = demo.fit_homographies(corrs, "cpu")
    jax.config.update("jax_platforms", "cpu")
    jhs, jlabels = progressivex_tpu.findHomographies(
        corrs, threshold=4.0, conf=0.5, spatial_coherence_weight=0.05,
        neighborhood_ball_radius=200.0, maximum_tanimoto_similarity=0.4, max_iters=1000,
        minimum_point_number=12, maximum_model_number=8, sampler_id=3, random_seed=0)
    me, jme = misclassification(labels, gt), misclassification(jlabels, gt)
    assert hs.shape[0] // 3 >= 2 and jhs.shape[0] // 3 >= 2
    assert abs(me - jme) <= ME_SLACK, (me, jme)
