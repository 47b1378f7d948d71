"""The port's detectors (progressivex_tpu_torch/io/detect.py) against the JAX
package's (progressivex_tpu/io/detect.py), on the CPU.

Both are the same numpy arithmetic, so every output must be equal,
exactly (np.array_equal): tests/test_detect.py's three cases on its
seeded blob textures, each detector on chip_smoke.py's rendered H pair
(640 x 480) and facade (1024 x 768), and load_grayscale on a PNG.
"""

import importlib.util
import os

import numpy as np
import pytest

from progressivex_tpu.io import detect as jdetect

from progressivex_tpu_torch.io import detect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _textured_image(rng, h=240, w=320, n_blobs=120):
    """tests/test_detect.py's random smooth blob texture."""
    img = np.zeros((h, w), np.float32)
    ys = rng.uniform(20, h - 20, n_blobs)
    xs = rng.uniform(20, w - 20, n_blobs)
    amp = rng.uniform(40, 200, n_blobs)
    yy, xx = np.mgrid[0:h, 0:w]
    for y, x, a in zip(ys, xs, amp):
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * 3.0**2))
    return np.clip(img, 0, 255)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def images():
    view1, view2, _ = smoke.render_h_pair()
    return {"view1": view1.astype(np.float32), "view2": view2.astype(np.float32),
            "facade": smoke.render_facade().astype(np.float32)}


def test_matching_recovers_known_translation():
    rng = np.random.default_rng(0)
    im1 = _textured_image(rng)
    dy, dx = 7, -12
    im2 = np.roll(np.roll(im1, dy, axis=0), dx, axis=1)
    k1, k2 = detect.harris_keypoints(im1, n_max=400), detect.harris_keypoints(im2, n_max=400)
    assert _same(k1, jdetect.harris_keypoints(im1, n_max=400))
    assert _same(k2, jdetect.harris_keypoints(im2, n_max=400))
    d1, d2 = detect.patch_descriptors(im1, k1), detect.patch_descriptors(im2, k2)
    assert _same(d1, jdetect.patch_descriptors(im1, k1))
    m = detect.match_descriptors(d1, d2)
    assert _same(m, jdetect.match_descriptors(d1, d2))
    disp = k2[m[:, 1]] - k1[m[:, 0]]
    good = (np.abs(disp - [dx, dy]) <= 1.0).all(axis=1)
    assert len(m) >= 30 and good.mean() >= 0.8


@pytest.mark.parametrize("side", ["first", "second"])
def test_match_descriptors_empty(side):
    z = np.zeros((0, 128), np.float32)
    d = np.ones((5, 128), np.float32)
    args = (z, d) if side == "first" else (d, z)
    assert _same(detect.match_descriptors(*args), jdetect.match_descriptors(*args))
    assert detect.match_descriptors(*args).shape == (0, 2)


def test_descriptors_unit_norm_and_border_safe():
    img = _textured_image(np.random.default_rng(1))
    kps = np.array([[0.0, 0.0], [5.0, 5.0], [160.0, 120.0], [319.0, 239.0]])
    d = detect.patch_descriptors(img, kps)
    assert _same(d, jdetect.patch_descriptors(img, kps))
    n = np.linalg.norm(d, axis=1)
    np.testing.assert_allclose(n[2], 1.0, atol=1e-5)
    assert n[0] == 0.0 and n[1] == 0.0 and n[3] == 0.0


@pytest.mark.parametrize("name", ["view1", "view2", "facade"])
def test_canny(images, name):
    assert _same(detect.canny(images[name]), jdetect.canny(images[name]))


def test_canny_thresholds_and_blur(images):
    img = images["facade"]
    assert _same(detect.canny(img, low=20.0, high=60.0, sigma=2.0),
                 jdetect.canny(img, low=20.0, high=60.0, sigma=2.0))
    assert _same(detect._gaussian_blur(img, 1.4), jdetect._gaussian_blur(img, 1.4))


@pytest.mark.parametrize("kw", [{}, {"n_lines": 32, "min_len": 30.0}])
def test_hough_segments_on_the_facade(images, kw):
    edges = jdetect.canny(images["facade"])
    segs = detect.hough_segments(edges, **kw)
    assert _same(segs, jdetect.hough_segments(edges, **kw))
    assert len(segs) > 10


def test_hough_segments_without_edges():
    edges = np.zeros((40, 50), bool)
    assert _same(detect.hough_segments(edges), jdetect.hough_segments(edges))


@pytest.mark.parametrize("name", ["view1", "view2"])
def test_corners_and_descriptors_on_the_h_pair(images, name):
    img = images[name]
    k = detect.harris_keypoints(img)
    assert _same(k, jdetect.harris_keypoints(img))
    assert _same(detect.patch_descriptors(img, k), jdetect.patch_descriptors(img, k))


def test_matches_on_the_h_pair(images):
    k1 = jdetect.harris_keypoints(images["view1"])
    k2 = jdetect.harris_keypoints(images["view2"])
    d1 = jdetect.patch_descriptors(images["view1"], k1)
    d2 = jdetect.patch_descriptors(images["view2"], k2)
    for ratio in (0.8, 0.6):
        assert _same(detect.match_descriptors(d1, d2, ratio),
                     jdetect.match_descriptors(d1, d2, ratio))


def test_load_grayscale(tmp_path, images):
    image = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "facade.png")
    image.fromarray(images["facade"].astype(np.uint8)).save(path)
    got = detect.load_grayscale(path)
    assert _same(got, jdetect.load_grayscale(path))
    assert _same(got, images["facade"])
