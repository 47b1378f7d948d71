"""Real-image demos, on the card — the port's counterpart of
examples/demo_real_images.py (the reference notebooks on detector output):

  * multi-line fitting on Canny edge points (`example_multi_lines.ipynb`),
  * multi-vanishing-point fitting on line segments
    (`example_multi_vanishing_point.ipynb`),
  * multi-homography fitting on feature matches between two views
    (`example_multi_homography.ipynb`).

Detectors: OpenCV when it can be imported, else the numpy detectors of
io/detect (Canny and Hough segments; corners, descriptors and ratio-test
matching). Without the image pair, the homography demo fits the bundled
real matches of `breadcube.txt` in the image directory. Each demo is two
steps: `*_inputs` turns images (arrays) into the fit's inputs, and `fit_*`
fits them on `device` with the JAX demo's keywords. The images
(`unihouse1.png`, `breadcube1/2.png`, the reference notebooks'
`examples/img`) are not in this repository: name their directory with
`--img-dir` (`img_dir=`). Without it, or where an image is missing, a demo
says so and skips.

  python -m progressivex_tpu_torch.examples.demo_real_images --img-dir DIR
      [--which all|lines|vps|homographies] [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

LINE_POINTS = 4000  # the edge points the line demo keeps
SEGMENT_PERCENTILE = 70  # the VP demo keeps the segments longer than this


def _require(img_dir, *names):
    if img_dir is None:
        print(f"[demo] SKIP: no image directory given (--img-dir) for {list(names)}",
              file=sys.stderr)
        return None
    paths = [os.path.join(img_dir, n) for n in names]
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing:
        print(f"[demo] SKIP: missing image(s) {missing}", file=sys.stderr)
        return None
    return paths


def _gray_u8(img):
    return np.clip(np.asarray(img), 0, 255).astype(np.uint8)


def line_inputs(img, cv2=None):
    """Grayscale image [H, W] -> the line demo's edge points [<= 4000, 2]:
    Canny edges, subsampled by the demo's default_rng(0) permutation."""
    if cv2 is not None:
        edges = cv2.Canny(_gray_u8(img), 150, 300) > 0
    else:
        from progressivex_tpu_torch.io.detect import canny

        edges = canny(img)
    ys, xs = np.nonzero(edges)
    pts = np.stack([xs, ys], axis=1).astype(np.float64)
    return pts[np.random.default_rng(0).permutation(len(pts))[:LINE_POINTS]]


def vp_inputs(img, cv2=None):
    """Grayscale image [H, W] -> (segments [S, 4], weights [S]): line
    segments (LSD or Hough with OpenCV, else io/detect's Hough segments),
    those above the 70th percentile of length, weighted by their length."""
    if cv2 is not None:
        gray = _gray_u8(img)
        try:
            segs = cv2.createLineSegmentDetector().detect(gray)[0].reshape(-1, 4)
        except Exception:  # noqa: BLE001 - LSD is missing from some OpenCV builds
            segs = cv2.HoughLinesP(cv2.Canny(gray, 100, 200), 1, np.pi / 180, 60,
                                   minLineLength=40, maxLineGap=4).reshape(-1, 4)
        segs = segs.astype(np.float64)
    else:
        from progressivex_tpu_torch.io.detect import canny, hough_segments

        segs = hough_segments(canny(img), n_lines=32, min_len=30.0)
    lens = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
    keep = lens > np.percentile(lens, SEGMENT_PERCENTILE)
    return segs[keep].astype(np.float64), lens[keep]


def homography_inputs(im1, im2, cv2=None):
    """Two grayscale views -> (correspondences [M, 4] [x1, y1, x2, y2], a
    description): SIFT and ratio-test matching with OpenCV, else io/detect's
    corners, descriptors and cross-checked ratio-test matching."""
    if cv2 is not None:
        sift = cv2.SIFT_create()
        k1, d1 = sift.detectAndCompute(_gray_u8(im1), None)
        k2, d2 = sift.detectAndCompute(_gray_u8(im2), None)
        good = [m for m, n in cv2.BFMatcher().knnMatch(d1, d2, k=2)
                if m.distance < 0.8 * n.distance]
        corrs = np.array([[*k1[m.queryIdx].pt, *k2[m.trainIdx].pt] for m in good])
        return corrs, f"{len(corrs)} SIFT matches"
    from progressivex_tpu_torch.io.detect import (harris_keypoints, match_descriptors,
                                                  patch_descriptors)

    k1, k2 = harris_keypoints(im1), harris_keypoints(im2)
    m = match_descriptors(patch_descriptors(im1, k1), patch_descriptors(im2, k2))
    corrs = np.concatenate([k1[m[:, 0]], k2[m[:, 1]]], axis=1)
    return corrs, f"{len(corrs)} numpy-pipeline matches ({len(k1)}/{len(k2)} corners)"


def fit_lines(pts, device=None, **kw):
    """findLines with the JAX demo's keywords -> (lines, labels)."""
    from progressivex_tpu_torch import findLines

    return findLines(
        pts, threshold=3.0, conf=0.5, spatial_coherence_weight=0.0,
        neighborhood_ball_radius=200.0, maximum_tanimoto_similarity=0.4,
        max_iters=1000, minimum_point_number=120, maximum_model_number=12,
        sampler_id=0, random_seed=0, device=device, **kw)


def fit_vanishing_points(segs, weights, device=None, **kw):
    """findVanishingPoints with the JAX demo's keywords -> (vps, labels)."""
    from progressivex_tpu_torch import findVanishingPoints

    return findVanishingPoints(
        segs, weights=weights, threshold=1.5, conf=0.5,
        spatial_coherence_weight=0.0, neighborhood_ball_radius=200.0,
        maximum_tanimoto_similarity=0.4, max_iters=1000,
        minimum_point_number=10, maximum_model_number=6, sampler_id=0,
        random_seed=0, device=device, **kw)


def fit_homographies(corrs, device=None, **kw):
    """findHomographies with the JAX demo's keywords -> (Hs [3K, 3],
    labels)."""
    from progressivex_tpu_torch import findHomographies

    return findHomographies(
        corrs, threshold=4.0, conf=0.5, spatial_coherence_weight=0.05,
        neighborhood_ball_radius=200.0, maximum_tanimoto_similarity=0.4,
        max_iters=1000, minimum_point_number=12, maximum_model_number=8,
        sampler_id=3, random_seed=0, device=device, **kw)


def _load(path, cv2):
    if cv2 is not None:
        return cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    from progressivex_tpu_torch.io.detect import load_grayscale

    return load_grayscale(path)


def demo_lines(cv2, img_dir, device=None):
    """Canny edge points -> multi 2D-line fitting (reference: 3180 points,
    about 7 lines)."""
    paths = _require(img_dir, "unihouse1.png")
    if paths is None:
        return None
    pts = line_inputs(_load(paths[0], cv2), cv2)
    t0 = time.perf_counter()
    lines, labels = fit_lines(pts, device)
    k = lines.shape[0]
    print(f"[lines] {len(pts)} Canny points -> {k} lines, "
          f"{int(np.sum(labels < k))} inliers, {time.perf_counter() - t0:.2f}s")
    assert k >= 4, "a building facade should yield several dominant lines"
    return lines, labels


def demo_vanishing_points(cv2, img_dir, device=None):
    """Line segments -> multi-VP fitting (reference: 3 VPs from filtered
    LSD segments)."""
    paths = _require(img_dir, "unihouse1.png")
    if paths is None:
        return None
    segs, weights = vp_inputs(_load(paths[0], cv2), cv2)
    t0 = time.perf_counter()
    vps, labels = fit_vanishing_points(segs, weights, device)
    k = vps.shape[0]
    sizes = [int(np.sum(labels == i)) for i in range(k)]
    print(f"[vps] {len(segs)} segments -> {k} vanishing points, "
          f"cluster sizes {sizes}, {time.perf_counter() - t0:.2f}s")
    assert k >= 2, "a building photo should yield >= 2 vanishing points"
    return vps, labels


def demo_homographies(cv2, img_dir, device=None):
    """Feature matches -> multi-homography fitting (reference: 9 models
    from SIFT matches); the bundled breadcube.txt matches when the image
    pair is missing."""
    paths = _require(img_dir, "breadcube1.png", "breadcube2.png")
    if paths is not None:
        corrs, src = homography_inputs(_load(paths[0], cv2), _load(paths[1], cv2), cv2)
    else:
        paths = _require(img_dir, "breadcube.txt")
        if paths is None:
            return None
        raw = np.loadtxt(paths[0])
        # plain [x1 y1 x2 y2], or [x1 y1 1 x2 y2 1 label] rows
        corrs = raw[:, [0, 1, 3, 4]] if raw.shape[1] >= 6 else raw[:, :4]
        src = f"{len(corrs)} bundled real matches"
    t0 = time.perf_counter()
    hs, labels = fit_homographies(corrs, device)
    k = hs.shape[0] // 3
    print(f"[homographies] {src} -> {k} planes, {int(np.sum(labels < k))} inliers, "
          f"{time.perf_counter() - t0:.2f}s")
    assert k >= 2, "the breadcube pair contains >= 2 planes/objects"
    return hs, labels


def main(img_dir=None, which="all", device=None):
    try:
        import cv2
    except ImportError:
        cv2 = None
        print("[demo] OpenCV not installed; using the numpy detectors "
              "(progressivex_tpu_torch.io.detect)", file=sys.stderr)
    out = {}
    for name, demo in (("lines", demo_lines), ("vps", demo_vanishing_points),
                       ("homographies", demo_homographies)):
        if which in ("all", name):
            out[name] = demo(cv2, img_dir, device)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--img-dir", default=None)
    ap.add_argument("--which", default="all", choices=["all", "lines", "vps", "homographies"])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.img_dir, args.which, args.device)
