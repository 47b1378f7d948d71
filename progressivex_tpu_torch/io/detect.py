"""Image feature detectors for the real-image demos, in numpy — a copy of
progressivex_tpu/io/detect.py, whose outputs it gives bit for bit.

The reference notebooks feed Progressive-X from classical detectors: Canny
edge points for multi-line fitting (`example_multi_lines.ipynb`), LSD line
segments for vanishing points (`example_multi_vanishing_point.ipynb`) and
SIFT matches for homographies (`example_multi_homography.ipynb` cell 2).
Where OpenCV is missing, the demos use these instead. They run on the host
once an image, before the fit, in the JAX package as here: Canny (Gaussian
blur, Sobel, non-maximum suppression, hysteresis), a Hough-based segment
extractor, and Shi-Tomasi corners, gradient-histogram descriptors and a
ratio-test, cross-checked matcher. PIL is imported only to read a file.
"""

from __future__ import annotations

import numpy as np


def load_grayscale(path: str) -> np.ndarray:
    """Image file -> float32 grayscale [H, W] in 0..255 (PIL backend)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float32)


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with edge-replicate padding."""
    r = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    # Horizontal then vertical pass, both as stacked shifted rows — at
    # demo image sizes this beats an explicit python convolution loop.
    p = np.pad(img, ((0, 0), (r, r)), mode="edge")
    out = sum(k[i] * p[:, i:i + img.shape[1]] for i in range(2 * r + 1))
    p = np.pad(out, ((r, r), (0, 0)), mode="edge")
    return sum(k[i] * p[i:i + img.shape[0], :] for i in range(2 * r + 1))


def canny(img: np.ndarray, low: float | None = None,
          high: float | None = None, sigma: float = 1.4) -> np.ndarray:
    """Canny edge map. img: [H, W] grayscale; returns bool [H, W].

    Thresholds are on the post-blur Sobel gradient magnitude. Defaults
    adapt to the image (high = 90th percentile of the non-flat
    magnitudes, low = 0.4 * high): the absolute scale depends on the
    blur sigma, so fixed OpenCV-style constants do not transfer.
    """
    g = _gaussian_blur(np.asarray(img, np.float32), sigma)
    # Sobel via shifted sums (replicate borders).
    p = np.pad(g, 1, mode="edge")
    gx = ((p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:])
          - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2]))
    gy = ((p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:])
          - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:]))
    mag = np.hypot(gx, gy)
    if high is None:
        high = float(np.percentile(mag[mag > 1.0], 90.0))
    if low is None:
        low = 0.4 * high

    # Non-maximum suppression across the quantized gradient direction:
    # keep a pixel only if it is >= both neighbors along its gradient.
    ang = np.mod(np.arctan2(gy, gx), np.pi)  # [0, pi)
    sector = ((ang + np.pi / 8) // (np.pi / 4)).astype(np.int32) % 4
    mp = np.pad(mag, 1, mode="constant")

    def shift(dy, dx):
        return mp[1 + dy:1 + dy + mag.shape[0], 1 + dx:1 + dx + mag.shape[1]]

    # sector 0: horizontal gradient -> compare left/right; 1: diagonal /;
    # 2: vertical -> up/down; 3: diagonal \.
    nbr = [
        (shift(0, 1), shift(0, -1)),
        (shift(-1, 1), shift(1, -1)),
        (shift(-1, 0), shift(1, 0)),
        (shift(-1, -1), shift(1, 1)),
    ]
    keep = np.zeros_like(mag, bool)
    for s, (a, b) in enumerate(nbr):
        keep |= (sector == s) & (mag >= a) & (mag >= b)
    nms = np.where(keep, mag, 0.0)

    strong = nms >= high
    weak = nms >= low
    # Hysteresis: grow the strong set through weak pixels (8-connected)
    # to a fixpoint. Iteration count is bounded by the longest weak
    # chain; 256 covers any demo image and the loop exits early.
    edges = strong.copy()
    for _ in range(256):
        ep = np.pad(edges, 1, mode="constant")
        grown = np.zeros_like(edges)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                grown |= ep[1 + dy:1 + dy + edges.shape[0],
                            1 + dx:1 + dx + edges.shape[1]]
        new = grown & weak
        if (new == edges).all():
            break
        edges = new
    return edges


def hough_segments(edges: np.ndarray, n_lines: int = 24,
                   rho_res: float = 2.0, theta_res_deg: float = 1.0,
                   rho_tol: float = 2.5, max_gap: float = 6.0,
                   min_len: float = 25.0) -> np.ndarray:
    """Line segments from an edge map via a Hough transform.

    Stand-in for LSD/HoughLinesP in the VP demo: accumulate edge points
    into (theta, rho) bins, take peaks greedily (suppressing each peak's
    claimed points), and split each peak line's points into contiguous
    segments at gaps > max_gap. Returns [S, 4] rows [xs, ys, xe, ye].
    """
    ys, xs = np.nonzero(edges)
    if len(xs) == 0:
        return np.zeros((0, 4))
    pts = np.stack([xs, ys], 1).astype(np.float64)
    thetas = np.deg2rad(np.arange(0.0, 180.0, theta_res_deg))
    ct, st = np.cos(thetas), np.sin(thetas)
    rho = pts[:, 0:1] * ct[None, :] + pts[:, 1:2] * st[None, :]  # [P, T]
    rmax = float(np.hypot(*edges.shape)) + 1.0
    rbin = np.round((rho + rmax) / rho_res).astype(np.int64)
    n_rbin = int(2 * rmax / rho_res) + 3
    alive = np.ones(len(pts), bool)
    segs = []
    for _ in range(n_lines):
        flat = (rbin[alive] * len(thetas)
                + np.arange(len(thetas))[None, :]).ravel()
        acc = np.bincount(flat, minlength=n_rbin * len(thetas))
        peak = int(np.argmax(acc))
        if acc[peak] < max(8, min_len / 2):
            break
        pt_idx, pt_theta = peak // len(thetas), peak % len(thetas)
        on = alive & (np.abs(rho[:, pt_theta]
                             - (pt_idx * rho_res - rmax)) <= rho_tol)
        if not on.any():
            break
        # Order the claimed points along the line direction and split at
        # gaps; each run long enough becomes one segment.
        d = np.array([-st[pt_theta], ct[pt_theta]])
        t = pts[on] @ d
        order = np.argsort(t)
        p_sorted = pts[on][order]
        t_sorted = t[order]
        cut = np.nonzero(np.diff(t_sorted) > max_gap)[0]
        start = 0
        for end in list(cut + 1) + [len(t_sorted)]:
            if (end - start) >= 2:
                a, b = p_sorted[start], p_sorted[end - 1]
                if np.hypot(*(b - a)) >= min_len:
                    segs.append([a[0], a[1], b[0], b[1]])
            start = end
        alive &= ~on
        if not alive.any():
            break
    return np.asarray(segs, np.float64).reshape(-1, 4)


def harris_keypoints(img: np.ndarray, n_max: int = 1200,
                     sigma: float = 1.2, nms_radius: int = 4,
                     border: int = 20) -> np.ndarray:
    """Shi-Tomasi corners (min eigenvalue of the structure tensor) with
    local non-maximum suppression. Returns [K, 2] (x, y), strongest first.

    The detector stage of the reference homography notebook's SIFT
    pipeline (`example_multi_homography.ipynb` cell 2) — corners instead
    of DoG blobs: the demo image pair is textured boxes where corner
    response finds the same matchable structure."""
    g = _gaussian_blur(np.asarray(img, np.float32), 1.0)
    p = np.pad(g, 1, mode="edge")
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 0.5
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5
    # Structure tensor, blurred per component.
    axx = _gaussian_blur(gx * gx, sigma)
    ayy = _gaussian_blur(gy * gy, sigma)
    axy = _gaussian_blur(gx * gy, sigma)
    # Min eigenvalue: (axx+ayy)/2 - sqrt(((axx-ayy)/2)^2 + axy^2).
    resp = 0.5 * (axx + ayy) - np.sqrt(
        0.25 * (axx - ayy) ** 2 + axy * axy)
    resp[:border, :] = resp[-border:, :] = 0.0
    resp[:, :border] = resp[:, -border:] = 0.0
    # NMS: keep pixels equal to their neighborhood max.
    r = nms_radius
    rp = np.pad(resp, r, mode="constant")
    nbhd_max = resp.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nbhd_max = np.maximum(
                nbhd_max, rp[r + dy:r + dy + resp.shape[0],
                             r + dx:r + dx + resp.shape[1]])
    ys, xs = np.nonzero((resp >= nbhd_max) & (resp > 0))
    vals = resp[ys, xs]
    order = np.argsort(-vals)[:n_max]
    return np.stack([xs[order], ys[order]], 1).astype(np.float64)


def patch_descriptors(img: np.ndarray, kps: np.ndarray,
                      patch: int = 16) -> np.ndarray:
    """SIFT-like gradient-histogram descriptors (no scale/rotation
    normalization — the demo pair is near-upright, like the notebook's).

    For each keypoint: a patch x patch window -> 4x4 spatial cells x 8
    gradient-orientation bins, magnitude-weighted, L2-normalized with
    SIFT's 0.2 clipping. Returns [K, 128] float32."""
    g = _gaussian_blur(np.asarray(img, np.float32), 1.0)
    p = np.pad(g, 1, mode="edge")
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 0.5
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5
    mag = np.hypot(gx, gy)
    ori = np.mod(np.arctan2(gy, gx), 2 * np.pi)
    obin = np.minimum((ori / (2 * np.pi / 8)).astype(np.int32), 7)
    h, w = g.shape
    half = patch // 2
    cell = patch // 4
    descs = np.zeros((len(kps), 128), np.float32)
    for i, (x, y) in enumerate(np.round(kps).astype(int)):
        y0, x0 = y - half, x - half
        if y0 < 0 or x0 < 0 or y0 + patch > h or x0 + patch > w:
            continue
        m = mag[y0:y0 + patch, x0:x0 + patch]
        o = obin[y0:y0 + patch, x0:x0 + patch]
        cy = (np.arange(patch) // cell)
        cidx = cy[:, None] * 4 + cy[None, :]  # [patch, patch] cell index
        flat = (cidx * 8 + o).ravel()
        descs[i] = np.bincount(flat, weights=m.ravel(),
                               minlength=128).astype(np.float32)
    n = np.linalg.norm(descs, axis=1, keepdims=True)
    descs /= np.maximum(n, 1e-9)
    descs = np.minimum(descs, 0.2)
    n = np.linalg.norm(descs, axis=1, keepdims=True)
    return descs / np.maximum(n, 1e-9)


def match_descriptors(d1: np.ndarray, d2: np.ndarray,
                      ratio: float = 0.8) -> np.ndarray:
    """Brute-force L2 matching with Lowe's ratio test + cross-check.

    The BFMatcher().knnMatch(k=2) + 0.8-ratio stage of the reference
    notebook, vectorized. Returns [M, 2] (index-in-d1, index-in-d2)."""
    # The ratio test needs two distinct neighbors in d2; with fewer than
    # two descriptors on either side the [:, :2] slice below would come up
    # short and nn[:, 1] would raise, so bail out to an empty match set.
    if len(d1) == 0 or len(d2) < 2:
        return np.zeros((0, 2), np.int64)
    # Squared L2 via the dot-product identity (descriptors unit-norm).
    d = 2.0 - 2.0 * (d1 @ d2.T)
    nn = np.argsort(d, axis=1)[:, :2]
    best = d[np.arange(len(d1)), nn[:, 0]]
    second = d[np.arange(len(d1)), nn[:, 1]]
    ok = np.sqrt(np.maximum(best, 0)) < ratio * np.sqrt(
        np.maximum(second, 1e-12))
    rev = np.argmin(d, axis=0)  # best d1 index per d2 column
    cross = rev[nn[:, 0]] == np.arange(len(d1))
    keep = np.nonzero(ok & cross)[0]
    return np.stack([keep, nn[keep, 0]], 1).astype(np.int64)
