"""Synthetic full-cardinality AdelaideRMF stand-in (19 H + 18 F scenes) —
the port's copy of progressivex_tpu/eval/synth_adelaide.py.

One scene per real AdelaideRMF scene name, with its structure count, point
count and outlier rate (`H_SPECS`, `F_SPECS`), written in the real
download's layout (`<root>/synth_adelaide{H,F}/<scene>/<scene>.txt`, rows
`x1 y1 1 x2 y2 1 label`, label 0 = outlier), so that
`eval/adelaide.discover_scenes(problem, root=...)` and the dataset pass
run on it unchanged. It is a harness-scale fixture: MEs on synthetic
geometry are not comparable to the published per-scene MEs.

The specs and the scene generators `_rot`, `_h_scene` and `_f_scene` are
the JAX module's, unchanged, so the same `np.random.default_rng` gives the
same scene. One deviation: the JAX module seeds scene `name` with
`abs(hash((problem, name, seed)))`, and Python randomizes string hashes
per process, so its dataset changes from process to process. Here the
seed is `zlib.crc32(f"{problem}/{name}/{seed}")`, the same in every
process. The default directory is the port's own
(`PROGX_TORCH_SYNTH_DATA_DIR`, else
`~/.cache/progressivex_tpu_torch/synth_adelaide`), so a dataset the JAX
module wrote is never read as this one.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

# (name, n_points, n_structures, outlier_rate). Bundled-scene rows are
# exact (io/data.py loaders verified); the rest are estimates within the
# published ranges, with the hard tail (unihouse/bonhall/johnssonb scale,
# unionhouse-grade outlier rates) represented.
H_SPECS = (
    ("barrsmith", 235, 2, 0.69),
    ("bonhall", 1838, 6, 0.20),
    ("bonython", 1470, 1, 0.75),
    ("elderhalla", 257, 2, 0.60),
    ("elderhallb", 582, 3, 0.49),
    ("hartley", 432, 2, 0.62),
    ("johnssona", 372, 4, 0.21),
    ("johnssonb", 1654, 7, 0.12),
    ("ladysymon", 217, 2, 0.33),
    ("library", 261, 2, 0.56),
    ("napiera", 295, 2, 0.64),
    ("napierb", 239, 3, 0.37),
    ("neem", 241, 3, 0.37),
    ("nese", 239, 2, 0.30),
    ("oldclassicswing", 379, 2, 0.32),  # bundled-exact
    ("physics", 106, 1, 0.47),
    ("sene", 250, 2, 0.44),
    ("unihouse", 2084, 5, 0.17),  # bundled-exact
    ("unionhouse", 332, 1, 0.77),  # bundled-exact
)

F_SPECS = (
    ("biscuit", 330, 1, 0.57),
    ("biscuitbookbox", 259, 3, 0.37),
    ("boardgame", 266, 1, 0.42),
    ("book", 187, 1, 0.44),  # bundled-exact
    ("breadcartoychips", 237, 4, 0.35),
    ("breadcube", 242, 2, 0.32),  # bundled-exact
    ("breadcubechips", 230, 3, 0.35),
    ("breadtoy", 288, 2, 0.37),
    ("breadtoycar", 166, 3, 0.34),
    ("carchipscube", 165, 3, 0.36),
    ("cube", 302, 1, 0.69),
    ("cubebreadtoychips", 327, 4, 0.28),
    ("cubechips", 284, 2, 0.51),
    ("cubetoy", 249, 2, 0.40),  # bundled-exact
    ("dinobooks", 360, 3, 0.44),
    ("game", 235, 1, 0.73),
    ("gamebiscuit", 328, 2, 0.51),
    ("toycubecar", 200, 3, 0.36),
)

_W, _H = 640, 480  # image frame of the generated correspondences


def _rot(rng, max_deg):
    """Random small 3D rotation matrix."""
    ax = rng.normal(size=3)
    ax /= np.linalg.norm(ax)
    a = np.deg2rad(rng.uniform(2.0, max_deg))
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)


def _h_scene(rng, n, k, outlier_rate):
    """k planar structures under distinct homographies + uniform outliers.

    Structures are spatially COMPACT clusters (like real facade planes) —
    this is what makes NAPSAC-style local sampling meaningful on the
    synthetic data, as it is on the real scenes."""
    n_out = int(round(n * outlier_rate))
    n_in = n - n_out
    base = n_in // k
    sizes = [base + (1 if j < n_in - base * k else 0) for j in range(k)]
    rows, labels = [], []
    for j, sz in enumerate(sizes):
        cx, cy = rng.uniform(100, _W - 100), rng.uniform(80, _H - 80)
        w, h = rng.uniform(80, 220), rng.uniform(60, 160)
        p1 = np.stack([
            rng.uniform(cx - w / 2, cx + w / 2, sz),
            rng.uniform(cy - h / 2, cy + h / 2, sz),
        ], axis=1)
        # Plane-induced homography: rotation + anisotropic scale + shear +
        # translation + mild perspective.
        A = (_rot(rng, 12)[:2, :2]
             * rng.uniform(0.85, 1.15, (2,))[None, :])
        t = rng.uniform(-60, 60, 2)
        v = rng.uniform(-2e-4, 2e-4, 2)
        Hm = np.eye(3)
        Hm[:2, :2] = A
        Hm[:2, 2] = t
        Hm[2, :2] = v
        ph = np.concatenate([p1, np.ones((sz, 1))], 1) @ Hm.T
        p2 = ph[:, :2] / ph[:, 2:3] + rng.normal(scale=0.8, size=(sz, 2))
        rows.append(np.concatenate([p1, p2], axis=1))
        labels.append(np.full(sz, j + 1, np.int32))
    rows.append(np.stack([
        rng.uniform(0, _W, n_out), rng.uniform(0, _H, n_out),
        rng.uniform(0, _W, n_out), rng.uniform(0, _H, n_out),
    ], axis=1))
    labels.append(np.zeros(n_out, np.int32))
    return np.concatenate(rows), np.concatenate(labels)


def _f_scene(rng, n, k, outlier_rate):
    """k independently moving rigid 3D objects seen by one camera pair +
    uniform outliers — each object induces its own fundamental matrix.

    Objects are placed with NON-OVERLAPPING image projections (rejection-
    sampled centers): the real AdelaideRMF-F scenes photograph distinct
    physical objects occupying distinct image regions (verified: the
    bundled `book` scene has 0% cross-structure edges in the protocol's
    12-NN/radius-50 joint-space graph), and the F protocol's strong
    spatial term (w=0.5) rightly suppresses structures that interpenetrate
    spatially — early generator versions with free random centers produced
    13-32% cross-structure edges on some scenes and measured ME 0.45-0.65
    THERE ONLY, while spatially-disjoint scenes fit at ME <= 0.03."""
    f = 600.0
    n_out = int(round(n * outlier_rate))
    n_in = n - n_out
    base = n_in // k
    sizes = [base + (1 if j < n_in - base * k else 0) for j in range(k)]
    rows, labels = [], []

    def project(X):
        return np.stack([
            f * X[:, 0] / X[:, 2] + _W / 2,
            f * X[:, 1] / X[:, 2] + _H / 2,
        ], axis=1)

    placed = []  # (image-plane center, projected radius) of earlier blobs
    # More objects -> smaller objects (as in the real photographs: a
    # 4-object F scene is four small items on a desk, not four
    # frame-filling ones); keeps non-overlapping placement feasible.
    spread = {1: 0.7, 2: 0.6, 3: 0.45}.get(k, 0.35)

    def sample_center():
        """Rejection-sample a blob center whose projection clears the
        already-placed blobs; the margin relaxes every 60 tries so
        4-object scenes always terminate."""
        for attempt in range(240):
            c = np.array([rng.uniform(-1.2, 1.2), rng.uniform(-0.8, 0.8),
                          rng.uniform(4.0, 7.0)])
            pc = np.array([f * c[0] / c[2] + _W / 2,
                           f * c[1] / c[2] + _H / 2])
            pr = f * 1.3 * spread / c[2]  # projected blob half-extent
            margin = max(1.0 - 0.25 * (attempt // 60), 0.25)
            if all(np.linalg.norm(pc - pc0) >= margin * (pr + pr0)
                   for pc0, pr0 in placed):
                placed.append((pc, pr))
                return c
        placed.append((pc, pr))
        return c

    for j, sz in enumerate(sizes):
        # Compact 3D blob in front of the camera, spatially clear of the
        # other objects' projections.
        c = sample_center()
        X = c + rng.uniform(-spread, spread, (sz, 3)) * np.array([1, 0.8, 0.6])
        # Per-object rigid motion between the two frames (distinct F).
        R = _rot(rng, 18)
        t = rng.uniform(-0.5, 0.5, 3) + np.array([0, 0, rng.uniform(-0.3, 0.3)])
        X2 = X @ R.T + t + c - c @ R.T  # rotate about the blob center
        keep = (X[:, 2] > 1.0) & (X2[:, 2] > 1.0)
        X, X2 = X[keep], X2[keep]
        p1 = project(X) + rng.normal(scale=0.4, size=(len(X), 2))
        p2 = project(X2) + rng.normal(scale=0.4, size=(len(X), 2))
        inb = ((p1 >= 0) & (p1 < (_W, _H))).all(1) & \
              ((p2 >= 0) & (p2 < (_W, _H))).all(1)
        rows.append(np.concatenate([p1[inb], p2[inb]], axis=1))
        labels.append(np.full(int(inb.sum()), j + 1, np.int32))
    rows.append(np.stack([
        rng.uniform(0, _W, n_out), rng.uniform(0, _H, n_out),
        rng.uniform(0, _W, n_out), rng.uniform(0, _H, n_out),
    ], axis=1))
    labels.append(np.zeros(n_out, np.int32))
    return np.concatenate(rows), np.concatenate(labels)


DEFAULT_SYNTH_ROOT = os.path.expanduser(
    os.environ.get("PROGX_TORCH_SYNTH_DATA_DIR",
                   "~/.cache/progressivex_tpu_torch/synth_adelaide"))


def scene_seed(problem: str, name: str, seed: int = 0) -> int:
    """The generator seed of one scene: a CRC-32 of its problem, name and
    dataset seed, stable across processes."""
    return zlib.crc32(f"{problem.upper()}/{name}/{int(seed)}".encode())


def ensure_synth_dataset(problem: str, root: str | None = None,
                         seed: int = 0) -> str:
    """Generate (once) and return the synthetic dataset directory of
    `problem` ("H" or "F"): `<root>/synth_adelaide{H,F}`, one
    `<scene>/<scene>.txt` a scene. A directory that already holds every
    scene is returned as it is."""
    problem = problem.upper()
    base = root or DEFAULT_SYNTH_ROOT
    ddir = os.path.join(base, f"synth_adelaide{problem}")
    specs = H_SPECS if problem == "H" else F_SPECS
    if all(os.path.isfile(os.path.join(ddir, name, f"{name}.txt"))
           for name, *_ in specs):
        return ddir
    gen = _h_scene if problem == "H" else _f_scene
    for name, n, k, outlier_rate in specs:
        rng = np.random.default_rng(scene_seed(problem, name, seed))
        corrs, labels = gen(rng, n, k, outlier_rate)
        sdir = os.path.join(ddir, name)
        os.makedirs(sdir, exist_ok=True)
        m = np.zeros((len(labels), 7))
        m[:, 0:2] = corrs[:, 0:2]
        m[:, 2] = 1.0
        m[:, 3:5] = corrs[:, 2:4]
        m[:, 5] = 1.0
        m[:, 6] = labels
        np.savetxt(os.path.join(sdir, f"{name}.txt"), m, fmt="%.6f")
    return ddir
