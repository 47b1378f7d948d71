"""Loaders for the bundled ground-truth scenes — numpy-only copies of
progressivex_tpu/io/data.py::load_corr_scene, load_tless_scene and
list_scenes.

Formats (reference `progx_utils.h:32-96`): correspondence scenes, rows
`x1 y1 1 x2 y2 1 label`; the T-LESS pose scene, `tless.txt` rows
`x y X Y Z`, `tless_intrinsics.txt` a 3x3 K, `tless_poses.txt` one 3x4
[R|t] a row, the first and the last behind a count line.
The data root is `PROGX_DATA_ROOT` when set, else the `data/` directory
at the repository root.
"""

from __future__ import annotations

import os

import numpy as np


def _resolve_default_root() -> str:
    env = os.environ.get("PROGX_DATA_ROOT")
    if env:
        return env
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "data")


DEFAULT_ROOT = _resolve_default_root()

ADELAIDE_H_SCENES = ("oldclassicswing", "unihouse", "unionhouse")
ADELAIDE_F_SCENES = ("book", "breadcube", "cubetoy")


def load_corr_scene(name: str, root: str = DEFAULT_ROOT):
    """Load a labeled correspondence scene -> (corrs [N, 4] float64,
    labels [N] int32)."""
    path = os.path.join(root, name, f"{name}.txt")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"scene file {path!r} not found — set PROGX_DATA_ROOT to a "
            "directory holding <scene>/<scene>.txt ground-truth files")
    M = np.loadtxt(path)
    corrs = np.concatenate([M[:, :2], M[:, 3:5]], axis=1)
    return corrs, M[:, -1].astype(np.int32)


def load_tless_scene(root: str = DEFAULT_ROOT):
    """Load the T-LESS 6D-pose scene -> (xy [N, 2], xyz [N, 3], K [3, 3],
    poses [P, 3, 4]), each count line checked against the rows read."""
    d = os.path.join(root, "tless")
    with open(os.path.join(d, "tless.txt")) as f:
        n = int(f.readline().split()[0])
        pts = np.loadtxt(f)
    if pts.shape != (n, 5):
        raise ValueError(f"tless.txt: expected {n}x5 rows, got {pts.shape}")
    K = np.loadtxt(os.path.join(d, "tless_intrinsics.txt")).reshape(3, 3)
    with open(os.path.join(d, "tless_poses.txt")) as f:
        p = int(f.readline().split()[0])
        poses = np.loadtxt(f).reshape(-1, 3, 4)
    if poses.shape[0] != p:
        raise ValueError(f"tless_poses.txt: expected {p} poses, got {poses.shape[0]}")
    return pts[:, :2], pts[:, 2:5], K, poses


def list_scenes(root: str = DEFAULT_ROOT):
    """The scene names under `root`: its directories <name> that hold a
    <name>.txt file, sorted."""
    return sorted(
        n
        for n in os.listdir(root)
        if os.path.isfile(os.path.join(root, n, f"{n}.txt"))
    )
