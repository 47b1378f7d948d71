"""Loader for the bundled ground-truth correspondence scenes — a numpy-only
copy of progressivex_tpu/io/data.py::load_corr_scene.

Format (reference `progx_utils.h:32-96`): rows `x1 y1 1 x2 y2 1 label`.
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
