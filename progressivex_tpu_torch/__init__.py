"""progressivex_tpu_torch — the PyTorch/CUDA port of progressivex_tpu.

The JAX package `progressivex_tpu` stays the reference; this package
mirrors its module layout (core/, models/, ops/, io/, eval/, api.py) so
that every module has a counterpart of the same name. It imports torch
and never jax, and nothing of the JAX package.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; without a CUDA device and without that argument they
raise (`_device.resolve_device`). The proposal scoring pass, the one
Pallas kernel of the JAX package, is a hand-written CUDA kernel per family
(`kernels/scoring.py`, `csrc/score_homography.cu`,
`csrc/score_fundamental.cu`) on the card and its plain torch version on
the CPU.

Ported: the multi-homography path (`findHomographies`), the
two-view-motion path (`findTwoViewMotions`), essential matrices
(`findEssentialMatrices`, scored by the fundamental family's kernel), 2D
lines (`findLines`), vanishing points (`findVanishingPoints`) and 6D poses
(`find6DPoses`), each also batched over many scenes (`find*Batched`) on
the engine's row axis, with live progress (`progress_callback`) and
device time by phase (`with_statistics="phases"`). Lines, VPs and poses
reach no kernel in the JAX package and are scored by plain torch on every
device. The AdelaideRMF harness (`eval/adelaide`: protocols, dataset
discovery, the bucketed dataset pass `throughput_all`) runs on the bundled
scenes or on the synthetic full-cardinality datasets of
`eval/synth_adelaide`; `cli` and `examples/` are its console entry points.
"""

import torch as _torch

__version__ = "0.1.0"

# f32-exact products, for the reasons the JAX package gives at
# progressivex_tpu/__init__.py:67-90: the kNN distance matmul
# (|a|^2 + |b|^2 - 2ab at pixel scale, ops/knn.py) and the DLT normal
# matrices (models/homography.py) lose the graph and the null vector under
# TF32's ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from progressivex_tpu_torch.api import (  # noqa: E402,F401
    Statistics,
    find6DPoses,
    findEssentialMatrices,
    findHomographies,
    findLines,
    findTwoViewMotions,
    findVanishingPoints,
)
from progressivex_tpu_torch.api_batch import (  # noqa: E402,F401
    find6DPosesBatched,
    findEssentialMatricesBatched,
    findHomographiesBatched,
    findLinesBatched,
    findTwoViewMotionsBatched,
    findVanishingPointsBatched,
)
from progressivex_tpu_torch.models import get_family  # noqa: E402,F401
