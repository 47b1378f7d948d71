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

Ported so far: the multi-homography path (`findHomographies`) and the
two-view-motion path (`findTwoViewMotions`).
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
    findHomographies,
    findTwoViewMotions,
)
from progressivex_tpu_torch.models import get_family  # noqa: E402,F401
