"""One module a model family: everything particular to it that the
harness, the reference and the readers need, so that a new family is a
new module here and touches no other file of the benchmark.

A configuration names its family ("family" in configs/*.json): the module
bench_port/families/<family>.py (`load`). Its "generator" is a key of that
module's GENERATORS. A family module defines:

- ENTRY_SINGLE, ENTRY_BATCHED: the names of the program's entry points
  for one scene and for a list of scenes;
- GENERATORS: {generator name: fn(rng, n, k, outlier_rate) -> (data, gt)},
  where `data` is one scene as the entry points take it (any arrays,
  per-scene intrinsics among them) and `gt` its [n] ground-truth labels,
  0 = outlier;
- single_args(data), batched_args([data, ...]): the positional arguments
  of ENTRY_SINGLE for one scene and of ENTRY_BATCHED for a list of them
  (the protocol's keywords follow);
- MODEL_SHAPE: (rows, cols) of one model in the entry point's answer,
  which stacks K models as [rows * K, cols] beside the [n] labels (K for
  an outlier);
- points(data, dtype, mask=None): the scene's data as the torch tensors
  that the reference functions below take, in `dtype`, restricted to the
  points where the boolean [n] `mask` is true;
- squared_residual(models [K, rows, cols], points) -> [K, n],
  refit(points, dtype) -> [rows, cols] float64 (the least-squares model
  of the points, computed in `dtype`), model_distance(a, b, points) (px),
  REFIT_MIN (the fewest points `refit` is run on): the plain reference;
- KERNEL: the program's scoring kernel by its counter's name
  (progressivex_tpu_torch.kernels.scoring.LAUNCHES), or None where the
  family scores with no kernel of its own; where it is not None,
  KERNEL_NAMES (the kernel's names in the CUDA trace: a list of lists of
  substrings, one list a name) and RESIDUAL_OPS (operations of the
  residual per hypothesis and valid point), which roofline.py and
  metrics/score_roofline_pct.py read.

`normalized` and `null_vector` are the families' common part of their
reference `refit`; `row_points`, `rows_single` and `rows_batched` serve a
family whose scene is one array of rows [n, d].
"""

import importlib


def load(name: str):
    """The family module bench_port/families/<name>.py."""
    return importlib.import_module(f"bench_port.families.{name}")


def rows_single(data):
    """ENTRY_SINGLE's arguments for a scene that is one array of rows."""
    return (data,)


def rows_batched(datas):
    """ENTRY_BATCHED's arguments for a list of such scenes."""
    return (list(datas),)


def row_points(data, dtype, mask=None):
    """A scene that is one array of rows [n, d] as a torch tensor in
    `dtype`, the rows of `mask` only."""
    import numpy as np
    import torch

    points = torch.as_tensor(np.asarray(data, np.float64))
    if mask is not None:
        points = points[torch.as_tensor(mask)]
    return points.to(dtype)


def normalized(points, dtype):
    """Hartley normalization of points [n, 2] in `dtype`: (centred
    points scaled to mean distance sqrt(2), T [3, 3] float64)."""
    import torch

    p = points.to(dtype)
    centre = p.mean(0)
    d = p - centre
    scale = 2.0 ** 0.5 / torch.sqrt((d * d).sum(1)).mean()
    c, s = centre.double(), float(scale)
    t = torch.tensor([[s, 0.0, -s * float(c[0])], [0.0, s, -s * float(c[1])],
                      [0.0, 0.0, 1.0]], dtype=torch.float64)
    return d * scale, t


def null_vector(a):
    """The unit vector v minimizing |a v|, from the eigenvectors of a^T a;
    a^T a is formed in the dtype of `a`, the 9 x 9 eigenproblem solved in
    float64, or in float32 below it (torch solves none in bfloat16)."""
    import torch

    m = a.T @ a
    solve = torch.float64 if m.dtype == torch.float64 else torch.float32
    return torch.linalg.eigh(m.to(solve))[1][:, 0].double()
