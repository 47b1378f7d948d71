"""Engine configuration — the counterpart of progressivex_tpu/core/config.py.

`EngineConfig` keeps the JAX package's fields and defaults, so that a
configuration carries across unchanged (`convert.engine_config`); the
rationale for each default is documented there. The loop-form fields
select between semantically identical forms, as in the JAX package.
ICM and PEARL always run their predicated forms here, the JAX defaults
`unroll_icm` and `unroll_pearl` (no value is read to the host inside
them), so those two fields are not read. `unroll_rounds` runs all
max_rounds rounds predicated, PEARL under its gate, with no read between
them: on the card the rounds and the final moves are then one CUDA graph
(core/graphs.py), the same bits as the per-round graphs; a live-progress
fit runs round by round all the same (`core/engine.unrolled`).

`RuntimeParams` holds the dynamic scalars as numpy float32/int32 values,
as `make_params` in the JAX package does, so that the scalar arithmetic
(thresholds, confidences) rounds the same way. A fit over rows
(`core/engine.fit_rows`) carries `threshold` and `n_valid` per row, as
[R] tensors (`rows_params`), the JAX `make_params` taking arrays
(progressivex_tpu/core/config.py:239-240); every other field stays a
scalar that all rows share.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    family: str
    n_hypotheses: int = 512
    max_models: int = 10
    max_rounds: int = 10
    lo_steps: int = 2
    lo_candidates: int = 4
    lo_spatial_lambda: float = 0.5
    pearl_iters: int = 3
    icm_sweeps: int = 4
    knn_k: int = 12
    sampler_k: int = 48
    sampler_id: int = 0  # 0 uniform / 1 PROSAC / 2 P-NAPSAC / 3 NAPSAC
    merge_pass: bool = True
    split_pass: int = 0
    n_restarts: int = 1
    potts_band: int = 192
    live_progress: bool = False
    polish_research: int = 0
    polish_trim: float = 0.0
    final_polish: int = 0
    unroll_icm: bool = True
    unroll_pearl: bool = True
    unroll_rounds: bool = False
    final_relabel: int = 0
    restart_rule: str = "energy"
    n_subbatches: int = 1
    magsac_levels: int = 0
    neighborhood: str = "knn"
    hyp_axis: str | None = None

    def __post_init__(self):
        if self.max_models < self.max_rounds:
            # Every round can accept at most one model; slots must cover it.
            object.__setattr__(self, "max_models", self.max_rounds)


class RuntimeParams(NamedTuple):
    """Dynamic scalars (numpy float32 / int32)."""

    threshold: np.float32
    confidence: np.float32
    spatial_weight: np.float32
    neighborhood_radius: np.float32
    max_tanimoto: np.float32
    min_inliers: np.int32
    max_models: np.int32
    scoring_exponent: np.float32
    max_rejections: np.int32
    n_valid: np.int32


def make_params(
    threshold=2.0,
    confidence=0.95,
    spatial_weight=0.14,
    neighborhood_radius=8.0,
    max_tanimoto=0.5,
    min_inliers=20,
    max_models=10**9,
    scoring_exponent=2.0,
    max_rejections=10,
    n_valid=0,
) -> RuntimeParams:
    f, i = np.float32, np.int32
    return RuntimeParams(
        threshold=f(threshold),
        confidence=f(confidence),
        spatial_weight=f(spatial_weight),
        neighborhood_radius=f(neighborhood_radius),
        max_tanimoto=f(max_tanimoto),
        min_inliers=i(min_inliers),
        max_models=i(max_models),
        scoring_exponent=f(scoring_exponent),
        max_rejections=i(max_rejections),
        n_valid=i(n_valid),
    )


def rows_params(params: RuntimeParams, rows: int, device) -> RuntimeParams:
    """`params` with `threshold` (float32) and `n_valid` (int64) as [rows]
    tensors on `device`; a scalar is shared by every row."""
    def per_row(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype).expand(rows).contiguous()
        return torch.as_tensor(np.broadcast_to(np.asarray(x), (rows,)).copy(),
                               dtype=dtype, device=device)

    return params._replace(threshold=per_row(params.threshold, torch.float32),
                           n_valid=per_row(params.n_valid, torch.int64))


def truncated_sq_threshold(threshold):
    """tau_t^2 = 9/4 tau^2 (reference progressive_x.h:523), in float32: a
    numpy scalar, or a tensor of the threshold's shape (per row)."""
    if isinstance(threshold, torch.Tensor):
        return 2.25 * threshold * threshold
    return np.float32(2.25) * np.float32(threshold) * np.float32(threshold)


def per_row(x, ndim: int):
    """A per-row value shaped to broadcast against a tensor of `ndim`
    dimensions whose first is the row axis: an [R] tensor becomes
    [R, 1, ...]; a scalar (shared by all rows) is returned as it is."""
    if isinstance(x, torch.Tensor) and x.ndim == 1:
        return x.reshape(-1, *([1] * (ndim - 1)))
    return x
