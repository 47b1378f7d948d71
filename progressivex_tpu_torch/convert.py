"""Carries state from the JAX package into the port.

This system learns no weights; what defines a run is its configuration,
its runtime parameters, its samples and its fit state. These functions
take the JAX package's values as plain Python or numpy values (a caller
applies `dataclasses.asdict`, `NamedTuple._asdict` and `np.asarray` on
its side) and return the port's. Tensors are copies, placed on the
device the caller names. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from progressivex_tpu_torch._device import resolve_device
from progressivex_tpu_torch.core.config import EngineConfig, RuntimeParams, make_params


def engine_config(fields: dict) -> EngineConfig:
    """An EngineConfig from the JAX EngineConfig's fields."""
    known = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"fields the port's EngineConfig lacks: {sorted(unknown)}")
    return EngineConfig(**fields)


def runtime_params(fields: dict) -> RuntimeParams:
    """RuntimeParams from the JAX RuntimeParams' fields (scalars)."""
    return make_params(
        threshold=fields["threshold"], confidence=fields["confidence"],
        spatial_weight=fields["spatial_weight"],
        neighborhood_radius=fields["neighborhood_radius"],
        max_tanimoto=fields["max_tanimoto"], min_inliers=fields["min_inliers"],
        max_models=fields["max_models"],
        scoring_exponent=fields["scoring_exponent"],
        max_rejections=fields["max_rejections"], n_valid=fields["n_valid"])


def _tensor(x, dtype, device):
    return torch.tensor(np.asarray(x, dtype), device=resolve_device(device))


def presampled(idx_all, ok_all, idx_ext, ok_ext, *, device):
    """The engine's `presampled` tuple from the JAX package's sample
    arrays ([R, B, m] indices, [R, B] flags, and the extension pool)."""
    return (_tensor(idx_all, np.int64, device), _tensor(ok_all, bool, device),
            _tensor(idx_ext, np.int64, device), _tensor(ok_ext, bool, device))


def presampled_rows(idx_all, ok_all, idx_ext, ok_ext, *, device):
    """`engine.fit_rows`' `presampled` tuple from the JAX package's
    per-row sample arrays: [R, rounds, B, m] indices, [R, rounds, B]
    flags, and the [R, S-1, B, m] / [R, S-1, B] extension pools. In the
    batched front ends the JAX package draws row (scene s, restart r) of
    pad level n_pad with the key
    fold_in(fold_in(fold_in(PRNGKey(seed), n_pad), s), r)
    (progressivex_tpu/api_batch.py:212-227), and inside the fit each row
    splits it as `engine.fit` does; the caller draws with those keys on
    its side and hands the arrays here."""
    shapes = [np.shape(a) for a in (idx_all, ok_all, idx_ext, ok_ext)]
    if [len(s) for s in shapes] != [4, 3, 4, 3] or shapes[1][::2] != shapes[0][::2] \
            or shapes[3][::2] != shapes[0][::2] or shapes[2][::2] != shapes[0][::2] \
            or shapes[2][3] != shapes[0][3]:
        raise ValueError(f"per-row sample shapes {shapes}: expected [R, rounds, B, m], "
                         "[R, rounds, B], [R, S-1, B, m], [R, S-1, B]")
    return presampled(idx_all, ok_all, idx_ext, ok_ext, device=device)


def fit_state(descs, active, labels, compound_pref, *, device) -> dict:
    """A FitResult's descs [K, D], active [K], labels [N] and
    compound_pref [N] as the port's tensors (float32, bool, int64,
    float32)."""
    return {
        "descs": _tensor(descs, np.float32, device),
        "active": _tensor(active, bool, device),
        "labels": _tensor(labels, np.int64, device),
        "compound_pref": _tensor(compound_pref, np.float32, device),
    }
