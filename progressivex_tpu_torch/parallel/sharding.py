"""Scene and hypothesis parallelism over a mesh of devices — counterpart of
progressivex_tpu/parallel/sharding.py.

Two axes, as in the JAX package:

  * SCENES: independent fits shard contiguously across the `scenes` axis
    (JAX's P("scenes")), one host thread a shard on its device, with no
    communication; a row's result does not depend on the rows beside it,
    so a sharded batch gives the unsharded batch's bits. The threads
    share one interpreter lock: they overlap the cards' work, not the
    host's, and a fit spends most of its time on the host issuing small
    launches (PERF.md §5), so threads alone do not make several cards
    faster than one.
  * HYP: every row runs one replica of its proposal on each device of its
    `hyp` row of the mesh, each replica on samples of its own, and the
    round's winner is reduced over the replicas (core/engine, `_Replicas`:
    the JAX package's all_gather + argmax + psum). Replicas that share a
    device run as extra rows of one proposal.

`Mesh` is a [scenes, hyp] grid of torch devices. A list of devices given
to `make_mesh` may name one device several times: a virtual mesh, on which
the shards and replicas run on that device (the CPU tests and a one-card
run check the mesh's code this way; they show correctness, not scaling).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from progressivex_tpu_torch._device import run_per_device
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.core.config import EngineConfig, RuntimeParams
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.models.base import ModelFamily
from progressivex_tpu_torch.ops import prng


class Mesh:
    """A grid of torch devices with named axes, `devices[s, h]` (JAX's
    jax.sharding.Mesh as `make_mesh` builds it): `.shape` maps each axis
    name to its size."""

    def __init__(self, devices, axis_names=("scenes", "hyp")):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device grid for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def _device(d) -> torch.device:
    dev = torch.device(d)
    return torch.device("cuda", 0) if dev.type == "cuda" and dev.index is None else dev


def make_mesh(n_scenes_axis: int, n_hyp_axis: int = 1, devices=None) -> Mesh:
    """A (scenes, hyp) mesh of the first n_scenes_axis * n_hyp_axis of
    `devices` (default: every visible CUDA device), row-major. Raises when
    there are fewer; `devices` may name one device more than once."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = n_scenes_axis * n_hyp_axis
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    grid = np.empty((n_scenes_axis, n_hyp_axis), dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i // n_hyp_axis, i % n_hyp_axis] = d
    return Mesh(grid)


def _shard_params(params: RuntimeParams, rows: slice) -> RuntimeParams:
    """`params` with its per-row fields (threshold, n_valid of shape [R])
    cut to `rows`."""
    def cut(x):
        return x[rows] if np.ndim(x) == 1 else x

    return params._replace(threshold=cut(params.threshold), n_valid=cut(params.n_valid))


def _fit_shard(family, cfg, params, dev, tensors, hyp_devices):
    data, mask, weights, graph, keys = (None if t is None else t.to(dev) for t in tensors)
    return engine.fit_rows(family, cfg, params, data, mask, weights, keys=keys,
                           graph_data=graph, hyp_devices=hyp_devices)


def _take_rows(res: engine.FitResult, idx) -> engine.FitResult:
    """The rows `idx` of a FitResult."""
    fields = {f: getattr(res, f)[idx] for f in engine.FitResult._fields
              if isinstance(getattr(res, f), torch.Tensor)}
    return res._replace(**fields, round_log=engine.RoundLog(*(c[idx] for c in res.round_log)))


def _concat(results, dev) -> engine.FitResult:
    """The shards' FitResults as one, their rows in order, on `dev`."""
    def cat(ts):
        return torch.cat([t.to(dev) for t in ts])

    first = results[0]
    fields = {f: cat([getattr(r, f) for r in results])
              for f in engine.FitResult._fields
              if isinstance(getattr(first, f), torch.Tensor)}
    fields["round_log"] = engine.RoundLog(*(cat(cols) for cols in
                                           zip(*(r.round_log for r in results))))
    return first._replace(**fields)


def fit_rows_sharded(family: ModelFamily, cfg: EngineConfig, params: RuntimeParams,
                     data, point_mask, point_weights, keys, mesh: Mesh,
                     graph_data=None, out_device=None) -> engine.FitResult:
    """`engine.fit_rows` with its rows sharded contiguously over the
    mesh's scenes axis: shard s (R / n_scenes rows, R must divide) runs on
    mesh.devices[s, 0], in a host thread of its own when there are
    several, on its rows' `keys` ([R, 2]). With `cfg.hyp_axis` set, `keys`
    is [R, H, 2] with H = mesh.shape["hyp"] (`engine.fit_rows`) and the
    shard's replicas run on mesh.devices[s, :]. The shards' results are
    gathered on `out_device` (mesh.devices[0, 0] if None)."""
    n_shards = mesh.shape["scenes"]
    rows = data.shape[0]
    if rows % n_shards:
        raise ValueError(f"{rows} rows do not divide over a scenes axis of {n_shards}")
    per = rows // n_shards
    jobs = []
    for s in range(n_shards):
        cut = slice(s * per, (s + 1) * per)
        dev = mesh.devices[s, 0]
        tensors = tuple(None if t is None else t[cut]
                        for t in (data, point_mask, point_weights, graph_data, keys))
        hyp_devices = list(mesh.devices[s]) if cfg.hyp_axis is not None else None
        jobs.append((dev, (family, cfg, _shard_params(params, cut), dev, tensors,
                           hyp_devices)))
    results = run_per_device(_fit_shard, jobs)
    return _concat(results, mesh.devices[0, 0] if out_device is None else out_device)


def fit_batch(family: ModelFamily | str, cfg: EngineConfig, params: RuntimeParams,
              data, point_mask, point_weights, keys, mesh: Mesh | None = None
              ) -> engine.FitResult:
    """Fit a batch of scenes (data [S, N, d], point_mask and point_weights
    [S, N], `params` shared, `keys` [S, 2] the scenes' JAX keys,
    ops/prng.py), optionally over a ("scenes", "hyp") mesh, as the JAX
    package's fit_batch (progressivex_tpu/parallel/sharding.py:43-92):
    each scene's key is split into its cfg.n_restarts restarts' keys (the
    key itself for one restart), as `engine.fit` splits it, and under a
    mesh every replica h of a restart draws from fold_in(key, h).

    Without a mesh this is `fit_rows` on the device of `data`, every
    scene's cfg.n_restarts restarts as rows — the JAX package's
    jit(vmap(fit)). With a mesh, scenes shard contiguously over the scenes
    axis (S must divide) and every scene's hypothesis budget multiplies by
    the hyp axis's size (`fit_rows_sharded` with cfg.hyp_axis = "hyp").
    Each scene's winning restart is picked by `engine.select_restart`.
    Returns a FitResult with a leading scene axis on the device of
    `data`; `restart` and `restart_energies` are tuples of one entry a
    scene."""
    if isinstance(family, str):
        family = get_family(family)
    n_scenes = data.shape[0]
    keys = torch.as_tensor(keys).to(device=data.device, dtype=torch.int64)
    if keys.shape != (n_scenes, 2):
        raise ValueError(f"keys of shape {tuple(keys.shape)} for {n_scenes} scenes")
    n_restarts = max(int(cfg.n_restarts), 1)
    row_keys = (prng.split(keys, n_restarts) if n_restarts > 1
                else keys[:, None]).reshape(-1, 2)

    def rows(t):
        return t.repeat_interleave(n_restarts, dim=0)

    sub_cfg = dataclasses.replace(cfg, n_restarts=1)
    if mesh is None:
        res = engine.fit_rows(family, sub_cfg, params, rows(data), rows(point_mask),
                              rows(point_weights), keys=row_keys)
    else:
        if n_scenes % mesh.shape["scenes"]:
            raise ValueError(f"{n_scenes} scenes do not divide over a scenes axis "
                             f"of {mesh.shape['scenes']}")
        res = fit_rows_sharded(family, dataclasses.replace(sub_cfg, hyp_axis="hyp"),
                               params, rows(data), rows(point_mask), rows(point_weights),
                               row_keys[:, None].expand(-1, mesh.shape["hyp"], -1),
                               mesh, out_device=data.device)
    energy = res.energy.reshape(n_scenes, n_restarts).tolist()
    n_models = res.n_models.reshape(n_scenes, n_restarts).tolist()
    best = [engine.select_restart(energy[s], cfg.restart_rule, n_models[s])
            for s in range(n_scenes)]
    pick = torch.tensor([s * n_restarts + b for s, b in enumerate(best)],
                        device=res.energy.device)
    return _take_rows(res, pick)._replace(
        restart=tuple(best), restart_energies=tuple(tuple(e) for e in energy))
