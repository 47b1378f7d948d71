"""AdelaideRMF-H and -F protocols and the dataset pass — counterpart of
progressivex_tpu/eval/adelaide.py (`H_PROTOCOL`, `F_PROTOCOL`,
`discover_scenes`, `evaluate_scenes`, `_bucket_size`, the lane plan of
`_prepare_lane_batches`, `ThroughputResult`, `throughput_batch`,
`dataset_pass_seconds`, `throughput_all`).

A dataset is a directory of `<scene>/<scene>.txt` files: an explicit
`root` (the synthetic full-cardinality datasets of `eval/synth_adelaide`,
or a copy of the real download), else the bundled scenes under `data/`.
Nothing is downloaded.

The dataset pass runs the JAX package's plan: scenes bucketed by
`_bucket_size` (the pad levels from 256 up, or the caller's
`allowed_buckets`); each bucket's scenes replicated cyclically up to a
lane target (128 unless given) within a row budget (lanes x restarts at
most min(768, 384 * 4095 // flat hypotheses), and at most 160 rows, or
`PROGX_F_ROWS`, where restarts are rows); a bucket with more scenes than
lanes runs in chunks. Each chunk is one `api_batch._run_batched` call on
the card, F's restarts rows of it. The split move runs in buckets of 512
points and up (`split_pass_min_npad`). A chunk's rows draw from the JAX
package's keys, split(PRNGKey(seed), rows) (progressivex_tpu/eval/
adelaide.py:402,420,465-466): the untimed call at `seed`, timing run i at
seed + i + 1.

`PROGX_BENCH_DEVICES=n` (n > 1) shards every batch's rows over the
scenes axis of `make_mesh(n, 1)`, n cards, as in the JAX package
(progressivex_tpu/eval/adelaide.py:619-627): the lane plan then gives
each batch at least n lanes.
"""

from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from progressivex_tpu_torch import api_batch
from progressivex_tpu_torch.api import (PAD_LEVELS, _hyp_budget, findHomographies,
                                        findTwoViewMotions)
from progressivex_tpu_torch.io.data import (ADELAIDE_F_SCENES, ADELAIDE_H_SCENES,
                                            DEFAULT_ROOT, load_corr_scene)
from progressivex_tpu_torch.io.metrics import misclassification
from progressivex_tpu_torch.kernels._build import LAUNCHES
from progressivex_tpu_torch.kernels.scoring import KERNELS
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.ops import prng
from progressivex_tpu_torch.parallel.sharding import make_mesh

# The notebook protocols (adelaideH.ipynb / adelaideF.ipynb cell 3) with the
# JAX package's measured extensions; the reasons for each are at
# progressivex_tpu/eval/adelaide.py:46-144.
H_PROTOCOL = dict(
    threshold=4.0, conf=0.5, spatial_coherence_weight=0.05,
    neighborhood_ball_radius=200.0, maximum_tanimoto_similarity=0.4,
    max_iters=1000, minimum_point_number=10, maximum_model_number=6,
    sampler_id=3, scoring_exponent=2,
    magsac_levels=4,
    final_relabel=2,
    pearl_iters=2,
    split_pass=1,
    split_pass_min_npad=512,  # harness key: split only scenes padded >= 512
)
F_PROTOCOL = dict(
    threshold=0.75, conf=0.5, spatial_coherence_weight=0.5,
    neighborhood_ball_radius=50.0, maximum_tanimoto_similarity=0.4,
    max_iters=10000, minimum_point_number=7, maximum_model_number=4,
    sampler_id=2, scoring_exponent=1.0,
    max_rounds=6,
    pearl_iters=2,
    n_restarts=4,
    magsac_levels=4,
    restart_rule="energy+5k",
    final_relabel=2,
)
_PROBLEMS = {"H": (H_PROTOCOL, findHomographies, ADELAIDE_H_SCENES, "homography"),
             "F": (F_PROTOCOL, findTwoViewMotions, ADELAIDE_F_SCENES, "fundamental")}

# The batched pad levels: 256 is the floor (smaller scenes share it).
_BUCKETS = tuple(level for level in PAD_LEVELS if level >= 256)


def _bucket_size(n: int, allowed=None) -> int:
    """Smallest pad level >= n among `allowed` if one fits (the levels a
    bundled run already used), else among the batched levels from 256."""
    if allowed:
        fits = [b for b in sorted(allowed) if n <= b]
        if fits:
            return fits[0]
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // 128) * 128


def scene_kwargs(n_points: int, problem: str = "H") -> dict:
    """The protocol of `problem` for one scene of n_points points, with
    split_pass gated on its padded size (`_bucket_size`) as the JAX
    harness gates it."""
    kw = dict(_PROBLEMS[problem.upper()][0])
    min_npad = int(kw.pop("split_pass_min_npad", 0))
    if min_npad and _bucket_size(n_points) < min_npad:
        kw.pop("split_pass")
    return kw


def discover_scenes(problem: str, root: str | None = None):
    """(scene_root, scene_names, is_full_dataset): the scenes under an
    explicit `root` that holds any, else the bundled scenes of `problem`
    with is_full_dataset false."""
    problem = problem.upper()
    if root is not None and os.path.isdir(root):
        names = sorted(n for n in os.listdir(root)
                       if os.path.isfile(os.path.join(root, n, f"{n}.txt")))
        if names:
            return root, names, True
    return DEFAULT_ROOT, list(_PROBLEMS[problem][2]), False


def evaluate_scenes(problem: str = "H", root: str | None = None, seed: int = 0,
                    do_logging: bool = False, device=None, scenes=None):
    """Run the protocol of `problem` ("H" or "F") once per scene of the
    dataset (`discover_scenes`; `scenes` picks some of them), one
    single-scene fit each. Returns the JAX package's keys, {"problem",
    "full_dataset", "n_scenes", "mean_me", "per_scene": {name: {"me",
    "time_s", "n", "n_models", "labels"}}}."""
    problem = problem.upper()
    _, fn, _, _ = _PROBLEMS[problem]
    scene_root, names, full = discover_scenes(problem, root)
    per_scene = {}
    for name in names if scenes is None else scenes:
        corrs, gt = load_corr_scene(name, root=scene_root)
        t0 = time.perf_counter()
        models, labels = fn(corrs, **scene_kwargs(len(gt), problem),
                            random_seed=seed, device=device)
        dt = time.perf_counter() - t0
        me = float(misclassification(labels, gt))
        per_scene[name] = {"me": me, "time_s": dt, "n": len(gt),
                           "n_models": models.shape[0] // 3, "labels": labels}
        if do_logging:
            print(f"[{problem}] {name}: ME={me:.3f} ({dt:.3f}s)", file=sys.stderr)
    mes = [v["me"] for v in per_scene.values()]
    return {"problem": problem, "full_dataset": full, "n_scenes": len(per_scene),
            "mean_me": float(np.mean(mes)) if mes else float("nan"),
            "per_scene": per_scene}


class LaneBatch(NamedTuple):
    """One batch of the dataset pass: `scenes` (indices into the dataset's
    scene list) padded to n_pad points, replicated cyclically to `lanes`
    lanes, each lane `n_restarts` rows; the split move on if split_pass."""

    n_pad: int
    lanes: int
    n_restarts: int
    split_pass: int
    scenes: tuple

    @property
    def rows(self) -> int:
        return self.lanes * self.n_restarts

    @property
    def lane_ids(self) -> tuple:
        """The scene of each lane."""
        return tuple(self.scenes[j % len(self.scenes)] for j in range(self.lanes))


def lane_plan(problem: str, sizes, lane_target: int | None = None,
              allowed_buckets=None, n_devices: int = 1) -> list:
    """The JAX package's lane plan (progressivex_tpu/eval/adelaide.py:
    606-722) for scenes of `sizes` points: one LaneBatch a bucket, or a
    chunk of a bucket holding more scenes than its lanes; with a scenes
    axis of `n_devices` (a power of two), at least that many lanes a
    batch, so that its rows divide over the axis."""
    problem = problem.upper()
    kw, _, _, family_name = _PROBLEMS[problem]
    family = get_family(family_name)
    n_restarts = int(kw.get("n_restarts", 1))
    flat_hyp = _hyp_budget(kw["max_iters"], family.max_solutions,
                           family.name) * family.max_solutions
    max_rows = min(768, (384 * 4095) // max(flat_hyp, 1))
    if n_restarts > 1:
        max_rows = min(max_rows, int(os.environ.get("PROGX_F_ROWS", "160")))
    buckets: dict[int, list[int]] = {}
    for i, n in enumerate(sizes):
        buckets.setdefault(_bucket_size(int(n), allowed_buckets), []).append(i)
    plan = []
    for n_pad in sorted(buckets):
        idxs = buckets[n_pad]
        sp = int(kw.get("split_pass", 0))
        if n_pad < int(kw.get("split_pass_min_npad", 0)):
            sp = 0
        target = lane_target or 128
        while target * n_restarts > max_rows and target > 32:
            target //= 2
        lanes = max(target, 1 << (len(idxs) - 1).bit_length())
        while lanes * n_restarts > max_rows and lanes > 32:
            lanes //= 2
        lanes = max(lanes, n_devices)
        for c in range(0, len(idxs), lanes):
            plan.append(LaneBatch(n_pad, lanes, n_restarts, sp,
                                  tuple(idxs[c:c + lanes])))
    return plan


class ThroughputResult(NamedTuple):
    """What one scene-batched throughput measurement yields (the JAX
    package's fields). `pass_seconds` is the sum over batches of the best
    batch time: one pass over the distinct scenes through the same
    batches."""

    scenes_per_sec: float
    mean_me: float
    n_scenes: int  # batched lanes (replication included)
    full_dataset: bool
    compile_seconds: float
    pass_seconds: float
    n_distinct: int  # distinct scenes covered by the batches
    buckets: tuple  # per-batch dicts: n_pad, lanes, n_restarts, rows, best_s, launches


class _Prepared(NamedTuple):
    problem: str
    names: list
    scenes: list  # (corrs [n, 4] float32, labels [n]) a scene
    full: bool
    plan: list


def _bench_mesh():
    """The scenes mesh `PROGX_BENCH_DEVICES` asks for, or None."""
    n_dev = int(os.environ.get("PROGX_BENCH_DEVICES", "1"))
    return make_mesh(n_dev, 1) if n_dev > 1 else None


def _prepare(problem, root, lane_target, allowed_buckets, mesh) -> _Prepared:
    problem = problem.upper()
    scene_root, names, full = discover_scenes(problem, root)
    scenes = []
    for name in names:
        corrs, gt = load_corr_scene(name, root=scene_root)
        scenes.append((np.ascontiguousarray(corrs, np.float32), gt))
    plan = lane_plan(problem, [len(gt) for _, gt in scenes], lane_target,
                     allowed_buckets, 1 if mesh is None else mesh.shape["scenes"])
    return _Prepared(problem, names, scenes, full, plan)


def _run(prep: _Prepared, batch: LaneBatch, seed: int, dev, mesh):
    """One batch on `dev`, or over `mesh`'s scenes axis: the labels of
    every lane. Row i draws from split(PRNGKey(seed), rows)[i], as in the
    JAX package's batch, so a replicated lane is another draw of its
    scene."""
    kw = scene_kwargs(batch.n_pad, prep.problem)
    kw.pop("split_pass", None)
    thr = kw.pop("threshold")
    keys = prng.split(prng.key(seed, dev if mesh is None else mesh.devices[0, 0]),
                      batch.rows)
    out = api_batch._run_batched(
        _PROBLEMS[prep.problem][3], [prep.scenes[i][0] for i in batch.lane_ids], None,
        thresholds=thr, device=dev, split_pass=batch.split_pass,
        pad_to=batch.n_pad, lanes=batch.lanes, mesh=mesh, keys=keys, **kw)
    return [labels for _, labels in out]


def _sync(dev, mesh):
    """Wait for `dev`, or for every card of `mesh`."""
    devs = {dev} if mesh is None else set(mesh.devices.reshape(-1))
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _warm_up(preps, seed, dev, mesh) -> float:
    """The first, untimed call of every batch (the kernels' build and the
    first launches); returns its wall seconds."""
    t0 = time.perf_counter()
    for prep in preps:
        for batch in prep.plan:
            _run(prep, batch, seed, dev, mesh)
    _sync(dev, mesh)
    return time.perf_counter() - t0


def _time_batches(prep: _Prepared, n_timing_runs, seed, dev, mesh, compile_s):
    """Timed runs of every batch (seeds seed + 1, seed + 2, ...): the best
    host-clock time of each, ending in a device synchronization. ME comes
    from every lane of every timing run, averaged per distinct scene
    first, so replication does not weight it."""
    mes: dict[str, list] = {}
    info, total_time, total_lanes = [], 0.0, 0
    for batch in prep.plan:
        times = []
        for i in range(n_timing_runs):
            before = sum(LAUNCHES[k] for k in KERNELS)
            t0 = time.perf_counter()
            labels = _run(prep, batch, seed + i + 1, dev, mesh)
            _sync(dev, mesh)
            times.append(time.perf_counter() - t0)
            launches = sum(LAUNCHES[k] for k in KERNELS) - before
            for s, lab in zip(batch.lane_ids, labels):
                mes.setdefault(prep.names[s], []).append(
                    misclassification(lab, prep.scenes[s][1]))
        best = min(times)
        total_time += best
        total_lanes += batch.lanes
        info.append({"n_pad": batch.n_pad, "lanes": batch.lanes,
                     "n_restarts": batch.n_restarts, "rows": batch.rows,
                     "best_s": best, "launches": launches})
        print(f"[progressivex_tpu_torch.eval] {prep.problem} bucket n_pad={batch.n_pad}: "
              f"{batch.lanes} scenes (x{batch.n_restarts} restarts) in {best * 1e3:.1f} ms "
              f"({batch.lanes / best:.1f} scenes/s)", file=sys.stderr)
    mean_me = float(np.mean([np.mean(v) for v in mes.values()]))
    return ThroughputResult(total_lanes / total_time, mean_me, total_lanes, prep.full,
                            compile_s, total_time, len(mes), tuple(info))


def throughput_batch(problem: str, root: str | None = None, n_timing_runs: int = 3,
                     seed: int = 0, lane_target: int | None = None,
                     allowed_buckets=None, device=None) -> ThroughputResult:
    """Scene-batched throughput of `problem` ("H" or "F") over a dataset
    (`discover_scenes`), on the card unless `device` says otherwise (or
    over `PROGX_BENCH_DEVICES` cards): the lane plan's batches, each first
    called once untimed (seed `seed`, `compile_seconds`), then
    `n_timing_runs` timed runs. Throughput = lanes / the sum of each
    batch's best time."""
    dev = torch.device("cuda" if device is None else device)
    mesh = _bench_mesh()
    prep = _prepare(problem, root, lane_target, allowed_buckets, mesh)
    compile_s = _warm_up([prep], seed, dev, mesh)
    return _time_batches(prep, n_timing_runs, seed, dev, mesh, compile_s)


def dataset_pass_seconds(problem: str, root: str | None = None, seed: int = 0,
                         n_timing_runs: int = 3, lane_target: int | None = None,
                         allowed_buckets=None, device=None):
    """Wall seconds of one pass over the dataset's distinct scenes through
    the throughput batches (every distinct scene rides in one of them).
    Returns (pass_seconds, n_distinct_scenes, compile_seconds)."""
    r = throughput_batch(problem, root=root, seed=seed, n_timing_runs=n_timing_runs,
                         lane_target=lane_target, allowed_buckets=allowed_buckets,
                         device=device)
    return r.pass_seconds, r.n_distinct, r.compile_seconds


def throughput_all(problems="HF", root=None, n_timing_runs: int = 3, seed: int = 0,
                   lane_target: int | None = None, allowed_buckets=None, device=None):
    """Several problems with one warm-up phase: the first, untimed call of
    every batch of every problem, then each problem's timed runs. `root`
    is one dataset directory, or a dict of one a problem. Returns
    ({problem: ThroughputResult}, warm-up wall seconds)."""
    dev = torch.device("cuda" if device is None else device)
    mesh = _bench_mesh()
    preps = [_prepare(p, root.get(p) if isinstance(root, dict) else root, lane_target,
                      allowed_buckets, mesh) for p in problems.upper()]
    compile_s = _warm_up(preps, seed, dev, mesh)
    return ({prep.problem: _time_batches(prep, n_timing_runs, seed, dev, mesh, compile_s)
             for prep in preps}, compile_s)
