"""Batched multi-scene front ends — counterpart of progressivex_tpu/api_batch.py.

  findHomographiesBatched(corrs_list, ...)    -> [([3K_i, 3], labeling_i), ...]
  findTwoViewMotionsBatched(corrs_list, ...)  -> [([3K_i, 3], labeling_i), ...]
  findEssentialMatricesBatched(corrs_list, K1_list, K2_list, ...)
                                              -> [([3K_i, 3], labeling_i), ...]
  findLinesBatched(points_list, ...)          -> [([K_i, 3], labeling_i), ...]
  findVanishingPointsBatched(lines_list, ...) -> [([K_i, 3], labeling_i), ...]
  find6DPosesBatched(x1y1_list, x2y2z2_list, K_list, ...)
                                              -> [([3K_i, 4], labeling_i), ...]

The layout is the JAX package's: scenes are grouped by pad level
(api.PAD_LEVELS); each group is one `engine.fit_rows` call on the card,
every scene a lane of its row axis; lane counts pad up to the next power
of two by cyclic replication; restarts are flattened into rows (restart r
of lane j is row r * lanes + j); `n_valid`, `threshold` (for 6D poses and
essential matrices a scene's own focal lengths scale it) and the graph
coordinates ride per row;
and the winning restart of each lane is chosen on the host
(`engine.select_restart`). Outputs match the single-scene front ends
element for element.

Seeds. Row (scene s, restart r) at pad level n_pad draws its samples from
a CPU torch.Generator seeded with

    np.random.SeedSequence([random_seed, n_pad, s, r]).generate_state(1)[0]

where s is the scene's index in `corrs_list`, never the row's position,
as the JAX package derives its row keys (api_batch.py:212-227). A scene
fitted alone, inside a bigger batch or replicated returns the same result;
filler lanes share their original's seed and are discarded. The numbers
differ from jax.random's, so a seed does not reproduce the JAX package's
run, and they differ from the single-scene front ends' (one generator for
all restarts).

Keywords and defaults are the JAX package's, plus `device` (the card
unless `device="cpu"`). `mesh` (a `parallel/sharding.Mesh` with a
"scenes" axis) or `n_devices` > 1 (`make_mesh(n_devices, 1)` over the
visible cards) shards each pad level's rows contiguously over the scenes
axis, as the JAX package's shard_map does (api_batch.py:47-100): lanes
round up to the axis size, each shard runs on its scenes device in a host
thread of its own, and `device` is not read. Seeds do not change, so a
scene gives the same bits sharded and unsharded. The scenes axis only:
the batched front ends set no hyp axis, as in the JAX package.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from progressivex_tpu_torch import api as _api
from progressivex_tpu_torch._device import resolve_device
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.core.config import EngineConfig, make_params
from progressivex_tpu_torch.models import get_family
from progressivex_tpu_torch.parallel import sharding


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def row_seed(random_seed: int, n_pad: int, scene: int, restart: int) -> int:
    """The seed of row (scene, restart) at pad level n_pad."""
    return int(np.random.SeedSequence(
        [int(random_seed), int(n_pad), int(scene), int(restart)]).generate_state(1)[0])


def _resolve_mesh(mesh, n_devices):
    """The scenes mesh of a batched call: `mesh` if it has a "scenes"
    axis, else one of `n_devices` cards when that is more than 1, else
    None."""
    if mesh is not None:
        if "scenes" not in getattr(mesh, "axis_names", ()):
            raise ValueError("mesh must have a 'scenes' axis")
        return mesh
    if n_devices is None or int(n_devices) <= 1:
        return None
    return sharding.make_mesh(int(n_devices), 1)


def engine_setup(family_name, *, threshold, conf, spatial_coherence_weight,
                 neighborhood_ball_radius, maximum_tanimoto_similarity, max_iters,
                 minimum_point_number, maximum_model_number, sampler_id,
                 scoring_exponent, n_restarts=1, restart_rule="energy",
                 magsac_levels=0, final_relabel=0, final_polish=0,
                 lo_spatial_lambda=0.5, max_rounds=10, pearl_iters=3, split_pass=0):
    """The EngineConfig and RuntimeParams of a batched call's keywords
    (threshold a scalar: a batched call replaces it per row), as the JAX
    package's `_run_batched` builds them; `n_restarts` is the engine's
    (the batched front ends run restarts as rows and pass 1)."""
    family = get_family(family_name)
    n_hyp = _api._hyp_budget(max_iters, family.max_solutions, family_name)
    cfg = EngineConfig(
        family=family_name,
        n_hypotheses=n_hyp,
        n_subbatches=_api._n_subbatches(max_iters, n_hyp),
        sampler_id=int(sampler_id),
        lo_spatial_lambda=lo_spatial_lambda,
        n_restarts=max(int(n_restarts), 1),
        final_polish=int(final_polish),
        final_relabel=int(final_relabel),
        magsac_levels=int(magsac_levels),
        restart_rule=str(restart_rule),
        max_rounds=int(max_rounds),
        pearl_iters=int(pearl_iters),
        split_pass=int(split_pass),
    )
    params = make_params(
        threshold=float(threshold),
        confidence=conf,
        spatial_weight=spatial_coherence_weight,
        neighborhood_radius=neighborhood_ball_radius,
        max_tanimoto=maximum_tanimoto_similarity,
        min_inliers=minimum_point_number,
        max_models=(maximum_model_number if maximum_model_number > 0
                    else _api._UNLIMITED),
        scoring_exponent=scoring_exponent,
        n_valid=0,
    )
    return cfg, params


def _run_batched(
    family_name,
    datas,  # list of [n_i, d] float32 arrays
    weights_list,  # list of [n_i] or None
    *,
    thresholds,  # scalar or per-scene list
    graph_datas=None,  # list of [n_i, d'] or None
    random_seed=0,
    n_restarts=1,
    do_logging=False,
    mesh=None,
    n_devices=None,
    device=None,
    pad_to=None,
    lanes=None,
    **setup,
):
    """The batched fit of `datas`, one `engine.fit_rows` call a pad level
    (sharded over the mesh's scenes axis when there is one); `setup` holds
    `engine_setup`'s keywords. `pad_to` puts every scene in one given pad
    level and `lanes` sets its lane count in place of the next power of
    two of the scene count: the dataset harness's own bucket and lane plan
    (eval/adelaide)."""
    mesh = _resolve_mesh(mesh, n_devices)
    dev = resolve_device(device) if mesh is None else mesh.devices[0, 0]
    n_scene_axis = 1 if mesh is None else mesh.shape["scenes"]
    n_scenes = len(datas)
    th_vec = np.broadcast_to(np.asarray(thresholds, np.float32), (n_scenes,)).copy()
    family = get_family(family_name)
    # restarts are flattened into the row axis below
    cfg, params = engine_setup(family_name, threshold=th_vec[0], **setup)
    n_restarts = max(int(n_restarts), 1)

    buckets: dict[int, list[int]] = {}
    for i, d in enumerate(datas):
        buckets.setdefault(pad_to or _api._pad_to(d.shape[0]), []).append(i)

    results: list = [None] * n_scenes
    for n_pad in sorted(buckets):
        idxs = buckets[n_pad]
        # Lanes cover the scenes and divide over the mesh's scenes axis
        # (both powers of two, so max() suffices), as in the JAX package.
        n_lanes = int(lanes) if lanes else max(_next_pow2(len(idxs)),
                                               _next_pow2(n_scene_axis))
        if n_lanes < len(idxs):
            raise ValueError(f"{len(idxs)} scenes for {n_lanes} lanes")
        lane_ids = [idxs[j % len(idxs)] for j in range(n_lanes)]
        d_dim = datas[idxs[0]].shape[1]
        data = np.zeros((n_lanes, n_pad, d_dim), np.float32)
        mask = np.zeros((n_lanes, n_pad), bool)
        wts = np.zeros((n_lanes, n_pad), np.float32)
        nv = np.zeros((n_lanes,), np.int64)
        th = np.zeros((n_lanes,), np.float32)
        gd = (None if graph_datas is None else
              np.zeros((n_lanes, n_pad, graph_datas[idxs[0]].shape[1]), np.float32))
        for j, i in enumerate(lane_ids):
            n = datas[i].shape[0]
            data[j, :n] = datas[i]
            mask[j, :n] = True
            wts[j, :n] = (1.0 if weights_list is None or weights_list[i] is None
                          else np.asarray(weights_list[i], np.float32).reshape(-1)[:n])
            nv[j] = n
            th[j] = th_vec[i]
            if gd is not None:
                gd[j, :n] = graph_datas[i]

        def tile(a):
            t = torch.from_numpy(np.concatenate([a] * n_restarts))
            return t if mesh is not None else t.to(dev)  # a shard goes to its device

        gens = [torch.Generator().manual_seed(row_seed(random_seed, n_pad, s, r))
                for r in range(n_restarts) for s in lane_ids]
        row_params = params._replace(n_valid=np.tile(nv, n_restarts),
                                     threshold=np.tile(th, n_restarts))
        row_args = (tile(data), tile(mask), tile(wts))
        row_graph = None if gd is None else tile(gd)
        if mesh is None:
            res = engine.fit_rows(family, cfg, row_params, *row_args, generators=gens,
                                  graph_data=row_graph)
        else:
            res = sharding.fit_rows_sharded(family, cfg, row_params, *row_args, gens,
                                            mesh, graph_data=row_graph)
        energy = res.energy.cpu().numpy().reshape(n_restarts, n_lanes)
        nmod = res.n_models.cpu().numpy().reshape(n_restarts, n_lanes)
        for j, i in enumerate(lane_ids[:len(idxs)]):
            r = engine.select_restart(energy[:, j],
                                      cfg.restart_rule if n_restarts > 1 else "energy",
                                      nmod[:, j])
            results[i] = engine.compact_result(
                engine.row_result(res, r * n_lanes + j), int(nv[j]))
        if do_logging:
            print(f"[progressivex_tpu_torch.batch] {family_name} n_pad={n_pad}: "
                  f"{len(idxs)} scenes ({n_lanes} lanes x {n_restarts} restarts"
                  f"{'' if mesh is None else f', {mesh}'})", file=sys.stderr)
    return results


def _as_scenes(corrs_list, min_points, name="corrs", dim=4):
    datas = []
    for corrs in corrs_list:
        corrs = np.asarray(corrs, np.float64)
        if corrs.ndim != 2 or corrs.shape[1] != dim or corrs.shape[0] < min_points:
            raise ValueError(f"every {name} should be an array with dims [n,{dim}], "
                             f"n>={min_points}")
        datas.append(np.ascontiguousarray(corrs, np.float32))
    return datas


def findHomographiesBatched(
    corrs_list,
    threshold=4.0,
    conf=0.5,
    spatial_coherence_weight=0.0,
    neighborhood_ball_radius=200.0,
    maximum_tanimoto_similarity=0.4,
    max_iters=1000,
    minimum_point_number=10,
    maximum_model_number=-1,
    sampler_id=3,
    scoring_exponent=2,
    do_logging=False,
    random_seed=0,
    n_restarts=1,
    magsac_levels=4,
    final_relabel=2,
    max_rounds=10,
    pearl_iters=3,
    split_pass=0,
    mesh=None,
    n_devices=None,
    device=None,
    **engine_kwargs,
):
    """Multi-homography fitting over a list of scenes in one batch on the
    card. Each element of corrs_list is an [n_i, 4] array; returns a list
    of ([3K_i, 3] stacked H rows, labeling_i) in input order, in
    `findHomographies`' format."""
    out = _run_batched(
        "homography", _as_scenes(corrs_list, 4), None,
        thresholds=threshold, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number, sampler_id=sampler_id,
        scoring_exponent=scoring_exponent, do_logging=do_logging,
        random_seed=random_seed, n_restarts=n_restarts,
        magsac_levels=magsac_levels, final_relabel=final_relabel,
        max_rounds=max_rounds, pearl_iters=pearl_iters, split_pass=split_pass,
        mesh=mesh, n_devices=n_devices, device=device, **engine_kwargs,
    )
    return [(d.reshape(-1, 3).astype(np.float64), l) for d, l in out]


def findTwoViewMotionsBatched(
    corrs_list,
    threshold=4.0,
    conf=0.5,
    spatial_coherence_weight=0.0,
    neighborhood_ball_radius=200.0,
    maximum_tanimoto_similarity=0.4,
    max_iters=1000,
    minimum_point_number=10,
    maximum_model_number=-1,
    sampler_id=3,
    scoring_exponent=3,
    do_logging=False,
    random_seed=0,
    n_restarts=4,
    magsac_levels=4,
    final_relabel=2,
    restart_rule="energy+5k",
    max_rounds=10,
    pearl_iters=3,
    split_pass=0,
    mesh=None,
    n_devices=None,
    device=None,
    **engine_kwargs,
):
    """Multi two-view-motion fitting over a list of scenes in one batch on
    the card. Returns a list of ([3K_i, 3] stacked F rows, labeling_i);
    the defaults (four restarts as rows, "energy+5k", MAGSAC ranking, final
    relabel) are `findTwoViewMotions`'."""
    out = _run_batched(
        "fundamental", _as_scenes(corrs_list, 7), None,
        thresholds=threshold, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number, sampler_id=sampler_id,
        scoring_exponent=scoring_exponent, do_logging=do_logging,
        random_seed=random_seed, n_restarts=n_restarts,
        magsac_levels=magsac_levels, final_relabel=final_relabel,
        restart_rule=restart_rule, max_rounds=max_rounds,
        pearl_iters=pearl_iters, split_pass=split_pass,
        mesh=mesh, n_devices=n_devices, device=device, **engine_kwargs,
    )
    return [(d.reshape(-1, 3).astype(np.float64), l) for d, l in out]


def findEssentialMatricesBatched(
    corrs_list,
    K1_list,
    K2_list,
    threshold=0.75,
    conf=0.5,
    spatial_coherence_weight=0.1,
    neighborhood_ball_radius=200.0,
    maximum_tanimoto_similarity=0.4,
    max_iters=1000,
    minimum_point_number=10,
    maximum_model_number=-1,
    sampler_id=0,
    scoring_exponent=2,
    do_logging=False,
    random_seed=0,
    n_restarts=1,
    mesh=None,
    n_devices=None,
    device=None,
    **engine_kwargs,
):
    """Multi essential-matrix fitting over a list of pixel correspondence
    sets [n_i, 4] in one batch on the card. K1_list and K2_list are one
    [3, 3] a scene or a single shared [3, 3]; each scene's K^-1
    normalization and threshold over its mean focal length ride per row,
    and its graph is built on its pixels, as in `findEssentialMatrices`.
    `engine_kwargs` takes the engine extensions (split_pass,
    magsac_levels, ...): as in the JAX package, their defaults here are
    the engine's, not the single-scene front end's. Returns a list of
    ([3K_i, 3] stacked E rows in normalized coordinates, labeling_i)."""
    n_scenes = len(corrs_list)
    K1s = list(K1_list) if isinstance(K1_list, (list, tuple)) else [K1_list] * n_scenes
    K2s = list(K2_list) if isinstance(K2_list, (list, tuple)) else [K2_list] * n_scenes
    if len(K1s) != n_scenes or len(K2s) != n_scenes:
        raise ValueError("corrs_list, K1_list, K2_list length mismatch")
    datas, graphs, ths = [], [], []
    for corrs, K1, K2 in zip(corrs_list, K1s, K2s):
        corrs, K1, K2 = _api.check_essential_inputs(corrs, K1, K2, "every ")
        data, thr = _api.essential_inputs(corrs, K1, K2, threshold)
        datas.append(np.ascontiguousarray(data, np.float32))
        graphs.append(np.ascontiguousarray(corrs, np.float32))
        ths.append(thr)
    out = _run_batched(
        "essential", datas, None,
        thresholds=ths, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number, sampler_id=sampler_id,
        scoring_exponent=scoring_exponent, graph_datas=graphs,
        do_logging=do_logging, random_seed=random_seed, n_restarts=n_restarts,
        mesh=mesh, n_devices=n_devices, device=device, **engine_kwargs,
    )
    return [(d.reshape(-1, 3).astype(np.float64), l) for d, l in out]


def findLinesBatched(
    points_list,
    weights_list=None,
    threshold=2.0,
    conf=0.5,
    spatial_coherence_weight=0.0,
    neighborhood_ball_radius=200.0,
    maximum_tanimoto_similarity=0.4,
    max_iters=1000,
    minimum_point_number=10,
    maximum_model_number=-1,
    sampler_id=3,
    scoring_exponent=2,
    do_logging=False,
    random_seed=0,
    n_restarts=1,
    mesh=None,
    n_devices=None,
    device=None,
    **engine_kwargs,
):
    """Multi 2D-line fitting over a list of point sets [n_i, 2] in one
    batch on the card, each with its per-point weights in `weights_list`
    (or None). Returns a list of ([K_i, 3] lines (a, b, c), labeling_i) in
    `findLines`' format; `engine_kwargs` takes the engine extensions
    (max_rounds, pearl_iters, split_pass, final_relabel, magsac_levels,
    restart_rule, ...)."""
    out = _run_batched(
        "line2d", _as_scenes(points_list, 2, "points", 2), weights_list,
        thresholds=threshold, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number,
        sampler_id=_api.line_sampler(sampler_id),
        scoring_exponent=scoring_exponent, do_logging=do_logging,
        random_seed=random_seed, n_restarts=n_restarts,
        mesh=mesh, n_devices=n_devices, device=device, **engine_kwargs,
    )
    return [(d.astype(np.float64), l) for d, l in out]


def findVanishingPointsBatched(
    lines_list,
    weights_list=None,
    threshold=4.0,
    conf=0.5,
    spatial_coherence_weight=0.0,
    neighborhood_ball_radius=200.0,
    maximum_tanimoto_similarity=0.4,
    max_iters=1000,
    minimum_point_number=10,
    maximum_model_number=-1,
    sampler_id=3,
    scoring_exponent=2,
    do_logging=False,
    random_seed=0,
    n_restarts=1,
    mesh=None,
    n_devices=None,
    device=None,
    **engine_kwargs,
):
    """Multi vanishing-point fitting over a list of segment sets [n_i, 4]
    in one batch on the card, each with its per-segment weights in
    `weights_list` (or None). Returns a list of ([K_i, 3] unit VPs,
    labeling_i) in `findVanishingPoints`' format; `engine_kwargs` as
    `findLinesBatched`'."""
    out = _run_batched(
        "vanishing_point", _as_scenes(lines_list, 2, "lines"), weights_list,
        thresholds=threshold, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number,
        sampler_id=_api.vp_sampler(sampler_id),
        scoring_exponent=scoring_exponent, do_logging=do_logging,
        random_seed=random_seed, n_restarts=n_restarts,
        mesh=mesh, n_devices=n_devices, device=device, **engine_kwargs,
    )
    return [(d.astype(np.float64), l) for d, l in out]


def find6DPosesBatched(
    x1y1_list,
    x2y2z2_list,
    K_list,
    threshold=4.0,
    conf=0.90,
    spatial_coherence_weight=0.1,
    neighborhood_ball_radius=20.0,
    maximum_tanimoto_similarity=0.9,
    max_iters=400,
    minimum_point_number=6,
    maximum_model_number=-1,
    do_logging=False,
    random_seed=0,
    n_restarts=1,
    mesh=None,
    n_devices=None,
    device=None,
    **engine_kwargs,
):
    """Multi 6D-pose fitting over a list of scenes in one batch on the
    card. K_list is one [3, 3] a scene or a single shared [3, 3]; each
    scene's K^-1 normalization and threshold over its mean focal length
    ride per row, and its graph is built on its unnormalized rows, as in
    `find6DPoses`. `engine_kwargs` takes the engine extensions, over this
    front end's own defaults lo_spatial_lambda=0.0 and final_polish=3; no
    duplicate fusion, as in the JAX package. Returns a list of ([3K_i, 4]
    stacked [R | t], labeling_i)."""
    n_scenes = len(x1y1_list)
    Ks = list(K_list) if isinstance(K_list, (list, tuple)) else [K_list] * n_scenes
    if len(Ks) != n_scenes or len(x2y2z2_list) != n_scenes:
        raise ValueError("x1y1_list, x2y2z2_list, K_list length mismatch")
    datas, graphs, ths = [], [], []
    for x1y1, x2y2z2, K in zip(x1y1_list, x2y2z2_list, Ks):
        data, graph, _, thr = _api.pose_inputs(
            *_api.check_pose_inputs(x1y1, x2y2z2, K, "every "), threshold)
        datas.append(np.ascontiguousarray(data, np.float32))
        graphs.append(np.ascontiguousarray(graph, np.float32))
        ths.append(thr)
    out = _run_batched(
        "pnp", datas, None,
        thresholds=ths, conf=conf,
        spatial_coherence_weight=spatial_coherence_weight,
        neighborhood_ball_radius=neighborhood_ball_radius,
        maximum_tanimoto_similarity=maximum_tanimoto_similarity,
        max_iters=max_iters, minimum_point_number=minimum_point_number,
        maximum_model_number=maximum_model_number, sampler_id=0,
        scoring_exponent=2, graph_datas=graphs, do_logging=do_logging,
        random_seed=random_seed, n_restarts=n_restarts,
        mesh=mesh, n_devices=n_devices, device=device,
        **{"lo_spatial_lambda": 0.0, "final_polish": 3, **engine_kwargs},
    )
    return [(d.reshape(-1, 4).astype(np.float64), l) for d, l in out]
