"""How a scene's misclassification error spreads with the seed at each
size of the hyp axis (hypothesis parallelism), for the port on the card
and for the JAX package.

  python3 tools/hyp_spread.py --package torch [--scene unihouse] [--hyp 1,2,4]
                              [--seeds 10] [--first-seed 0]
                              [--out hyp_spread_torch.json]
  python3 tools/hyp_spread.py --package jax [--scene unihouse] [--hyp 1,4]
                              [--seeds 4 | --seed-list 0,8] [--replay]
                              [--replay-device cuda,cpu] [--out hyp_spread_jax.json]

Every fit is one bundled scene under its AdelaideRMF protocol's engine
(H: unihouse, oldclassicswing, unionhouse; F: book, breadcube, cubetoy,
with F's restarts inside the fit), with H replicas of every proposal.
`--package torch` runs `parallel/sharding.fit_batch` over a virtual
(1, H) mesh of the card (seed s: PRNGKey(s), replica h of a restart
drawing from fold_in(key, h), as in the JAX package), one fit a
seed; `--package jax` runs the JAX package's named-vmap emulation of a
(1, H) mesh (tests/test_sharding.py:48-65: each replica folds its axis
index into the key) on its default device, the seeds as one vmapped
batch (key PRNGKey(s)). The port draws the JAX package's samples for a
seed (ops/prng.py), so a seed's two fits start from the same samples
where the two kNN graphs agree; float32 rounding can still part them, so
compare the distributions, not one seed. Prints one JSON line a (scene, H) with each
seed's ME and model count, their mean and range, and the samples drawn a
round. `--replay` (with `--package jax`, on a card) also fits the port's
engine on the samples each JAX run drew (its sort, graph and replicas'
fold_in draws reproduced), so that the two packages are compared on the
same samples; `--replay-device cuda,cpu` refits on each device named
(`cpu`: the scoring kernel's plain version; the first device's fit under
"port_on_jax_samples", another's under "port_on_jax_samples_<device>").
`--jax-graph` (with `--package torch`) builds the port's kNN graph with
the JAX package's `knn_graph`.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBLEM = {"unihouse": "H", "oldclassicswing": "H", "unionhouse": "H",
           "book": "F", "breadcube": "F", "cubetoy": "F"}
FAMILY = {"H": "homography", "F": "fundamental"}


def _scene(name):
    from progressivex_tpu_torch.api import _pad_to
    from progressivex_tpu_torch.io.data import load_corr_scene

    corrs, gt = load_corr_scene(name)
    n, n_pad = len(corrs), _pad_to(len(corrs))
    data = np.zeros((n_pad, 4), np.float32)
    data[:n] = corrs
    return data, np.arange(n_pad) < n, gt, n


def _jax_knn_graph(points, valid_mask, radius, k):
    """engine.knn_graph's contract computed by the JAX package's knn_graph,
    row by row: points [R, N, d], valid_mask [R, N] torch tensors."""
    import jax.numpy as jnp
    import torch

    from progressivex_tpu.ops.knn import knn_graph

    rows = [knn_graph(jnp.array(p.cpu().numpy()), jnp.array(m.cpu().numpy()),
                      float(radius), k) for p, m in zip(points, valid_mask)]
    return tuple(torch.as_tensor(np.stack([np.array(r[i]) for r in rows]),
                                 device=points.device) for i in (0, 1))


def _torch_fits(name, hyp, seeds):
    import torch

    from progressivex_tpu_torch import api_batch
    from progressivex_tpu_torch.core import engine
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs
    from progressivex_tpu_torch.io.metrics import misclassification
    from progressivex_tpu_torch.ops import prng
    from progressivex_tpu_torch.parallel.sharding import fit_batch, make_mesh

    problem = PROBLEM[name]
    data, mask, gt, n = _scene(name)
    cfg, params = api_batch.engine_setup(FAMILY[problem], **scene_kwargs(n, problem))
    card = torch.device("cuda", 0)
    mesh = make_mesh(1, hyp, devices=[card] * hyp)
    out = []
    for s in seeds:
        res = fit_batch(FAMILY[problem], cfg, params._replace(n_valid=n),
                        torch.as_tensor(data, device=card)[None],
                        torch.as_tensor(mask, device=card)[None],
                        torch.ones(1, len(mask), device=card),
                        prng.key(s, card)[None], mesh=mesh)
        one = engine.row_result(res, 0)
        models, labels = engine.compact_result(one, n)
        out.append({"seed": s, "me": float(misclassification(labels, gt)),
                    "n_models": len(models),
                    "samples_a_round": one.samples_drawn / max(one.rounds_run, 1)})
    return out


def _jax_setup(name, hyp, no_moves=False):
    """The JAX package's engine config (with hyp_axis), params, family and
    the scene of `name` under its protocol; with `no_moves`, without the
    split, merge and final relabel passes."""
    from progressivex_tpu import api as japi
    from progressivex_tpu.core.config import EngineConfig, make_params
    from progressivex_tpu.models import get_family
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs

    problem = PROBLEM[name]
    data, mask, gt, n = _scene(name)
    kw = scene_kwargs(n, problem)
    family = get_family(FAMILY[problem])
    n_hyp = japi._hyp_budget(kw["max_iters"], family.max_solutions, family.name)
    cfg = EngineConfig(
        family=family.name, n_hypotheses=n_hyp,
        n_subbatches=japi._n_subbatches(kw["max_iters"], n_hyp),
        sampler_id=int(kw["sampler_id"]), n_restarts=int(kw.get("n_restarts", 1)),
        magsac_levels=int(kw.get("magsac_levels", 0)),
        restart_rule=str(kw.get("restart_rule", "energy")),
        max_rounds=int(kw.get("max_rounds", 10)), pearl_iters=int(kw.get("pearl_iters", 3)),
        split_pass=0 if no_moves else int(kw.get("split_pass", 0)),
        merge_pass=not no_moves, final_relabel=0 if no_moves else int(kw.get(
            "final_relabel", 0)), hyp_axis="hyp")
    mm = kw["maximum_model_number"]
    params = make_params(
        threshold=kw["threshold"], confidence=kw["conf"],
        spatial_weight=kw["spatial_coherence_weight"],
        neighborhood_radius=kw["neighborhood_ball_radius"],
        max_tanimoto=kw["maximum_tanimoto_similarity"],
        min_inliers=kw["minimum_point_number"],
        max_models=mm if mm > 0 else japi._UNLIMITED,
        scoring_exponent=kw["scoring_exponent"], n_valid=n)
    return family, cfg, params, data, mask, gt, n


def _jax_labels(res, i, n):
    active = np.asarray(res.active[i])
    remap = np.full(active.shape[0] + 1, active.sum(), np.int64)
    remap[:active.shape[0]][active] = np.arange(active.sum())
    return remap[np.asarray(res.labels[i])][:n], int(active.sum())


def _jax_fits(name, hyp, seeds, replay=False, no_moves=False, replay_devices=("cuda",)):
    import jax
    import jax.numpy as jnp

    from progressivex_tpu.core import engine as jengine
    from progressivex_tpu_torch.io.metrics import misclassification

    family, cfg, params, data, mask, gt, n = _jax_setup(name, hyp, no_moves)

    def one_scene(k):
        reps = jax.vmap(lambda _: jengine.fit(family, cfg, params, jnp.array(data),
                                              jnp.array(mask),
                                              jnp.ones(len(mask), jnp.float32), k),
                        axis_name="hyp")(jnp.arange(hyp))
        return jax.tree.map(lambda x: x[0], reps)

    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    res = jax.jit(jax.vmap(one_scene))(keys)
    out = []
    for i, s in enumerate(seeds):
        labels, k = _jax_labels(res, i, n)
        rounds = int(res.rounds_run[i])
        run = {"seed": s, "me": float(misclassification(labels, gt)), "n_models": k,
               "rounds": rounds,
               "round_log": {f: np.asarray(getattr(res.round_log, f)[i])[:rounds].tolist()
                             for f in res.round_log._fields}}
        if replay:
            for j, dev in enumerate(replay_devices):
                run["port_on_jax_samples" + ("" if j == 0 else f"_{dev}")] = _replay(
                    family, cfg, params, data, mask, gt, n, keys[i], hyp, labels, k, dev)
        out.append(run)
    return out


def _jax_sorted(data, mask, use_band):
    """(data, mask, perm) as the JAX fit holds them: with `use_band`, sorted
    along the principal axis as progressivex_tpu/core/engine.py:516-545
    sorts them (perm: sorted position -> caller's point)."""
    import jax.numpy as jnp

    d, m = jnp.array(data), jnp.array(mask)
    if not use_band:
        return d, m, jnp.arange(len(mask))
    mf = m.astype(d.dtype)
    mu = jnp.sum(d * mf[:, None], axis=0) / jnp.maximum(jnp.sum(mf), 1.0)
    xc = (d - mu) * mf[:, None]
    cov = xc.T @ xc
    v = jnp.ones((d.shape[1],), d.dtype)
    for _ in range(8):
        v = cov @ v
        v = v / jnp.maximum(jnp.linalg.norm(v), 1e-20)
    perm = jnp.argsort(jnp.where(m, (d - mu) @ v, jnp.inf))
    return d[perm], m[perm], perm


def _replay(jfamily, jcfg, jparams, data, mask, gt, n, key, hyp, jax_labels, jax_k,
            device="cuda"):
    """The port's fit_rows on `device` fed the samples the JAX replicas drew
    for `key` (progressivex_tpu/core/engine.py:516-551 sorts and builds the
    graph, :850-880 draws, with fold_in(key, h) a replica)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch

    from progressivex_tpu.ops.knn import knn_graph
    from progressivex_tpu.ops.sampling import sample_minimal
    from progressivex_tpu_torch import convert
    from progressivex_tpu_torch.core import engine
    from progressivex_tpu_torch.io.metrics import misclassification
    from progressivex_tpu_torch.models import get_family

    use_band = jcfg.potts_band > 0 and len(mask) > 128 + 2 * jcfg.potts_band
    d, m, perm = _jax_sorted(data, mask, use_band)
    samp_idx, samp_mask = knn_graph(d, m, jparams.neighborhood_radius,
                                    max(jcfg.knn_k, jcfg.sampler_k))
    idx, ok = [], []
    for h in range(hyp):
        keys = jax.random.split(jax.random.fold_in(key, h), jcfg.max_rounds)
        i_h, o_h = jax.vmap(lambda k: sample_minimal(
            k, jcfg.sampler_id, jcfg.n_hypotheses, jfamily.sample_size, m,
            jparams.n_valid, samp_idx, samp_mask))(keys)
        idx.append(np.asarray(i_h))
        ok.append(np.asarray(o_h))
    b, ms = jcfg.n_hypotheses, jfamily.sample_size
    pre = (torch.as_tensor(np.stack(idx)[None]).long(), torch.as_tensor(np.stack(ok)[None]),
           torch.zeros(1, hyp, 0, b, ms, dtype=torch.long),
           torch.zeros(1, hyp, 0, b, dtype=torch.bool))
    cfg = convert.engine_config(dataclasses.asdict(jcfg))
    params = convert.runtime_params(jparams._asdict())
    dev = torch.device(device)
    tdata = torch.as_tensor(data, device=dev)[None]
    tmask = torch.as_tensor(mask, device=dev)[None]
    perm_port, _ = engine.spatial_order(tdata, tmask)
    res = engine.fit_rows(get_family(jfamily.name), cfg, params, tdata, tmask,
                          torch.ones(1, len(mask), device=dev), presampled=pre)
    one = engine.row_result(res, 0)
    _, labels = engine.compact_result(one, n)
    return {"me": float(misclassification(labels, gt)), "n_models": int(one.n_models),
            "rounds": one.rounds_run, "round_log": one.round_log._asdict(),
            "same_sort": bool(not use_band or np.array_equal(
                perm_port[0].cpu().numpy(), np.asarray(perm))),
            "label_disagreement_vs_jax": float(np.mean(labels != jax_labels))
            if int(one.n_models) == jax_k else None}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--scene", action="append", default=None,
                    help="a bundled scene (repeatable; default unihouse)")
    ap.add_argument("--hyp", default="1,2,4", help="hyp axis sizes, comma separated")
    ap.add_argument("--seeds", type=int, default=10, help="how many seeds")
    ap.add_argument("--first-seed", type=int, default=0,
                    help="the first seed (seeds first-seed .. first-seed + seeds - 1)")
    ap.add_argument("--seed-list", default=None,
                    help="comma separated seeds, in place of --first-seed and --seeds")
    ap.add_argument("--replay", action="store_true",
                    help="with --package jax: also fit the port on the card on each "
                         "JAX run's own samples")
    ap.add_argument("--replay-device", default="cuda",
                    help="with --replay: the devices of the port's fits, comma separated "
                         "(cuda, cpu)")
    ap.add_argument("--jax-graph", action="store_true",
                    help="with --package torch: build the fits' kNN graph (the sampler's "
                         "neighbourhoods and the Potts adjacency) with the JAX package's "
                         "knn_graph")
    ap.add_argument("--no-moves", action="store_true",
                    help="with --package jax: fit without the split, merge and final "
                         "relabel passes (the state the rounds leave)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.package == "jax":
        import jax

        print("jax devices", jax.devices(), flush=True)
        def fits(name, hyp, seeds):
            return _jax_fits(name, hyp, seeds, args.replay, args.no_moves,
                             args.replay_device.split(","))
    else:
        import torch

        if not torch.cuda.is_available():
            sys.exit("hyp_spread.py --package torch runs on a CUDA device")
        if args.jax_graph:
            from progressivex_tpu_torch.core import engine

            engine.knn_graph = _jax_knn_graph
        fits = _torch_fits
    seeds = ([int(x) for x in args.seed_list.split(",")] if args.seed_list
             else list(range(args.first_seed, args.first_seed + args.seeds)))
    lines = []
    for name in args.scene or ["unihouse"]:
        for hyp in (int(h) for h in args.hyp.split(",")):
            t0 = time.perf_counter()
            runs = fits(name, hyp, seeds)
            mes = [r["me"] for r in runs]
            line = {"package": args.package, "scene": name, "hyp": hyp,
                    "mean_me": float(np.mean(mes)), "min_me": min(mes), "max_me": max(mes),
                    "n_models": [r["n_models"] for r in runs], "runs": runs,
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
