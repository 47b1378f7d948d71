"""The final moves (split, merge, final relabel) of both packages on the
same fit states: where a scene's final model count comes apart between
the port and the JAX package.

  python3 tools/moves_replay.py [--scene unihouse] [--hyp 4] [--seeds 30]
                                [--out moves_replay.json]

For each seed, the port fits the scene under its protocol's engine with
`hyp` replicas and the final moves off (`parallel/sharding.fit_batch` on
a virtual (1, hyp) mesh of the card, seed s as in tools/hyp_spread.py),
which leaves the state the rounds end in. That state, in the fit's
sorted point order, then goes through the port's `split_instances`,
`merge_instances` and final ICM relabel on the card, and through the JAX
package's on its default device, both on the adjacency of the JAX
package's kNN graph. Prints one JSON line a seed with the model counts
after each move in both packages. Needs a CUDA device and JAX.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="unihouse")
    ap.add_argument("--hyp", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from hyp_spread import FAMILY, PROBLEM, _scene
    from progressivex_tpu.core import pearl as jpearl
    from progressivex_tpu.core.config import EngineConfig as JConfig
    from progressivex_tpu.core.config import make_params as jmake_params
    from progressivex_tpu.ops import knn as jknn
    from progressivex_tpu.ops import labeling as jlab
    from progressivex_tpu.models import get_family as jfamily
    from progressivex_tpu_torch import api_batch
    from progressivex_tpu_torch.core import engine, pearl
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs
    from progressivex_tpu_torch.models import get_family
    from progressivex_tpu_torch.ops import labeling
    from progressivex_tpu_torch.ops import prng
    from progressivex_tpu_torch.parallel.sharding import fit_batch, make_mesh

    card = torch.device("cuda", 0)
    problem = PROBLEM[args.scene]
    data, mask, gt, n = _scene(args.scene)
    cfg, params = api_batch.engine_setup(FAMILY[problem], **scene_kwargs(n, problem))
    params = params._replace(n_valid=n)
    off = dataclasses.replace(cfg, split_pass=0, merge_pass=False, final_relabel=0)
    tdata = torch.as_tensor(data, device=card)[None]
    tmask = torch.as_tensor(mask, device=card)[None]
    weights = torch.ones(1, len(mask), device=card)
    perm, _ = engine.spatial_order(tdata, tmask)
    perm = perm[0]
    sd, sm = tdata[0][perm], tmask[0][perm]
    use_band = cfg.potts_band > 0 and len(mask) > 128 + 2 * cfg.potts_band

    jfam = jfamily(FAMILY[problem])
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jparams = jmake_params(**{f: getattr(params, f) for f in params._fields})
    jd, jm = jnp.array(sd.cpu().numpy()), jnp.array(sm.cpu().numpy())
    kidx, kmask = jknn.knn_graph(jd, jm, jparams.neighborhood_radius, jcfg.knn_k)
    jadj = (jlab.adjacency_banded(kidx, kmask, jcfg.potts_band) if use_band
            else jlab.adjacency_from_knn(kidx, kmask))
    tk, tkm = (torch.as_tensor(np.array(a), device=card) for a in (kidx, kmask))
    tadj = (labeling.adjacency_banded(tk, tkm, cfg.potts_band) if use_band
            else labeling.adjacency_from_knn(tk, tkm))
    tadj = labeling.adj_one_row(tadj)
    tw = torch.ones(1, len(mask), device=card)
    tp = params
    w = float(params.spatial_weight)
    tau = 2.25 * float(params.threshold) ** 2

    def jax_moves(descs, active, labels):
        counts = []
        args_ = (jfam, jcfg, jparams, jd, jm, jnp.ones(len(mask), jnp.float32))
        descs, active, labels = jpearl.split_instances(*args_, descs, active, labels, jadj,
                                                       n_rounds=jcfg.split_pass)
        counts.append(jnp.sum(active))
        descs, active, labels = jpearl.merge_instances(*args_, descs, active, labels, jadj)
        counts.append(jnp.sum(active))
        r2 = jax.vmap(jfam.squared_residual, in_axes=(None, 0))(jd, descs)
        dcost = jlab.data_costs(r2, active, jm, jparams.spatial_weight, tau)
        labels, _ = jlab.icm_sweeps(dcost, labels, jadj, jparams.spatial_weight,
                                    cfg.final_relabel)
        return counts, labels

    jax_moves = jax.jit(jax_moves)
    family = get_family(FAMILY[problem])
    mesh = make_mesh(1, args.hyp, devices=[card] * args.hyp)
    lines = []
    for s in range(args.seeds):
        res = fit_batch(family, off, params, tdata, tmask, weights,
                        prng.key(s, card)[None], mesh=mesh)
        descs, active = res.descs, res.active
        labels = res.labels[:, perm]  # the sorted order the moves work in
        moves = (family, cfg, tp, sd[None], sm[None], tw)
        d1, a1, l1 = pearl.split_instances(*moves, descs, active, labels, tadj,
                                           n_rounds=cfg.split_pass)
        d2, a2, l2 = pearl.merge_instances(*moves, d1, a1, l1, tadj)
        dcost = labeling.data_costs(family.squared_residual(sd[None], d2), a2, sm[None],
                                    w, torch.full((1,), tau, device=card))
        l3, _ = labeling.icm_sweeps(dcost, l2, tadj, w, cfg.final_relabel)
        port = [int(a1.sum()), int(a2.sum())]
        jc, jl = jax_moves(jnp.array(descs[0].cpu().numpy()), jnp.array(active[0].cpu().numpy()),
                           jnp.array(labels[0].cpu().numpy().astype(np.int32)))
        line = {"seed": s, "rounds_models": int(active.sum()), "port_split_merge": port,
                "jax_split_merge": [int(c) for c in jc],
                "final_labels_apart": float(np.mean(l3[0].cpu().numpy() != np.asarray(jl)))}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
