"""How the two packages' minimal-sample draws compare on one scene, on
the CPU: many batches of each package's `sample_minimal` on the same
sorted points and kNN graph (the JAX package's `knn_graph`), under the
scene's protocol (sampler, B, sample size), and the shares that decide
a fit's proposals.

  python3 tools/sampler_stats.py [--scene unihouse] [--batches 800]

Prints one JSON line a package: the share of valid samples, of samples
whose companions all come from the center's neighbourhood (local), of
samples inside one ground-truth structure (single_structure, and among
the local ones), of samples with a repeated point, and of centers on an
outlier. The two draw from different generators, so compare shares, not
samples. Needs JAX.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _shares(idx, ok, graph_idx, graph_mask, gt_sorted):
    m = idx.shape[1]
    rows, rmask = graph_idx[idx[:, 0]], graph_mask[idx[:, 0]]
    local = np.stack([((rows == idx[:, j:j + 1]) & rmask).any(1)
                      for j in range(1, m)], 1).all(1)
    lab = gt_sorted[idx]
    single = (lab == lab[:, :1]).all(1) & (lab[:, 0] >= 0)
    repeated = np.array([len(set(r)) < m for r in idx])
    return {"samples": int(len(idx)), "valid": float(ok.mean()), "local": float(local.mean()),
            "single_structure": float(single.mean()),
            "single_structure_local": float(single[local].mean()),
            "repeated_point": float(repeated.mean()),
            "outlier_center": float((gt_sorted[idx[:, 0]] == 0).mean())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="unihouse")
    ap.add_argument("--batches", type=int, default=800)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from hyp_spread import _jax_setup, _scene
    from progressivex_tpu.ops.knn import knn_graph
    from progressivex_tpu.ops.sampling import sample_minimal as jax_sample
    from progressivex_tpu_torch.core import engine
    from progressivex_tpu_torch.ops.sampling import sample_minimal as torch_sample

    data, mask, gt, n = _scene(args.scene)
    family, cfg, params, *_ = _jax_setup(args.scene, 1)
    perm = engine.spatial_order(torch.as_tensor(data)[None],
                                torch.as_tensor(mask)[None])[0][0].numpy()
    ds, ms = data[perm], mask[perm]
    gt_sorted = np.full(len(mask), -2)
    gt_sorted[:n] = gt
    gt_sorted = gt_sorted[perm]
    gi, gm = knn_graph(jnp.array(ds), jnp.array(ms), params.neighborhood_radius,
                       max(cfg.knn_k, cfg.sampler_k))
    graph_idx, graph_mask = np.array(gi), np.array(gm)
    b, m = cfg.n_hypotheses, family.sample_size

    draw = jax.jit(jax.vmap(lambda k: jax_sample(k, cfg.sampler_id, b, m, jnp.array(ms), n,
                                                 gi, gm)))
    ji, jo = draw(jax.random.split(jax.random.PRNGKey(args.seed), args.batches))
    gen = torch.Generator().manual_seed(args.seed)
    ti_t, tm_t = torch.as_tensor(graph_idx), torch.as_tensor(graph_mask)
    draws = [torch_sample(gen, cfg.sampler_id, b, m, n, ti_t, tm_t)
             for _ in range(args.batches)]
    for package, idx, ok in (
            ("jax", np.array(ji).reshape(-1, m), np.array(jo).reshape(-1)),
            ("torch", torch.cat([d[0] for d in draws]).numpy(),
             torch.cat([d[1] for d in draws]).numpy())):
        print(json.dumps({"package": package, "scene": args.scene,
                          "sampler_id": cfg.sampler_id,
                          **_shares(idx, ok, graph_idx, graph_mask, gt_sorted)}),
              flush=True)


if __name__ == "__main__":
    main()
