"""findEssentialMatrices on a gauntlet scene through the JAX package, and
the port's engine fed the JAX package's own samples of that call, on the
CPU.

  python3 tools/essential_replay.py --scene two-1 --seed 1

Runs the JAX front end at the gauntlet's keywords (eval/extras.ESSENTIAL_KW,
three restarts) on eval/extras.gauntlet_scene, then draws the same samples
the JAX engine draws for random_seed --seed (its restarts' keys split as
progressivex_tpu/core/engine.py:590-591 and :853-861 split them) and hands
them to the port's `engine.fit` with the same configuration. Prints each
side's model count, misclassification error and final energy, and the
port's restart energies: where the two agree, a difference between the
packages' own runs at that seed is a difference of draws.
"""

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="two-1", help="gauntlet scene, two-s or three-s")
    ap.add_argument("--seed", type=int, default=None, help="random seed (the scene's by default)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from progressivex_tpu import api as japi
    from progressivex_tpu.core import engine as jengine
    from progressivex_tpu.core.config import EngineConfig as JConfig
    from progressivex_tpu.core.config import make_params as jmake_params
    from progressivex_tpu.ops import sampling as jsampling
    from progressivex_tpu_torch import api, convert
    from progressivex_tpu_torch.core import engine
    from progressivex_tpu_torch.eval import extras
    from progressivex_tpu_torch.io.metrics import misclassification
    from progressivex_tpu_torch.models import get_family

    kind, _, scene_seed = args.scene.partition("-")
    seed = int(scene_seed) if args.seed is None else args.seed
    corrs, gt = extras.gauntlet_scene(kind, int(scene_seed))
    K = extras.gauntlet_camera()
    kw = extras.ESSENTIAL_KW
    data, thr = api.essential_inputs(corrs, K, K, kw["threshold"])
    n, n_pad = len(data), api._pad_to(len(data))
    n_hyp = api._hyp_budget(kw["max_iters"], 10, "essential")

    def pad(a):
        return np.pad(np.asarray(a, np.float32), ((0, n_pad - n), (0, 0)))

    data_p, graph_p = pad(data), pad(corrs)
    mask = np.arange(n_pad) < n
    w = mask.astype(np.float32)
    # The configuration `findEssentialMatrices` builds (progressivex_tpu/api.py:233-261).
    jcfg = JConfig(family="essential", n_hypotheses=n_hyp, n_subbatches=1,
                   sampler_id=kw["sampler_id"], n_restarts=kw["n_restarts"],
                   magsac_levels=4, split_pass=2)
    jparams = jmake_params(
        threshold=thr, confidence=kw["conf"], spatial_weight=kw["spatial_coherence_weight"],
        neighborhood_radius=kw["neighborhood_ball_radius"],
        max_tanimoto=kw["maximum_tanimoto_similarity"],
        min_inliers=kw["minimum_point_number"], max_models=kw["maximum_model_number"],
        scoring_exponent=kw["scoring_exponent"], n_valid=n)
    key = jax.random.PRNGKey(seed)
    fit_fn = japi._compiled_fit("essential", jcfg, n_pad, True)
    res = fit_fn(jnp.asarray(data_p), jnp.asarray(mask), jnp.asarray(w), key, jparams,
                 jnp.asarray(graph_p))
    jd, jl = jengine.compact_result(jax.tree.map(np.asarray, res), n)
    print("jax", {"k": len(jd), "me": float(misclassification(jl, gt)),
                  "energy": float(res.energy)}, flush=True)

    dummy = jnp.zeros((1, 1), jnp.int32)
    runs = []
    for k in jax.random.split(key, jcfg.n_restarts):
        idx, ok = jax.vmap(lambda kk: jsampling.sample_minimal(
            kk, jcfg.sampler_id, n_hyp, 5, None, jnp.int32(n), dummy, dummy))(
            jax.random.split(k, jcfg.max_rounds))
        runs.append(convert.presampled(np.asarray(idx), np.asarray(ok),
                                       np.zeros((0, n_hyp, 5), np.int32),
                                       np.zeros((0, n_hyp), bool), device="cpu"))
    got = engine.fit(get_family("essential"), convert.engine_config(dataclasses.asdict(jcfg)),
                     convert.runtime_params(jparams._asdict()), torch.from_numpy(data_p),
                     torch.from_numpy(mask), torch.from_numpy(w), presampled=runs,
                     graph_data=torch.from_numpy(graph_p))
    d, lab = engine.compact_result(got, n)
    print("port on the JAX draw", {"k": len(d), "me": float(misclassification(lab, gt)),
                                   "energy": float(got.energy),
                                   "restart_energies": got.restart_energies}, flush=True)


if __name__ == "__main__":
    main()
