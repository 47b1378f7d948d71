"""The calls behind `chip_smoke.py`'s single-draw gates that the shared
seed moves, run by one package, so that the port and the JAX package can
be held side by side on one card at the same seeds (and so on the same
samples: the port draws the JAX package's).

  python3 tools/shared_seed_gates.py --package torch [--device cuda|cpu]
  python3 tools/shared_seed_gates.py --package jax [--platform cpu]

Runs phase 3 P's find6DPoses on T-LESS at random_seed 0, 1 and 2
(eval/extras.TLESS_KW), phase 5 H's findHomographiesBatched calls on the
three bundled AdelaideRMF-H scenes (one call a protocol variant, as
chip_smoke.py's `_batched` groups them) and phase 5 L's findLinesBatched
on make_lines_scene(seed=0..3), all at random_seed 0 and the keywords
chip_smoke.py uses. Prints one JSON line a call: each seed's model count
and pose errors with their means, or each scene's model count and
misclassification error. `--package torch` imports no JAX; `--package
jax` runs the JAX package on its default device (the card on a machine
with one and a CUDA JAX) unless `--platform` names another.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H_SCENES = ("oldclassicswing", "unionhouse", "unihouse")
TLESS_SEEDS = (0, 1, 2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--device", default="cuda", help="the port's device")
    ap.add_argument("--platform", default=None, help="the JAX package's platform")
    args = ap.parse_args()

    from progressivex_tpu_torch.eval import extras
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs
    from progressivex_tpu_torch.io.data import load_corr_scene, load_tless_scene
    from progressivex_tpu_torch.io.metrics import misclassification, pose_errors

    if args.package == "jax":
        import jax

        if args.platform:
            jax.config.update("jax_platforms", args.platform)
        import progressivex_tpu as pkg
        kw_dev, where = {}, str(jax.devices()[0])
    else:
        import torch

        import progressivex_tpu_torch as pkg
        kw_dev = {"device": args.device}
        where = (torch.cuda.get_device_name(0) if args.device.startswith("cuda")
                 else args.device)

    def emit(**line):
        print(json.dumps({"package": args.package, "device": where, **line}), flush=True)

    xy, xyz, K, poses = load_tless_scene()
    per_seed = []
    for seed in TLESS_SEEDS:
        models, _ = pkg.find6DPoses(xy, xyz, K, **extras.TLESS_KW, random_seed=seed,
                                    **kw_dev)
        k = models.shape[0] // 3
        errs = pose_errors([models[3 * i:3 * i + 3] for i in range(k)], poses)
        per_seed.append({"seed": seed, "n_models": k, "pose_errors": errs})
    mean = np.array([s["pose_errors"] for s in per_seed]).mean(0).tolist()
    emit(call="find6DPoses tless", seeds=per_seed, mean_pose_errors=mean)

    corrs = {n: load_corr_scene(n) for n in H_SCENES}
    groups: dict = {}
    for n in H_SCENES:
        kw = scene_kwargs(len(corrs[n][0]), "H")
        groups.setdefault(json.dumps(kw, sort_keys=True), (kw, []))[1].append(n)
    for kw, names in groups.values():
        out = pkg.findHomographiesBatched([corrs[n][0] for n in names], **kw,
                                          random_seed=0, **kw_dev)
        emit(call="findHomographiesBatched", scenes={
            n: {"n_models": m.shape[0] // 3, "me": float(misclassification(lab, corrs[n][1]))}
            for n, (m, lab) in zip(names, out)})

    scenes = [extras.make_lines_scene(seed=s) for s in range(4)]
    out = pkg.findLinesBatched([s[0] for s in scenes], **extras.LINES_KW, random_seed=0,
                               **kw_dev)
    emit(call="findLinesBatched", scenes={
        f"lines-{s}": {"n_models": m.shape[0], "me": float(misclassification(lab, gt))}
        for s, ((m, lab), (_, gt)) in enumerate(zip(out, scenes))})


if __name__ == "__main__":
    main()
