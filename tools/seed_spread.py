"""How far one package's results on the line, VP and T-LESS scenes spread
with the random seed, on the CPU.

  python3 tools/seed_spread.py --package torch [--out FILE.json]
  python3 tools/seed_spread.py --package jax [--out FILE.json]

Runs findLines on make_lines_scene(seed=s) and findVanishingPoints on
make_vp_scene(seed=s), s = 0..3, at random_seed 0..--seeds-1 (the JAX
package's bench keywords, eval/extras), and find6DPoses on the bundled
T-LESS scene at random_seed 0..--tless-seeds-1 (tests/test_pose6d.py's
keywords), and prints each scene's misclassification errors and T-LESS's
pose errors, with their ranges and means. `--package torch` runs the port
(progressivex_tpu_torch, on the CPU) and imports no JAX; `--package jax`
runs the JAX package on the CPU. A single run of either is one draw of
these spreads, which is what a gate on one seed has to allow for.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--seeds", type=int, default=10, help="random seeds a line or VP scene")
    ap.add_argument("--tless-seeds", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from progressivex_tpu_torch.eval import extras
    from progressivex_tpu_torch.io.data import load_tless_scene
    from progressivex_tpu_torch.io.metrics import misclassification, pose_errors

    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import progressivex_tpu as pkg
        device = {}
    else:
        import progressivex_tpu_torch as pkg
        device = {"device": "cpu"}

    report = {"package": args.package, "lines": {}, "vps": {}}
    for key, entry, make, kw in (
            ("lines", pkg.findLines, extras.make_lines_scene, extras.LINES_KW),
            ("vps", pkg.findVanishingPoints, lambda seed: extras.make_vp_scene(seed=seed)[:2],
             extras.VP_KW)):
        for scene in range(4):
            data, gt = make(seed=scene)
            mes = [float(misclassification(entry(data, **kw, random_seed=r, **device)[1], gt))
                   for r in range(args.seeds)]
            report[key][scene] = mes
            print(key, scene, json.dumps({"me": mes, "min": min(mes), "max": max(mes),
                                          "mean": float(np.mean(mes))}), flush=True)

    xy, xyz, K, gt_poses = load_tless_scene()
    errs = []
    for r in range(args.tless_seeds):
        poses, _ = pkg.find6DPoses(xy, xyz, K, **extras.TLESS_KW, random_seed=r, **device)
        k = poses.shape[0] // 3
        errs.append(pose_errors([poses[3 * i:3 * i + 3] for i in range(k)], gt_poses))
        print("tless", r, json.dumps({"instances": k, "pose_errors": errs[-1]}), flush=True)
    a = np.array(errs)  # [seed, pose, (rotation, translation)]
    report["tless"] = {"pose_errors": errs, "mean": a.mean(0).tolist(),
                       "median": np.median(a, 0).tolist(),
                       "mean_seeds_0_2": a[:3].mean(0).tolist()}
    print("tless summary", json.dumps({k: v for k, v in report["tless"].items()
                                        if k != "pose_errors"}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
