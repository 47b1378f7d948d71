"""How far one package's results on the line, VP, T-LESS and essential
gauntlet scenes spread with the random seed, on the CPU.

  python3 tools/seed_spread.py --package torch [--out FILE.json]
  python3 tools/seed_spread.py --package jax [--out FILE.json]
  python3 tools/seed_spread.py --package jax --only essential

Runs findLines on make_lines_scene(seed=s) and findVanishingPoints on
make_vp_scene(seed=s), s = 0..3, at random_seed 0..--seeds-1 (the JAX
package's bench keywords, eval/extras), and find6DPoses on the bundled
T-LESS scene at random_seed 0..--tless-seeds-1 (tests/test_pose6d.py's
keywords), and prints each scene's misclassification errors and T-LESS's
pose errors, with their ranges and means; and findEssentialMatrices on
the gauntlet's scenes (eval/extras.gauntlet_scene: two motions at scene
seeds 0-2, three motions at scene seed 1) at random_seed
0..--essential-seeds-1 and the gauntlet's keywords (3 restarts), with
each run's model count, ME and pass or miss of the gauntlet's gate (two
motions: K >= 2 and ME <= 0.12; three: K = 3 and ME <= 0.12); the gate
runs of tests/test_gauntlet.py are those with random_seed = scene seed.
`--only` runs one of the four groups. `--package torch` runs the port
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
    ap.add_argument("--essential-seeds", type=int, default=10)
    ap.add_argument("--essential-scene", action="append", default=None,
                    help="one gauntlet scene, e.g. two-0 or three-1 (repeatable; all by default)")
    ap.add_argument("--only", choices=("lines", "vps", "tless", "essential"), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from progressivex_tpu_torch.eval import extras
    from progressivex_tpu_torch.io.metrics import misclassification

    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import progressivex_tpu as pkg
        device = {}
    else:
        import progressivex_tpu_torch as pkg
        device = {"device": "cpu"}

    def wanted(group):
        return args.only in (None, group)

    report = {"package": args.package, "lines": {}, "vps": {}}
    for key, entry, make, kw in (
            ("lines", pkg.findLines, extras.make_lines_scene, extras.LINES_KW),
            ("vps", pkg.findVanishingPoints, lambda seed: extras.make_vp_scene(seed=seed)[:2],
             extras.VP_KW)):
        if not wanted(key):
            continue
        for scene in range(4):
            data, gt = make(seed=scene)
            mes = [float(misclassification(entry(data, **kw, random_seed=r, **device)[1], gt))
                   for r in range(args.seeds)]
            report[key][scene] = mes
            print(key, scene, json.dumps({"me": mes, "min": min(mes), "max": max(mes),
                                          "mean": float(np.mean(mes))}), flush=True)

    if wanted("tless"):
        report["tless"] = _tless(pkg, device, args.tless_seeds)
    if wanted("essential"):
        report["essential"] = _essential(pkg, device, args.essential_seeds,
                                         args.essential_scene)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


def _tless(pkg, device, n_seeds):
    from progressivex_tpu_torch.eval import extras
    from progressivex_tpu_torch.io.data import load_tless_scene
    from progressivex_tpu_torch.io.metrics import pose_errors

    xy, xyz, K, gt_poses = load_tless_scene()
    errs = []
    for r in range(n_seeds):
        poses, _ = pkg.find6DPoses(xy, xyz, K, **extras.TLESS_KW, random_seed=r, **device)
        k = poses.shape[0] // 3
        errs.append(pose_errors([poses[3 * i:3 * i + 3] for i in range(k)], gt_poses))
        print("tless", r, json.dumps({"instances": k, "pose_errors": errs[-1]}), flush=True)
    a = np.array(errs)  # [seed, pose, (rotation, translation)]
    out = {"pose_errors": errs, "mean": a.mean(0).tolist(),
           "median": np.median(a, 0).tolist(), "mean_seeds_0_2": a[:3].mean(0).tolist()}
    print("tless summary", json.dumps({k: v for k, v in out.items()
                                        if k != "pose_errors"}), flush=True)
    return out


# The gauntlet's scenes (kind, scene seed) and gates (tests/test_gauntlet.py).
ESSENTIAL_GATES = {("two", 0): (2, None), ("two", 1): (2, None), ("two", 2): (2, None),
                   ("three", 1): (3, 3)}
ESSENTIAL_ME_GATE = 0.12


def _essential(pkg, device, n_seeds, only=None):
    import time

    from progressivex_tpu_torch.eval import extras
    from progressivex_tpu_torch.io.metrics import misclassification

    K = extras.gauntlet_camera()
    out = {}
    for (kind, scene), (k_min, k_max) in ESSENTIAL_GATES.items():
        if only and f"{kind}-{scene}" not in only:
            continue
        corrs, gt = extras.gauntlet_scene(kind, scene)
        runs = []
        for r in range(n_seeds):
            t0 = time.perf_counter()
            E, lab = pkg.findEssentialMatrices(corrs, K, K, **extras.ESSENTIAL_KW,
                                               random_seed=r, **device)
            k = E.shape[0] // 3
            me = float(misclassification(lab, gt))
            ok = k >= k_min and (k_max is None or k <= k_max) and me <= ESSENTIAL_ME_GATE
            runs.append({"random_seed": r, "k": k, "me": me, "gate": ok,
                         "seconds": time.perf_counter() - t0})
            print("essential", kind, scene, json.dumps(runs[-1]), flush=True)
        mes = [x["me"] for x in runs]
        summary = {"min": min(mes), "max": max(mes), "mean": float(np.mean(mes)),
                   "median": float(np.median(mes)),
                   "misses": sum(not x["gate"] for x in runs), "n_runs": len(runs)}
        print("essential summary", kind, scene, json.dumps(summary), flush=True)
        out[f"{kind}-{scene}"] = {"runs": runs, **summary}
    return out


if __name__ == "__main__":
    main()
