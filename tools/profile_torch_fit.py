"""Device-time profile of the port's fits on one GPU.

  python3 tools/profile_torch_fit.py [--out FILE.json]

For each bundled AdelaideRMF scene of both protocols (H:
findHomographies under H_PROTOCOL; F: findTwoViewMotions under
F_PROTOCOL), the synthetic lines scene (L: findLines, 3180 points), the
synthetic VP scene (V: findVanishingPoints, 216 segments), the bundled
T-LESS scene (P: find6DPoses) and the two-motion essential gauntlet scene
of seed 0 (E: findEssentialMatrices, 400 correspondences, 3 restarts),
seed 0, at the keywords of eval/adelaide.scene_kwargs and eval/extras, runs one fit without the
profiler (wall seconds) and one under torch.profiler (CPU + CUDA
activities), and reports the number of device operations (kernels,
copies, sets), their summed device time, the device's busy share of the
profiled wall time, the scoring kernels' launches, and the ten device
operations that took the most time (the full report goes to FILE.json
with --out). Each path is warmed up by one fit of its first scene. Needs
a CUDA device; it imports no JAX.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the full report here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_torch_fit.py: no CUDA device is available")
    import progressivex_tpu_torch as px
    from progressivex_tpu_torch.eval import extras
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs
    from progressivex_tpu_torch.io.data import (ADELAIDE_F_SCENES, ADELAIDE_H_SCENES,
                                                load_corr_scene, load_tless_scene)
    from progressivex_tpu_torch.io.profiling import device_operations
    from progressivex_tpu_torch.kernels.scoring import LAUNCHES

    def adelaide(problem, scene):
        corrs, _ = load_corr_scene(scene)
        return (corrs,), scene_kwargs(len(corrs), problem)

    # problem: (entry point, scenes, scene -> (arguments, keywords))
    paths = {
        "H": (px.findHomographies, ADELAIDE_H_SCENES, lambda s: adelaide("H", s)),
        "F": (px.findTwoViewMotions, ADELAIDE_F_SCENES, lambda s: adelaide("F", s)),
        "L": (px.findLines, ("lines-0",),
              lambda s: ((extras.make_lines_scene(seed=0)[0],), extras.LINES_KW)),
        "V": (px.findVanishingPoints, ("vp-0",),
              lambda s: ((extras.make_vp_scene(seed=0)[0],), extras.VP_KW)),
        "P": (px.find6DPoses, ("tless",),
              lambda s: (load_tless_scene()[:3], extras.TLESS_KW)),
        "E": (px.findEssentialMatrices, ("two-0",),
              lambda s: ((extras.gauntlet_scene("two", 0)[0], extras.gauntlet_camera(),
                          extras.gauntlet_camera()), extras.ESSENTIAL_KW)),
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    report = {"device": smi, "torch": torch.__version__, "scenes": {}}
    for problem, (fn, scenes, inputs) in paths.items():
        fn(*inputs(scenes[0])[0], **inputs(scenes[0])[1], random_seed=0)  # warm-up
        torch.cuda.synchronize()
        for scene in scenes:
            fargs, kw = inputs(scene)
            t0 = time.perf_counter()
            fn(*fargs, **kw, random_seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

            for k in LAUNCHES:
                LAUNCHES[k] = 0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn(*fargs, **kw, random_seed=0)
                torch.cuda.synchronize()
                wall_prof = time.perf_counter() - t0
            # The raw kineto events: building the profiler's event tree for
            # the 10^5-10^6 host and device events of one fit takes minutes.
            # The engine's phase annotations also show on the device
            # timeline; they are not device operations.
            dev_events = device_operations(prof.profiler.kineto_results.events())
            busy_us = sum(e.duration_ns() for e in dev_events) / 1e3
            by_name = collections.Counter()
            counts = collections.Counter()
            for e in dev_events:
                by_name[e.name()] += e.duration_ns() / 1e3
                counts[e.name()] += 1
            res = {
                "problem": problem,
                "points": len(fargs[0]),
                "wall_s": wall,
                "wall_profiled_s": wall_prof,
                "device_ops": len(dev_events),
                "device_busy_ms": busy_us / 1e3,
                "device_busy_share": busy_us / 1e6 / wall_prof,
                "launches": dict(LAUNCHES),
                "top_device_ops": [
                    {"name": name[:80], "ms": us / 1e3, "count": counts[name]}
                    for name, us in by_name.most_common(10)],
            }
            report["scenes"][scene] = res
            print(scene, json.dumps({k: v for k, v in res.items() if k != "top_device_ops"}),
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
