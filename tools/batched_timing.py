"""Wall seconds of the port's batched calls that run the merge and split
moves over many rows, on one GPU, for the checkout at --root.

  python3 tools/batched_timing.py --root DIR [--label NAME] [--out FILE.json]

Imports `progressivex_tpu_torch` from DIR (so that two checkouts, a parent
and a change, can be timed in turns in one call on one card), builds its
kernels, warms up with one batched essential call, then times:

- findEssentialMatricesBatched on the two-motion gauntlet scenes of seeds
  0-3 (three restarts, two split rounds, MAGSAC ranking; 12 rows at 512
  points), the call of chip_smoke.py's phase 5;
- `cli.bench_main --timing-runs 1 --lane-target 4`: the throughput line on
  the bundled AdelaideRMF scenes.

Each time ends in a device synchronization. Prints one JSON line (and
writes it to FILE.json with --out) with the card's name and power limit.
Needs a CUDA device; it imports no JAX.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="checkout to import the port from")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("batched_timing.py: no CUDA device is available")
    import progressivex_tpu_torch as px
    from progressivex_tpu_torch.cli import bench_main
    from progressivex_tpu_torch.eval import extras
    from progressivex_tpu_torch.kernels import _build

    if not px.__file__.startswith(root):
        sys.exit(f"batched_timing.py: imported {px.__file__}, not from {root}")
    _build.build_all()
    K = extras.gauntlet_camera()
    scenes = [extras.gauntlet_scene("two", s)[0] for s in range(4)]

    def batched_e():
        out = px.findEssentialMatricesBatched(scenes, K, K, **extras.ESSENTIAL_KW,
                                              split_pass=2, magsac_levels=4,
                                              random_seed=0)
        torch.cuda.synchronize()
        return [m.shape[0] // 3 for m, _ in out]

    batched_e()  # warm-up
    t0 = time.perf_counter()
    n_models = batched_e()
    e_s = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        bench = bench_main(["--timing-runs", "1", "--lane-target", "4"])
        bench_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"label": args.label or root, "card": smi, "batched_e_s": e_s,
           "batched_e_n_models": n_models, "bench_s": bench_s, "bench": bench}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main()
