"""Readings for the limits of `correct`: the program's numbers over many
seeds, and the control's on the same answers, in one process.

  python3 bench_port/control.py --workload <cell> --seeds 1,2,3 --seconds S [--out FILE]

For each seed: a window of S seconds at the cell's own load (a fresh
request pool of that seed), the check's sample of the answers, the
numbers of reference.numbers for the program's answers and for the
control's (reference.control: the reference computed in bfloat16, put in
the program's place on the same answers). One JSON line a seed on
standard output; in FILE the same with the sample's answers (request,
position in it, sum of its data, models, labels), from which the
numbers can be read again off the card. Set-up (kernels, warm-up) is paid once.
The benchmark's own runs never run this; it needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from bench_port import harness, reference

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cuda:0")
    import progressivex_tpu_torch as program
    from progressivex_tpu_torch.kernels import _build

    _build.build_all()
    harness.warm_up(cell, program, seeds[0], device, int(cell.traffic["warm_passes"]))
    out = open(args.out, "w") if args.out else None
    for seed in seeds:
        t0 = time.perf_counter()
        pool = harness.Pool(cell, seed, int(cell.traffic["pool_requests"]))
        window = harness.run_window(cell, program, pool, args.seconds, device, False)
        sample = harness.check_sample(cell, window, seed)
        judged = harness.judge_answers(cell, sample)
        low = harness.judge_answers(cell, sample, judge=reference.control)
        empty = sum(1 for a in window.answers if np.asarray(a.models).size == 0)
        row = {"cell": cell.name, "seed": seed, "answers": len(window.answers),
               "judged": len(sample), "failed": window.failed, "empty_answers": empty,
               "program": (reference.numbers(judged)
                           if all(j is not None for j in judged) else None),
               "control": reference.numbers(low),
               "seconds": time.perf_counter() - t0,
               "sample": [[a.request, a.position, harness.data_sum(a.scene.data),
                           np.asarray(a.models, np.float64).tolist(),
                           np.asarray(a.labels).tolist()] for a in sample]}
        line = json.dumps(row)
        print(json.dumps({k: v for k, v in row.items() if k != "sample"}), flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
