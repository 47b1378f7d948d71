"""Console entry point of the port — counterpart of progressivex_tpu/cli.py.

  python -m progressivex_tpu_torch.cli [--problems HF] [--timing-runs 3]
                                       [--lane-target 32] [--device cuda]

`bench_main` is the scene-batched AdelaideRMF H + F throughput and quality
bench on the bundled scenes (`eval/adelaide.throughput_batch`): one JSON
line on stdout with the JAX package's keys, `adelaide{H,F}_scenes_per_sec`,
`_mean_me`, `_full_dataset` (false: the bundled scenes, nothing is
downloaded) and `_dataset_pass_seconds`. It runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys


def bench_main(argv=None):
    from progressivex_tpu_torch.eval.adelaide import throughput_batch

    p = argparse.ArgumentParser(description="AdelaideRMF throughput bench (port)")
    p.add_argument("--problems", default="HF", help="subset of 'HF' to run")
    p.add_argument("--timing-runs", type=int, default=3,
                   help="timed executions per lane batch (best is reported)")
    p.add_argument("--lane-target", type=int, default=32,
                   help="lanes per pad level (scenes replicated cyclically)")
    p.add_argument("--device", default=None, help="default: the CUDA device")
    args = p.parse_args(argv)
    out = {}
    for prob in args.problems.upper():
        r = throughput_batch(prob, n_timing_runs=args.timing_runs,
                             lane_target=args.lane_target, device=args.device)
        print(f"{prob}: {r.scenes_per_sec:.2f} scenes/s ME={r.mean_me:.4f} "
              f"(batch={r.n_scenes}, full_dataset={r.full_dataset}, "
              f"compile={r.compile_seconds:.1f}s)", file=sys.stderr)
        out[f"adelaide{prob}_scenes_per_sec"] = round(r.scenes_per_sec, 3)
        out[f"adelaide{prob}_mean_me"] = round(r.mean_me, 4)
        out[f"adelaide{prob}_full_dataset"] = r.full_dataset
        out[f"adelaide{prob}_dataset_pass_seconds"] = round(r.pass_seconds, 4)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    bench_main()
