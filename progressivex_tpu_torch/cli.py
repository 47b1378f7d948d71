"""Console entry points of the port — counterpart of progressivex_tpu/cli.py.

  python -m progressivex_tpu_torch.cli [--problems HF] [--timing-runs 3]
                                       [--lane-target 32] [--device cuda]
                                       [--synth] [--synth-root DIR]
  python -m progressivex_tpu_torch.cli eval [--problem H] [--root DIR]
                                            [--seed 0] [--device cuda]

`bench_main` is the scene-batched AdelaideRMF H + F throughput and quality
bench on the bundled scenes (`eval/adelaide.throughput_batch`): one JSON
line on stdout with the JAX package's keys, `adelaide{H,F}_scenes_per_sec`,
`_mean_me`, `_full_dataset` (false: the bundled scenes, nothing is
downloaded) and `_dataset_pass_seconds`. With `--synth` it then runs the
synthetic full-cardinality datasets (`eval/synth_adelaide`, 19 H and 18 F
scenes, written under `--synth-root` once) through the buckets the bundled
run used where a scene fits one, one timing run, and adds the JAX bench's
`synth{19,18}{H,F}_n_scenes`, `_mean_misclassification`,
`_dataset_seconds` and `_compile_seconds` (bench.py:298-329).

`PROGX_BENCH_DEVICES=n` (n > 1) shards every batch of the bench over n
cards' scenes axis (`eval/adelaide`).

`eval_main` runs the notebook protocol once per scene of a dataset
(`eval/adelaide.evaluate_scenes`: `--root`, else the bundled scenes) and
prints the JSON result. Both run on the card unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import json
import sys


def bench_main(argv=None):
    from progressivex_tpu_torch.eval.adelaide import throughput_batch
    from progressivex_tpu_torch.eval.synth_adelaide import (DEFAULT_SYNTH_ROOT,
                                                            F_SPECS, H_SPECS,
                                                            ensure_synth_dataset)

    p = argparse.ArgumentParser(description="AdelaideRMF throughput bench (port)")
    p.add_argument("--problems", default="HF", help="subset of 'HF' to run")
    p.add_argument("--timing-runs", type=int, default=3,
                   help="timed executions per lane batch (best is reported)")
    p.add_argument("--lane-target", type=int, default=32,
                   help="lanes per pad level (scenes replicated cyclically)")
    p.add_argument("--device", default=None, help="default: the CUDA device")
    p.add_argument("--synth", action="store_true",
                   help="also run the synthetic 19 H + 18 F scene datasets")
    p.add_argument("--synth-root", default=DEFAULT_SYNTH_ROOT,
                   help="directory of the synthetic datasets (made once)")
    args = p.parse_args(argv)
    out = {}
    bundled = {}
    for prob in args.problems.upper():
        r = throughput_batch(prob, n_timing_runs=args.timing_runs,
                             lane_target=args.lane_target, device=args.device)
        bundled[prob] = r
        print(f"{prob}: {r.scenes_per_sec:.2f} scenes/s ME={r.mean_me:.4f} "
              f"(batch={r.n_scenes}, full_dataset={r.full_dataset}, "
              f"compile={r.compile_seconds:.1f}s)", file=sys.stderr)
        out[f"adelaide{prob}_scenes_per_sec"] = round(r.scenes_per_sec, 3)
        out[f"adelaide{prob}_mean_me"] = round(r.mean_me, 4)
        out[f"adelaide{prob}_full_dataset"] = r.full_dataset
        out[f"adelaide{prob}_dataset_pass_seconds"] = round(r.pass_seconds, 4)
    if args.synth:
        for prob, r in bundled.items():
            card = len(H_SPECS if prob == "H" else F_SPECS)
            s = throughput_batch(prob, root=ensure_synth_dataset(prob, args.synth_root),
                                 n_timing_runs=1, lane_target=args.lane_target,
                                 allowed_buckets={b["n_pad"] for b in r.buckets},
                                 device=args.device)
            print(f"synthetic full-cardinality {prob}: {s.n_distinct} scenes "
                  f"ME={s.mean_me:.4f} pass={s.pass_seconds * 1e3:.1f}ms "
                  f"(first calls {s.compile_seconds:.1f}s)", file=sys.stderr)
            out[f"synth{card}{prob}_n_scenes"] = s.n_distinct
            out[f"synth{card}{prob}_mean_misclassification"] = round(s.mean_me, 4)
            out[f"synth{card}{prob}_dataset_seconds"] = round(s.pass_seconds, 4)
            out[f"synth{card}{prob}_compile_seconds"] = round(s.compile_seconds, 1)
    print(json.dumps(out))
    return out


def eval_main(argv=None):
    from progressivex_tpu_torch.eval.adelaide import evaluate_scenes

    p = argparse.ArgumentParser(
        description="Per-scene AdelaideRMF evaluation (notebook protocol, port)")
    p.add_argument("--problem", default="H", choices=["H", "F", "h", "f"])
    p.add_argument("--root", default=None, help="dataset directory (default: bundled)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the CUDA device")
    args = p.parse_args(argv)
    res = evaluate_scenes(args.problem, root=args.root, seed=args.seed,
                          do_logging=True, device=args.device)
    for v in res["per_scene"].values():
        v.pop("labels")  # an array, not JSON
    print(json.dumps(res, indent=2))
    return res


def main(argv=None):
    """`eval ...` runs eval_main, anything else bench_main."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["eval"]:
        return eval_main(argv[1:])
    return bench_main(argv)


if __name__ == "__main__":
    main()
