"""Run one cell of the benchmark of progressivex_tpu_torch once.

  python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for (BENCHMARK.json). Prints some lines on standard error, the numbers
that decide `correct` beside their limits last, and one JSON object as
the last line of standard output. Exits non-zero without a result when
no CUDA device (or too few) is present, or when a JAX module is loaded.
The program's build caches stay inside the checkout (build/).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return out[0] if out else "nvidia-smi printed nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    sys.path.insert(0, ROOT)
    from bench_port import harness

    cell = harness.load_cell(args.workload)
    chips = {w["name"]: w for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
             ["workloads"]}[args.workload]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    result, lines = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                     "cuda:0", t_start=T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"run.py: modules that may not be loaded: {banned}", file=sys.stderr)
        return 4
    print(f"card: {_card_line()}; peaks 67 TFLOP/s f32, 3.35 TB/s", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
