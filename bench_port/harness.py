"""The benchmark of progressivex_tpu_torch, driven by data.

A cell (an entry of "workloads" in BENCHMARK.json) names a configuration
and a traffic mix. Everything particular to them is data found by name:

- configs/<config>.json: the deployment: the family ("family": the module
  families/<family>.py), the scene generator ("generator": a key of that
  module's GENERATORS) and the dataset's scene shapes (`specs`), the
  protocol's keywords, the pad levels, the scoring work a round does
  (`work`), what was assumed;
- families/<family>.py: everything particular to a model family (the
  contract is in families/__init__.py): its entry points and the
  positional arguments they take from a scene's data, its generators, the
  shape of one model in an answer, its scoring kernel's names and
  residual operations (or no kernel), and the plain reference of its
  residual, refit and model distance. This module, synth.py,
  reference.py, roofline.py and the readers take all of it from there, so
  a new family is a new module, a configuration, a traffic mix and a
  checks file, with entries in BENCHMARK.json;
- traffic/<traffic>.json: how requests are made from the specs (one
  caller in a closed loop serves every mix: the next request leaves when
  the last has returned): one
  batched call of every shape `copies` times (`"entry": "batched"`), or one
  single-scene call a request over a seeded shuffled cycle of the shapes
  (`"entry": "single"`); the pool drawn in set-up, the warm-up passes, the
  seconds set-up goes on serving the pool once they are done
  (`settle_seconds`, 0 when absent), the requests the traced run profiles
  and the answers the check judges;
- checks/<cell>.json: the numbers of reference.py the cell compares, each
  with its limit;
- metrics/<metric>.py: one reader a per-layer metric, `read(readings)`,
  returning the value or None when it finds nothing to read.

One run (`run_cell`): set-up (the program, its kernels from the build
cache, the request pool, the warm-up passes, the settling), then a closed
loop of one caller for `seconds` seconds that ends with the request in
flight, then the judgment of a sample of the answers by the plain
reference. The
scenes are drawn from the seed and the request's index, so a seed gives
the same inputs; every request carries its own `random_seed`.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import os
import resource
import subprocess
import sys
import time
import traceback
import zlib
from typing import NamedTuple

import numpy as np

from bench_port import families, reference, synth, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "bench_port")
# Modules that may not be loaded in a run, by their top-level name.
BANNED = ("jax", "jaxlib", "flax", "progressivex_tpu")


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list  # BENCHMARK.json entries of the cell's end-to-end metrics
    per_layer: list  # ... and of its per-layer metrics

    @property
    def family(self):
        return families.load(self.config["family"])


def _load(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its data files."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(metric):
        return name in metric.get("workloads", [name])

    return Cell(name, _load(os.path.join(root, cfg["file"])),
                _load(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
                _load(os.path.join(HERE, "checks", f"{name}.json")),
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def banned_modules() -> list:
    """The loaded modules whose top-level name is banned."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def _crc(text: str) -> int:
    return zlib.crc32(text.encode())


def pad_of(n: int, levels) -> int:
    """The pad level of a scene of n points: the smallest level >= n."""
    for level in levels:
        if n <= level:
            return level
    raise ValueError(f"{n} points exceed the largest pad level")


# --- requests -------------------------------------------------------------


class Scene(NamedTuple):
    shape: int  # index into the configuration's specs
    data: object  # the scene as the family's entry points take it
    gt: np.ndarray  # [n] ground-truth labels, 0 = outlier


def data_sum(data) -> float:
    """The sum of every number of a scene's data (an array, or a tuple or
    list of them): the scene's checksum in control.py's records."""
    if isinstance(data, (tuple, list)):
        return float(sum(data_sum(d) for d in data))
    return float(np.sum(data))


class Request(NamedTuple):
    index: int
    scenes: list
    random_seed: int


def _shape_order(seed, index, n_shapes):
    """The shape of single request `index`: a shuffled cycle of the shapes,
    a new shuffle each cycle, drawn from the seed."""
    cycle, pos = divmod(index, n_shapes)
    rng = np.random.default_rng(_crc(f"{seed}/order/{cycle}"))
    return int(rng.permutation(n_shapes)[pos])


def make_request(cell: Cell, seed, index) -> Request:
    """Request `index` of a run of `seed` (an int, or a label for warm-up
    requests): its scenes drawn fresh, and its random_seed."""
    cfg, traffic = cell.config, cell.traffic
    specs = cfg["specs"]

    def draw(shape, copy):
        data, gt = synth.draw_scene(cell.family, cfg["generator"], cfg["problem"], specs[shape],
                                    f"{seed}/{index}/{copy}")
        return Scene(shape, data, gt)

    if traffic["entry"] == "batched":
        scenes = [draw(j, c) for j in range(len(specs)) for c in range(traffic["copies"])]
    else:
        scenes = [draw(_shape_order(seed, index, len(specs)), 0)]
    return Request(index, scenes, _crc(f"{seed}/{index}/random_seed") & 0x7FFFFFFF)


def warm_requests(cell: Cell, seed, p: int) -> list:
    """Warm-up pass p: the window's calls, on fresh draws. Batched: one
    batched request (every pad level and call). Single: one scene of
    each pad level the shapes reach. Odd passes draw every scene with at
    least two structures: a key's graph of a round that runs PEARL is
    captured only when a fit accepts a second model, which a pad level
    whose shapes hold one structure (physics, bonython) may never do in
    a pass of its own shapes. The keys (pad level, rows, configuration)
    are the window's either way."""
    cfg = cell.config
    specs = [list(s) for s in cfg["specs"]]
    if p % 2:
        specs = [[name, n, max(int(k), 2), rate] for name, n, k, rate in specs]
    warm = cell._replace(config=dict(cfg, specs=specs))
    if cell.traffic["entry"] == "batched":
        return [make_request(warm, seed, f"warm{p}")]
    seen, out = set(), []
    for j, spec in enumerate(specs):
        level = pad_of(spec[1], cfg["pad_levels"])
        if level not in seen:
            seen.add(level)
            data, gt = synth.draw_scene(cell.family, cfg["generator"], cfg["problem"], spec,
                                        f"{seed}/warm{p}/{j}")
            out.append(Request(-1, [Scene(j, data, gt)],
                               _crc(f"{seed}/warm{p}/{j}") & 0x7FFFFFFF))
    return out


# --- calls ----------------------------------------------------------------


class Call(NamedTuple):
    label: str
    scenes: list  # indices into the request's scenes
    run: object  # () -> list of (models [rows K, cols], labels [n]) and rounds (or None)
    groups: list  # [(pad, n_valid of each real row)], for the roofline


def _protocol(cell: Cell, split: bool) -> dict:
    kw = dict(cell.config["protocol"])
    if not split:
        kw.pop("split_pass", None)
    return kw


def calls_of(cell: Cell, program, request: Request, device) -> list:
    """The entry-point calls that serve `request`. Batched: one call a
    side of the protocol's split gate (pads below `split_pass_min_npad`
    run without the split move). Single: one call, with statistics."""
    cfg, family = cell.config, cell.family
    levels, min_split = cfg["pad_levels"], cfg.get("split_pass_min_npad", 0)
    restarts = int(cfg["protocol"].get("n_restarts", 1))
    scenes = request.scenes

    def split_of(s):
        return pad_of(len(s.gt), levels) >= min_split

    def groups(idx):
        by_pad = {}
        for i in idx:
            n = len(scenes[i].gt)
            by_pad.setdefault(pad_of(n, levels), []).extend([n] * restarts)
        return sorted(by_pad.items())

    if cell.traffic["entry"] == "single":
        s = scenes[0]

        def run_single(s=s):
            fn = getattr(program, family.ENTRY_SINGLE)
            models, labels, stats = fn(*family.single_args(s.data),
                                       **_protocol(cell, split_of(s)),
                                       random_seed=request.random_seed,
                                       with_statistics=True, device=device)
            return [(models, labels)], stats.rounds_run

        return [Call(family.ENTRY_SINGLE, [0], run_single, groups([0]))]
    out = []
    for split in (False, True):
        idx = [i for i, s in enumerate(scenes) if split_of(s) == split]
        if not idx:
            continue

        def run_batched(idx=idx, split=split):
            fn = getattr(program, family.ENTRY_BATCHED)
            res = fn(*family.batched_args([scenes[i].data for i in idx]),
                     **_protocol(cell, split),
                     random_seed=request.random_seed, device=device)
            return list(res), None

        label = (f"{family.ENTRY_BATCHED}[{'split' if split else 'no split'}]"
                 if "split_pass_min_npad" in cfg else family.ENTRY_BATCHED)
        out.append(Call(label, idx, run_batched, groups(idx)))
    return out


# --- counters of the program ----------------------------------------------


def _launches(kernel: str) -> int:
    from progressivex_tpu_torch.kernels.scoring import LAUNCHES

    return LAUNCHES.get(kernel, 0)


def _graphs_built() -> int:
    from progressivex_tpu_torch.core.graphs import BUILDS

    return BUILDS["graphs"]


# --- a run ----------------------------------------------------------------


class Answer(NamedTuple):
    request: int
    position: int  # of the scene in its request
    scene: Scene
    models: np.ndarray
    labels: np.ndarray


class Window(NamedTuple):
    answers: list
    latencies: list  # seconds of each request
    elapsed: float
    attempted: int
    failed: int
    rounds: list  # rounds_run of single-scene fits
    traced_calls: list  # (family name, groups, launches) of the profiled calls
    traced_scenes: int
    traced_requests: int
    summary: object  # tracing.Summary or None
    graphs_built: int  # graphs captured inside the window (0 when warm)
    host: dict  # the process's CPU seconds, involuntary switches and GC in the window


def _serve(cell, program, request, device, trace):
    """Serve one request: (answers, failed, rounds, calls' work)."""
    answers, failed, rounds, work = [], 0, [], []
    kernel = cell.family.KERNEL
    for call in calls_of(cell, program, request, device):
        before = _launches(kernel)
        try:
            with tracing.span(call.label) if trace else contextlib.nullcontext():
                results, n_rounds = call.run()
        except Exception:  # a failed call fails its scenes; the loop goes on
            traceback.print_exc(file=sys.stderr)
            failed += len(call.scenes)
            continue
        work.append((cell.config["family"], call.groups, _launches(kernel) - before))
        if n_rounds is not None:
            rounds.append(int(n_rounds))
        if len(results) != len(call.scenes):
            failed += len(call.scenes)
            continue
        for i, (models, labels) in zip(call.scenes, results):
            answers.append(Answer(request.index, i, request.scenes[i], np.asarray(models),
                                  np.asarray(labels)))
    return answers, failed, rounds, work


def warm_up(cell, program, seed, device, passes: int):
    """Warm-up passes, fresh draws each, until two passes in a row capture
    no new graph (at most `passes`): a key's graph of a round without
    PEARL, or with it, is captured only when a fit first runs one.
    Returns the seconds of each first call of the first pass, by label,
    the graphs each pass captured, and the scenes whose calls failed."""
    first, built, failed = [], [], 0
    for p in range(passes):
        before = _graphs_built()
        for request in warm_requests(cell, seed, p):
            t0 = time.perf_counter()
            failed += _serve(cell, program, request, device, False)[1]
            if p == 0:
                first.append((f"pad {pad_of(len(request.scenes[0].gt), cell.config['pad_levels'])}"
                              if cell.traffic["entry"] == "single" else "request",
                              time.perf_counter() - t0))
        built.append(_graphs_built() - before)
        if len(built) >= 3 and built[-1] == built[-2] == 0:
            break
    return first, built, failed


class Pool:
    """The window's requests. `pool_requests` of them are drawn in set-up;
    request i past them serves the scenes of request i mod pool_requests
    again, with its own random_seed: the program keeps nothing between
    calls that a repeated scene could hit, so it does the work of a
    fresh one, and no scene is drawn inside the window."""

    def __init__(self, cell, seed, size):
        self.seed = seed
        self.items = [make_request(cell, seed, i) for i in range(size)]

    def get(self, i):
        base = self.items[i % len(self.items)]
        return base._replace(index=i, random_seed=_crc(f"{self.seed}/{i}/random_seed") & 0x7FFFFFFF)


def settle(cell, program, pool, device, seconds: float):
    """Serve the pool's requests in order, with random_seeds of their own,
    until `seconds` have passed: the card under the window's own load
    before the window opens. On an H100 a single-scene F fit ran 16-21%
    slower in its first 0 to 17 s of sustained load, which the warm-up
    passes, loading the card lightly, do not reach; the window would time
    that. Returns the requests served and the scenes whose calls failed."""
    t0, i, failed = time.perf_counter(), 0, 0
    while time.perf_counter() - t0 < seconds:
        base = pool.items[i % len(pool.items)]
        request = base._replace(index=-1, random_seed=_crc(f"{pool.seed}/settle/{i}") & 0x7FFFFFFF)
        failed += _serve(cell, program, request, device, False)[1]
        i += 1
    return i, failed


class _HostReadings:
    """The process's CPU time, involuntary context switches and garbage
    collections between `start` and `stop`: what would tell a run slowed
    by the host from one slowed by the card."""

    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def start(self):
        gc.callbacks.append(self._gc)
        self._ru = resource.getrusage(resource.RUSAGE_SELF)

    def stop(self) -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.remove(self._gc)
        return {"cpu_s": (ru.ru_utime + ru.ru_stime) - (self._ru.ru_utime + self._ru.ru_stime),
                "involuntary_switches": ru.ru_nivcsw - self._ru.ru_nivcsw,
                "gc_s": self.gc_s, "gc_n": self.gc_n}


def card_state() -> str:
    """The card's SM and memory clocks, temperature, power draw and active
    throttle reasons, as nvidia-smi reads them."""
    query = "clocks.sm,clocks.mem,temperature.gpu,power.draw,clocks_throttle_reasons.active"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def run_window(cell, program, pool, seconds, device, trace) -> Window:
    """The closed loop: requests back to back until `seconds` have passed,
    ending with the request in flight. With `trace`, the first
    `trace_requests` requests run under the profiler."""
    answers, latencies, rounds, traced_calls = [], [], [], []
    attempted = failed = traced_scenes = traced_requests = 0
    summary, prof = None, tracing.start() if trace else None
    n_trace = int(cell.traffic["trace_requests"])
    built = _graphs_built()
    host = _HostReadings()
    host.start()
    t0 = time.perf_counter()
    i = 0
    while True:
        request = pool.get(i)
        tracing_now = prof is not None
        ts = time.perf_counter()
        with tracing.span(f"request {i}") if tracing_now else contextlib.nullcontext():
            got, bad, r, work = _serve(cell, program, request, device, tracing_now)
        te = time.perf_counter()
        latencies.append(te - ts)
        answers.extend(got)
        attempted += len(request.scenes)
        failed += bad
        rounds.extend(r)
        if tracing_now:
            traced_calls.extend(work)
            traced_scenes += len(got)
            traced_requests += 1
            if i + 1 == n_trace:
                summary, prof = tracing.summarize(prof), None
        i += 1
        if te - t0 >= seconds:
            break
    host_readings = host.stop()
    if prof is not None:
        summary = tracing.summarize(prof)
    return Window(answers, latencies, te - t0, attempted, failed, rounds, traced_calls,
                  traced_scenes, traced_requests, summary, _graphs_built() - built,
                  host_readings)


def untraced_s(cell, program, pool, window, device) -> float:
    """Wall seconds of the traced requests served again without the
    profiler, once the window has closed: the same scenes and random_seeds,
    so the same work, without the tracer's cost per device operation."""
    import torch

    t0 = time.perf_counter()
    for i in range(window.traced_requests):
        _serve(cell, program, pool.get(i), device, False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def check_sample(cell, window, seed) -> list:
    """The answers the reference judges: up to `check_per_shape` of each
    shape, drawn from the seed."""
    rng = np.random.default_rng(_crc(f"{seed}/check"))
    by_shape = {}
    for a in window.answers:
        by_shape.setdefault(a.scene.shape, []).append(a)
    k = int(cell.traffic["check_per_shape"])
    out = []
    for shape in sorted(by_shape):
        items = by_shape[shape]
        pick = rng.choice(len(items), size=min(k, len(items)), replace=False)
        out.extend(items[j] for j in sorted(pick))
    return out


def judge_answers(cell, answers, judge=reference.judge):
    """Each answer judged (None where malformed)."""
    thr = cell.config["protocol"]["threshold"]
    return [judge(cell.family, a.scene.data, a.scene.gt, a.models, a.labels, thr)
            for a in answers]


def verdict(cell, judged) -> tuple:
    """(correct, checks): each number the cell compares beside its limit."""
    if not judged or any(j is None for j in judged):
        return False, {"malformed": {"value": sum(j is None for j in judged) if judged
                                     else 1, "limit": 0}}
    nums = reference.numbers(judged)
    checks = {name: {"value": nums[name] if math.isfinite(nums[name]) else None,
                     "limit": spec["limit"]}
              for name, spec in cell.checks["compare"].items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


class Readings(NamedTuple):
    """What the per-layer readers read."""

    cell: Cell
    window: Window
    first_calls: list  # (label, seconds) of the set-up's first calls
    untraced_s: float | None  # the traced requests' wall without the profiler


def read_per_layer(cell, readings) -> dict:
    """{metric: {"value", "unit"}} of the cell's per-layer metrics that
    their readers found."""
    out = {}
    for m in cell.per_layer:
        reader = importlib.import_module(f"bench_port.metrics.{m['name']}")
        value = reader.read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _me(a: Answer) -> float:
    """The answer's misclassification error; 1 where it is malformed."""
    labels = np.asarray(a.labels)
    if labels.shape != a.scene.gt.shape or labels.min(initial=0) < 0:
        return 1.0
    return reference.misclassification(labels, a.scene.gt)


def end_to_end(cell, window, setup_s) -> dict:
    """{metric: {"value", "unit"}} of the cell's end-to-end metrics."""
    values = {
        "scenes_per_s": len(window.answers) / window.elapsed,
        "fit_ms_p95": float(np.percentile(window.latencies, 95)) * 1e3,
        "misclass_pct": 100.0 * float(np.mean([_me(a) for a in window.answers]))
        if window.answers else 100.0,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def run_cell(cell, seed, seconds, trace, device, program=None, t_start=None):
    """One run of `cell`: (result, lines for standard error). `program` is
    the system under test (progressivex_tpu_torch unless given); `t_start`
    the process's start on the host clock, from which set-up counts."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"
    if program is None:
        import progressivex_tpu_torch as program
    if cuda:
        from progressivex_tpu_torch.kernels import _build

        _build.build_all()
    traffic = cell.traffic
    pool = Pool(cell, seed, int(traffic["pool_requests"]))
    first, built, warm_failed = warm_up(cell, program, seed, device,
                                        int(traffic["warm_passes"]))
    settled, settle_failed = settle(cell, program, pool, device,
                                    float(traffic.get("settle_seconds", 0)))
    warm_failed += settle_failed
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    window = run_window(cell, program, pool, seconds, device, trace)
    card = card_state() if cuda else device.type
    peak = int(torch.cuda.max_memory_reserved(device)) if cuda else 0
    summary = window.summary
    untraced = (untraced_s(cell, program, pool, window, device)
                if trace and summary is not None else None)
    judged = judge_answers(cell, check_sample(cell, window, seed))
    empty = sum(1 for a in window.answers if np.asarray(a.models).size == 0)
    correct, checks = verdict(cell, judged)
    correct = correct and window.failed == 0 and warm_failed == 0
    if trace:
        metrics = read_per_layer(cell, Readings(cell, window, first, untraced))
    else:
        metrics = end_to_end(cell, window, setup_s)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if trace and summary is not None:
        # The traced requests' length as served without the profiler: under
        # it each device operation costs the host and the card a few
        # microseconds more, which would read as idle time.
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = untraced
        result["breakdown"] = {
            "device_ops": tracing.top(summary.ops, key=lambda v: v[1]),
            "idle_gaps": tracing.top(summary.gaps)}
    result["checks"] = checks
    lines = [
        f"set-up {setup_s:.3f} s (graphs a warm-up pass {built}, {warm_failed} scenes "
        f"failed, {settled} requests settling): first calls "
        + ", ".join(f"{k} {v:.3f} s" for k, v in first),
        f"window {window.elapsed:.3f} s: {len(window.latencies)} requests, "
        f"{len(window.answers)} answers, {window.failed} failed, {empty} without a model, "
        f"{window.graphs_built} graphs built in the window",
        f"host in the window: {window.host['cpu_s']:.3f} CPU s, "
        f"{window.host['involuntary_switches']} involuntary switches, gc "
        f"{window.host['gc_s']:.3f} s in {window.host['gc_n']} collections; card after it: {card}",
        f"judged {len(judged)} answers",
    ]
    if summary is not None:
        lines.append(f"traced {window.traced_requests} requests ({window.traced_scenes} scenes): "
                     f"{summary.window_s:.3f} s under the profiler, {untraced:.3f} s served again "
                     f"without it; {summary.n_device_ops} device operations, busy "
                     f"{summary.busy_s:.4f} s")
    lines += [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in checks.items()]
    return result, lines
