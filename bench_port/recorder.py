"""The recorder part of a `--trace 1` run: the program's own spans
(progressivex_tpu_torch/io/profiling.py), recorded in memory while the
profiled requests are served once more, with the profiler off, and the
reductions that the per-layer readers take from them.

The part runs once the window, the untraced replay (harness.untraced_s)
and the judgment have ended: the first reader that asks serves it, and
every reader reads the same spans. It serves the same requests as the
profiled part and the untraced replay (their scenes and random_seeds),
so its device time a scene sits beside `device_ms_per_scene` on the same
fits and its wall beside the untraced replay's: the recorder's cost. (A
traced single-cell window reaches about one request past the profiled
ones: the profiler's summary of their 1.8M device operations takes most
of its 51 s.) It runs on the card (the CPU where there is none, for a
rehearsal: no replay, so the readers of device time find nothing). The
seed is run.py's `--seed`, read from the command line, since the
readings do not carry it. No part, and every reader None, when the
program has no recorder (`profiling.recording`) or the command line
holds no seed.

A call's wall time (its `progx.call` span) is split on the device's
timeline: the device intervals of its replays, by stage, and the time in
which no replay runs, named by the program point the host is at:
"entry" (before the first replay: the inputs, the fit's set-up), a read
(`progx.read.*` between two replays: the gap after the replay before it),
"between replays" (two replays of one fit with no read between),
"between fits" (the results of one pad level and the inputs of the next)
and "after" (the last replay to the call's return: the results). Copies
of the inputs and results run in that time too. The part prints this
accounting a scene on standard error, with the host time of the calls
outside every span inside them and the time between calls (the
benchmark's own).
"""

from __future__ import annotations

import argparse
import collections
import sys
import time

REPLAY = "progx.replay."
READ = "progx.read."
ROUND_STAGES = ("propose", "update0", "update1", "rounds")

_PARTS: dict = {}  # id(window) -> (window, spans or None)


def _run_seed():
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def spans(readings):
    """The recorder part's spans of this run (served at the first call),
    or None."""
    window = readings.window
    got = _PARTS.get(id(window))
    if got is None or got[0] is not window:
        got = _PARTS[id(window)] = (window, _serve_part(readings))
    return got[1]


def _serve_part(readings):
    import torch

    from progressivex_tpu_torch.io import profiling

    seed = _run_seed()
    if not hasattr(profiling, "recording") or seed is None:
        return None
    import progressivex_tpu_torch as program

    from bench_port import harness

    cell, window = readings.cell, readings.window
    n_requests = window.traced_requests
    cuda = torch.cuda.is_available()
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    latencies, rounds = [], []
    with profiling.recording() as recorded:
        for i in range(n_requests):
            request = harness.make_request(cell, seed, i)  # the pool's request i
            t0 = time.perf_counter()
            _, _, r, _ = harness._serve(cell, program, request, device, False)
            latencies.append(time.perf_counter() - t0)
            rounds.extend(r)
    if cuda:
        torch.cuda.synchronize(device)
    for line in _report(readings, recorded, latencies, rounds):
        print(line, file=sys.stderr)
    return list(recorded)


# --- reductions -----------------------------------------------------------


def calls(recorded):
    """[(call span, its spans)] of the entry-point calls, in time order."""
    members = collections.defaultdict(list)
    for s in recorded:
        members[s.call].append(s)
    roots = sorted((s for s in recorded if s.name == "progx.call" and s.parent is None),
                   key=lambda s: s.start_ns)
    return [(c, members[c.id]) for c in roots]


def scenes(recorded):
    return sum(c.counts.get("scenes", 0) for c, _ in calls(recorded))


def split(call, members):
    """{label: ns} of the call's wall on the device's timeline: each
    replay stage's device time ("replay.<stage>") and the time without a
    replay by program point ("gap.<point>"). The labels sum to the wall
    when the replays neither overlap nor leave the call."""
    replays = sorted((s for s in members if s.name.startswith(REPLAY) and s.device),
                     key=lambda s: s.device[0])
    reads = sorted((s for s in members if s.name.startswith(READ)), key=lambda s: s.start_ns)
    fits = {s.id for s in members if s.name == "progx.fit"}
    parent = {s.id: s.parent for s in members}

    def fit_of(s):
        while s is not None and s not in fits:
            s = parent.get(s)
        return s

    out = collections.Counter()
    cursor, point = call.start_ns, "entry"
    for k, r in enumerate(replays):
        start, end = r.device
        out[f"gap.{point}"] += max(start - cursor, 0)
        out[f"replay.{r.name[len(REPLAY):]}"] += end - start
        cursor = max(cursor, end)
        if k + 1 < len(replays):
            nxt = replays[k + 1]
            between = [s for s in reads if r.end_ns <= s.start_ns < nxt.start_ns]
            if between:
                point = between[-1].name[len("progx."):]
            elif fit_of(r.parent) == fit_of(nxt.parent):
                point = "between replays"
            else:
                point = "between fits"
    out["gap.after" if replays else "gap.entry"] += max(call.end_ns - cursor, 0)
    return out


def _union(intervals):
    total, cursor = 0, None
    for start, end in sorted(intervals):
        if cursor is None or start > cursor:
            total += end - start
            cursor = end
        elif end > cursor:
            total += end - cursor
            cursor = end
    return total


def outside(call, intervals):
    """Ns of the call's wall outside every (start_ns, end_ns) of
    `intervals`."""
    cut = [(max(a, call.start_ns), min(b, call.end_ns)) for a, b in intervals]
    return (call.end_ns - call.start_ns) - _union([i for i in cut if i[1] > i[0]])


def totals(recorded):
    """(summed split over every call, number of propose replays, scenes)."""
    out = collections.Counter()
    for c, members in calls(recorded):
        out.update(split(c, members))
    proposes = sum(1 for s in recorded if s.name == REPLAY + "propose")
    return out, proposes, scenes(recorded)


def _report(readings, recorded, latencies, rounds):
    """The part's lines for standard error."""
    cl = calls(recorded)
    n = scenes(recorded)
    if not cl or n == 0:
        return [f"recorder part: {len(latencies)} requests, nothing recorded"]
    split_ns, proposes, _ = totals(recorded)
    wall = sum(c.end_ns - c.start_ns for c, _ in cl)
    no_span = sum(outside(c, [(s.start_ns, s.end_ns) for s in m if s.parent == c.id])
                  for c, m in cl)
    between = sum(max(b.start_ns - a.end_ns, 0) for (a, _), (b, _) in zip(cl, cl[1:]))
    replay_ns = sum(v for k, v in split_ns.items() if k.startswith("replay."))
    gap_ns = sum(v for k, v in split_ns.items() if k.startswith("gap."))
    window, untraced = readings.window, readings.untraced_s
    rest = window.latencies[len(latencies):]
    lines = [
        f"recorder part: the {len(latencies)} profiled requests served again with the recorder "
        f"on: {n} scenes, {n / sum(latencies):.3f} scenes/s; "
        + (f"in the untraced replay, recorder off: {n / untraced:.3f} scenes/s; "
           if untraced else "")
        + (f"the window's unprofiled requests: {n / len(latencies) * len(rest) / sum(rest):.3f} "
           "scenes/s" if rest else "the window served no unprofiled request"),
        "recorder part, device ms a scene by stage: " + ", ".join(
            f"{k[len('replay.'):]} {v / 1e6 / n:.4f}" for k, v in sorted(split_ns.items())
            if k.startswith("replay.")) + f"; all replays {replay_ns / 1e6 / n:.4f}",
        "recorder part, ms a scene without a replay, by program point: " + ", ".join(
            f"{k[len('gap.'):]} {v / 1e6 / n:.4f}" for k, v in sorted(split_ns.items())
            if k.startswith("gap.")),
        f"recorder part, accounting a scene: call wall {wall / 1e6 / n:.4f} ms = replays "
        f"{replay_ns / 1e6 / n:.4f} + no replay {gap_ns / 1e6 / n:.4f} "
        f"({100 * (replay_ns + gap_ns) / wall:.2f}% of the wall); host outside every span "
        f"in the call {no_span / 1e6 / n:.4f} ms; between calls (the benchmark's) "
        f"{between / 1e6 / n:.4f} ms; {proposes} propose replays",
    ]
    if rounds:
        per_call = [sum(1 for s in m if s.name == REPLAY + "propose") for _, m in cl]
        same = sum(p == r for p, r in zip(per_call, rounds))
        lines.append(f"recorder part: propose replays equal rounds_run in {same} of "
                     f"{len(rounds)} fits")
    return lines
