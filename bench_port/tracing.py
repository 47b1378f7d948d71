"""The traced part of a `--trace 1` run: torch.profiler (CPU and CUDA
activities) over the first requests of the window, reduced to aggregates
at once; no trace file is written.

Device operations follow io/profiling.device_operations' rule, copied:
the CUDA events that are not the device-side ranges of host annotations.
The part's wall span runs from the start of its first request to the end
of its last, by the benchmark's own spans (`record_function` ranges named
"bench:..."); the device is busy where any device operation runs (the
union of their intervals) and idle elsewhere. The tracer costs the host
and the card a few microseconds a device operation, so that wall span
is longer than the same requests take untraced (about twice, at the
~88,000 operations of a single fit): the harness times them again
without it, and the idle share reads against that time. Each idle gap is
labelled by the benchmark's span open at its start and the innermost host
operation on the same thread (a graph launch, a copy, a synchronization),
or "python" where none is; its length includes the tracer's cost.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

SPAN_PREFIX = "bench:"


class Summary(NamedTuple):
    """What the readers of the traced part use."""

    window_s: float  # wall span of the profiled requests, under the profiler
    busy_s: float  # union of device-operation intervals inside it
    ops: dict  # device operation name -> [launches, seconds]
    gaps: dict  # idle-gap label -> seconds
    n_device_ops: int


def start():
    """A started profiler over CPU and CUDA activities."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def span(name: str):
    """A benchmark span: a host annotation the summary reads."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def _device_operations(events):
    """io/profiling.device_operations' rule: CUDA events that are not the
    device-side ranges of host annotations."""
    from torch.autograd import DeviceType

    host_names = {e.name() for e in events if e.device_type() == DeviceType.CPU}
    out = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        is_annotation = getattr(e, "is_user_annotation", None)
        if (is_annotation() if is_annotation is not None else False) or e.name() in host_names:
            continue
        out.append(e)
    return out


def _innermost(intervals, times):
    """For each t of sorted `times`, the name of the innermost interval
    (start, end, name) that holds it, or None."""
    intervals = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(intervals) and intervals[i][0] <= t:
            stack.append(intervals[i])
            i += 1
        stack = [s for s in stack if s[1] > t]
        out.append(stack[-1][2] if stack else None)
    return out


def summarize(prof) -> Summary | None:
    """Stop `prof` and reduce its events; None when the part holds no
    benchmark span or no device operation."""
    from torch.autograd import DeviceType

    prof.stop()
    events = prof.profiler.kineto_results.events()
    host = [(e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
            for e in events if e.device_type() == DeviceType.CPU]
    spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]
    device = [(e.start_ns(), e.end_ns(), e.name()) for e in _device_operations(events)]
    if not spans or not device:
        return None
    requests = [h for h in spans if h[2].startswith(SPAN_PREFIX + "request")]
    t0 = min(h[0] for h in requests or spans)
    t1 = max(h[1] for h in requests or spans)
    ops = collections.defaultdict(lambda: [0, 0.0])
    clipped = []
    for start, end, name in device:
        start, end = max(start, t0), min(end, t1)
        if end <= start:
            continue
        ops[name][0] += 1
        ops[name][1] += (end - start) / 1e9
        clipped.append((start, end))
    clipped.sort()
    busy, gaps, cursor = 0, [], t0
    for start, end in clipped:
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if cursor < t1:
        gaps.append((cursor, t1))
    thread = spans[0][3]
    own = [(s, e, n) for s, e, n, th in host if th == thread]
    starts = [g[0] for g in gaps]
    bench = _innermost([x for x in own if x[2].startswith(SPAN_PREFIX)], starts)
    other = _innermost([x for x in own if not x[2].startswith(SPAN_PREFIX)], starts)
    by_label = collections.defaultdict(float)
    for (start, end), b, o in zip(gaps, bench, other):
        label = f"{(b or 'none').removeprefix(SPAN_PREFIX)} | {o or 'python'}"
        by_label[label] += (end - start) / 1e9
    return Summary((t1 - t0) / 1e9, busy / 1e9, dict(ops), dict(by_label), len(device))


def top(items: dict, n: int = 10, key=lambda v: v):
    """The n entries of `items` of largest key(value), as [name, value]."""
    ranked = sorted(items.items(), key=lambda kv: key(kv[1]), reverse=True)[:n]
    return [[name, key(value)] for name, value in ranked]


def matching(ops: dict, patterns) -> tuple:
    """(launches, seconds) of the device operations whose name holds every
    substring of one of `patterns` (a list of lists of substrings)."""
    launches, seconds = 0, 0.0
    for name, (count, s) in ops.items():
        if any(all(part in name for part in pattern) for pattern in patterns):
            launches += count
            seconds += s
    return launches, seconds

