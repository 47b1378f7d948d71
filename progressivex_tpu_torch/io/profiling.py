"""Device time by engine phase — counterpart of progressivex_tpu/io/profiling.py.

The engine tags its phases with `torch.profiler.record_function` under the
JAX package's scope names (core/engine.py, core/pearl.py).
`measure_phase_times` runs one fit under `torch.profiler` and adds each
operation's own device time to the innermost enclosing scope of `scopes`:
on the card, every device operation (kernel, copy, set) by the host
operation that launched it; on the CPU, where no device time exists, the
self CPU time of each `aten::` operation. Time outside every scope of
`scopes` (progx_pearl's own operations among them, as in the JAX package,
whose rollup reads the same five scopes) is `other_ms`. It reads the raw
profiler events by time and correlation, not the profiler's event tree,
which takes minutes to build for the 10^5 operations of one fit.
"""

from __future__ import annotations

import collections

import torch

DEFAULT_SCOPES = ("progx_proposal", "progx_sampling", "progx_graph",
                  "progx_labeling", "progx_refit")


def _self_times(ops):
    """(start, end, thread) host operations -> (start, thread, self ns):
    each one's duration less that of the operations nested in it."""
    by_thread = collections.defaultdict(list)
    for start, end, thread in ops:
        by_thread[thread].append((start, end))
    out = []
    for thread, evs in by_thread.items():
        evs.sort(key=lambda x: (x[0], -x[1]))
        stack, selfs = [], []
        for start, end in evs:
            while stack and stack[-1][0] <= start:
                stack.pop()
            if stack:
                selfs[stack[-1][1]][2] -= end - start
            selfs.append([start, thread, end - start])
            stack.append((end, len(selfs) - 1))
        out.extend((s, t, max(ns, 0)) for s, t, ns in selfs)
    return out


def _attribute(items, scope_spans, scopes):
    """Sum (time, thread, ns) items into the innermost scope span
    (start, end, thread, name) of the same thread that holds the time."""
    per = dict.fromkeys(scopes, 0)
    other = 0
    spans = collections.defaultdict(list)
    for start, end, thread, name in scope_spans:
        spans[thread].append((start, end, name))
    by_thread = collections.defaultdict(list)
    for t, thread, ns in items:
        by_thread[thread].append((t, ns))
    for thread, its in by_thread.items():
        its.sort()
        sp = sorted(spans[thread], key=lambda x: (x[0], -x[1]))
        stack, i = [], 0
        for t, ns in its:
            while i < len(sp) and sp[i][0] <= t:
                while stack and stack[-1][1] <= sp[i][0]:
                    stack.pop()
                stack.append(sp[i])
                i += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            if stack:
                per[stack[-1][2]] += ns
            else:
                other += ns
    return per, other


def device_operations(events):
    """The device operations (kernels, copies, sets) among raw profiler
    events, without the device-side ranges of host annotations: a
    `record_function` range shows on the device timeline too, under its
    host name, and holds the kernels it spans."""
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


def measure_phase_times(run_once, device, scopes=DEFAULT_SCOPES):
    """Profile one call of `run_once` on `device` and attribute its device
    time. Returns {"<scope>_ms": float, ..., "other_ms": float,
    "total_device_ms": float}, rounded to the microsecond as the JAX
    package rounds them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        run_once()
        if cuda:
            torch.cuda.synchronize(device)
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    scope_spans = [(e.start_ns(), e.end_ns(), e.start_thread_id(), e.name())
                   for e in host if e.name() in scopes]
    if cuda:
        # A device operation is anchored at the start of the host
        # operation it is linked to (a torch operation, or the annotation
        # around a hand-written kernel's launch); unlinked ones are other.
        launched_at = {e.correlation_id(): (e.start_ns(), e.start_thread_id())
                       for e in host if e.correlation_id() > 0}
        items = [(*launched_at.get(e.linked_correlation_id(), (-1, -1)), e.duration_ns())
                 for e in device_operations(events)]
    else:
        items = _self_times([(e.start_ns(), e.end_ns(), e.start_thread_id())
                             for e in host if e.name().startswith("aten::")])
    per, other = _attribute(items, scope_spans, scopes)
    out = {f"{s}_ms": round(v / 1e6, 3) for s, v in per.items()}
    out["other_ms"] = round(other / 1e6, 3)
    out["total_device_ms"] = round((sum(per.values()) + other) / 1e6, 3)
    return out
