"""Device time by engine phase — counterpart of progressivex_tpu/io/profiling.py —
and the port's spans.

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
which takes minutes to build for the 10^5 operations of one fit. The fit
runs eagerly on the card (core/graphs.eager): a replayed CUDA graph
launches its operations with no host operation or scope around each.

`op_self_times` is the counterpart of the JAX package's function of that
name for a trace that `torch.profiler` wrote: (match text, self time)
pairs, one a device operation, or one a host operation where the trace
holds none, each with the names of the annotations around it (the phase
scopes, a hand-written kernel's name) so that a phase tag matches it.

Spans. The port marks the boundaries of three layers with `span` (and
`call`, `replay`), named with dots so that they never match the phase
scopes' underscores:

  progx.call              api._run, api_batch._run_batched: one entry-point
                          call (count `scenes`)
  progx.inputs            padding, masks, the tensors to the device (one a
                          pad level in a batched call, with counts `rows`
                          launched and `real_rows`: the rows of real
                          scenes, filler lanes left out)
  progx.fit               engine.fit_rows, graph or eager: one key's fit
  progx.replay.<stage>    core/graphs: one graph replay (prepare, start,
                          propose, update0, update1, finish, rounds), with
                          its device interval
  progx.read.any_pearl, progx.read.all_done, progx.read.progress
                          core/graphs: the host reads between replays
  progx.results           reads to the host, select_restart,
                          compact_result, Statistics

With neither a recording nor the profiler on, `span` returns one shared
no-op object after two flag checks: about 1 us a `with` block on the
CPU, some 50 us for the 45 spans of a fit. It enters no
`record_function`, which costs about 11-14 us even with the profiler
off. Under the profiler each span is a `record_function` range, on the
trace's clock. Inside `recording()` (about 10 us a span on the CPU)
each span is kept in memory as a `Span` (name, ids, thread, host
interval, counts) and also enters `record_function` when the profiler is
on. A call synchronizes its device once at its start and records an
anchor CUDA event there; each replay records an event before and after
`graph.replay()` on the current stream; the events are resolved when the
call returns (`elapsed_time` from the anchor), so a replay's device
interval lies on the host clock. Nothing is read inside the round loop.
The recorder writes no file. A thread keeps its own span stack (a
context variable, which `_device.run_per_device` hands to a mesh's shard
threads, so their spans keep the call's id).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import glob
import gzip
import itertools
import json
import os
import threading
import time

import torch

DEFAULT_SCOPES = ("progx_proposal", "progx_sampling", "progx_graph",
                  "progx_labeling", "progx_refit")


def _self_times(ops):
    """(start, end, thread, *extra) operations -> (start, thread, self,
    *extra): each one's duration less that of the operations nested in
    it on its thread (a per-thread stack sweep)."""
    by_thread = collections.defaultdict(list)
    for start, end, thread, *extra in ops:
        by_thread[thread].append((start, end, extra))
    out = []
    for thread, evs in by_thread.items():
        evs.sort(key=lambda x: (x[0], -x[1]))
        stack, selfs = [], []
        for start, end, extra in evs:
            while stack and stack[-1][0] <= start:
                stack.pop()
            if stack:
                selfs[stack[-1][1]][2] -= end - start
            selfs.append([start, thread, end - start, extra])
            stack.append((end, len(selfs) - 1))
        out.extend((s, t, max(ns, 0), *extra) for s, t, ns, extra in selfs)
    return out


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _enclosing(queries, spans):
    """For each (time, thread, key) of `queries`, the names of the spans
    (start, end, thread, name) of its thread that hold the time, outermost
    first: {key: [name, ...]}."""
    spans_by = collections.defaultdict(list)
    for start, end, thread, name in spans:
        spans_by[thread].append((start, end, name))
    queries_by = collections.defaultdict(list)
    for t, thread, key in queries:
        queries_by[thread].append((t, key))
    out = {}
    for thread, qs in queries_by.items():
        qs.sort(key=lambda q: q[0])
        sp = sorted(spans_by[thread], key=lambda x: (x[0], -x[1]))
        stack, i = [], 0
        for t, key in qs:
            while i < len(sp) and sp[i][0] <= t:
                stack.append(sp[i])
                i += 1
            stack = [s for s in stack if s[1] > t]
            out[key] = [s[2] for s in stack]
    return out


def op_self_times(trace_dir: str):
    """The newest torch.profiler trace under `trace_dir` (`*.pt.trace.json`
    or `*.pt.trace.json.gz`, as `tensorboard_trace_handler` or
    `export_chrome_trace` writes it) as [(match_text, self_time_us)]. With
    device operations in the trace (kernels, copies, sets), one pair each,
    its duration; else one pair a host operation (`cpu_op`), its duration
    less that of the host operations nested in it on its thread. The text
    is the event's name, then the names of the annotations
    (`record_function` ranges) around it on the host, outermost first: for
    a device operation, those around the call that launched it. [] when
    there is no trace. The annotations are there for a fit that ran
    eagerly: profile it inside core/graphs.eager(), since a replayed CUDA
    graph's operations have no host call around them."""
    traces = [p for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
              for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    if not traces:
        return []
    newest = max(traces, key=lambda p: (os.path.getmtime(p), p))
    with (gzip.open(newest, "rt") if newest.endswith(".gz") else open(newest)) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]

    def track(e):
        return (e.get("pid"), e.get("tid"))

    notes = [(e["ts"], e["ts"] + e.get("dur", 0.0), track(e), e["name"])
             for e in events if e.get("cat") == "user_annotation"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if device:
        # A device operation is launched by the host call of its correlation id.
        launch = {e["args"]["correlation"]: e for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        queries = []
        for i, e in enumerate(device):
            host = launch.get(e.get("args", {}).get("correlation"))
            if host is not None:
                queries.append((host["ts"], track(host), i))
        around = _enclosing(queries, notes)
        return [(" ".join([e["name"], *around.get(i, [])]), float(e.get("dur", 0.0)))
                for i, e in enumerate(device)]
    ops = [(e["ts"], e["ts"] + e.get("dur", 0.0), track(e), i)
           for i, e in enumerate(events) if e.get("cat") == "cpu_op"]
    selfs = _self_times(ops)
    around = _enclosing([(start, thread, i) for start, thread, _, i in selfs], notes)
    return [(" ".join([events[i]["name"], *around[i]]), float(us))
            for _, _, us, i in selfs]


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
    package rounds them. The call runs eagerly (core/graphs.eager), on
    the card too: the scopes are host annotations, which a CUDA graph's
    replay does not make."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from progressivex_tpu_torch.core import graphs

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof, graphs.eager():
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


# --- spans ---------------------------------------------------------------

_profiler_enabled = torch._C._autograd._profiler_enabled
_RECORDINGS: list = []  # the span lists of the open recordings
_RECORDING_LOCK = threading.Lock()
_OPEN = contextvars.ContextVar("progx_open_span", default=None)  # innermost live span
_IDS = itertools.count(1)


class Span:
    """One recorded span. `call` is the id of the outermost span it lies
    in (its entry-point call); `device` is (start_ns, end_ns) on the
    host's perf_counter clock for a replay, else None."""

    __slots__ = ("name", "id", "parent", "call", "thread", "start_ns", "end_ns", "counts",
                 "device")

    def __init__(self, name, id, parent, call, thread, counts):
        self.name, self.id, self.parent, self.call = name, id, parent, call
        self.thread, self.counts = thread, counts
        self.start_ns = self.end_ns = 0
        self.device = None

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, call={self.call}, "
                f"{self.start_ns}-{self.end_ns}, {self.counts}, device={self.device})")


_OFF = contextlib.nullcontext()


class _Live:
    """A span being recorded. The outermost one (the root) holds the
    anchors and the replays' events of everything inside it, and resolves
    them when it closes."""

    __slots__ = ("span", "device", "timed", "root", "token", "range", "events", "pending",
                 "anchors", "lock")

    def __init__(self, name, counts, device=None, timed=False):
        self.span = Span(name, 0, None, 0, 0, counts)
        self.device, self.timed, self.range, self.events = device, timed, None, None

    def __enter__(self):
        s, outer = self.span, _OPEN.get()
        s.id, s.thread = next(_IDS), threading.get_ident()
        if outer is None:
            s.call, self.root = s.id, self
            self.pending, self.anchors, self.lock = [], {}, threading.Lock()
            if self.device is not None and self.device.type == "cuda":
                self._anchor(self.device)
        else:
            s.parent, s.call, self.root = outer.span.id, outer.span.call, outer.root
        self.token = _OPEN.set(self)
        if _profiler_enabled():
            self.range = torch.profiler.record_function(s.name)
            self.range.__enter__()
        s.start_ns = time.perf_counter_ns()
        if self.timed:
            dev = torch.device("cuda", torch.cuda.current_device())
            self.root._anchor(dev)
            self.events = (dev, torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[1].record()
        return s

    def _anchor(self, dev):
        """The root's anchor on `dev`: an event recorded on an idle device
        and the host's clock read beside it."""
        with self.lock:
            if dev not in self.anchors:
                torch.cuda.synchronize(dev)
                event = torch.cuda.Event(enable_timing=True)
                event.record(torch.cuda.current_stream(dev))
                self.anchors[dev] = (event, time.perf_counter_ns())

    def __exit__(self, *exc):
        s = self.span
        if self.events is not None:
            self.events[2].record()
        s.end_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _OPEN.reset(self.token)
        root = self.root
        if self.events is not None:
            with root.lock:
                root.pending.append((s, *self.events))
        if root is self:
            self._resolve()
        with _RECORDING_LOCK:
            for spans in _RECORDINGS:
                spans.append(s)
        return False

    def _resolve(self):
        """Place every replay's events on the host clock, from the anchor
        of its device."""
        for *_, end in self.pending:
            end.synchronize()
        for s, dev, start, end in self.pending:
            anchor, host_ns = self.anchors[dev]
            s.device = (host_ns + round(anchor.elapsed_time(start) * 1e6),
                        host_ns + round(anchor.elapsed_time(end) * 1e6))


def span(name: str, **counts):
    """A span named `name` with `counts` (ints) around the `with` block:
    recorded inside `recording()`, a `record_function` range under the
    profiler, and otherwise a shared no-op."""
    if _RECORDINGS:
        return _Live(name, counts)
    return torch.profiler.record_function(name) if _profiler_enabled() else _OFF


def call(device, **counts):
    """The span of one entry-point call on `device` ("progx.call"). When
    recorded, a CUDA device is synchronized at its start and anchors the
    device intervals of the replays inside it."""
    if _RECORDINGS:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return _Live("progx.call", counts, device=device)
    return torch.profiler.record_function("progx.call") if _profiler_enabled() else _OFF


def replay(name: str):
    """The span of one graph replay on the current CUDA stream: when
    recorded, with CUDA events before and after it."""
    if _RECORDINGS:
        return _Live(name, {}, timed=True)
    return torch.profiler.record_function(name) if _profiler_enabled() else _OFF


@contextlib.contextmanager
def recording():
    """Record every span closed inside, in every thread: yields the list
    the closed spans are appended to (in the order they close). Device
    intervals are filled in when their call returns."""
    spans: list = []
    with _RECORDING_LOCK:
        _RECORDINGS.append(spans)
    try:
        yield spans
    finally:
        with _RECORDING_LOCK:
            _RECORDINGS[:] = [r for r in _RECORDINGS if r is not spans]
