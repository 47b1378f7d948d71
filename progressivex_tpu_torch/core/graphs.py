"""CUDA graphs of a fit — the counterpart of the JAX package's compiled
fit, `api._compiled_fit` and `api_batch._compiled_fit_rows`
(progressivex_tpu/api.py:169-177, progressivex_tpu/api_batch.py:46-87),
which make one device program per (family, config, pad level, rows) and
keep it in an lru_cache.

This module only captures and replays. `engine.fit_rows` sequences a
fit's stages, the same for both forms, through a runner that `runner`
picks once a call: on a CUDA device the key's `_Graphs`, which runs each
stage as a graph, captured at the first call of its key and replayed
after; elsewhere `_EagerRunner`, which calls it. The stages:

  prepare   the principal-axis sort, the kNN or grid graph, the adjacency;
  start     the draw of every round's samples from the rows' keys on the
            device (`engine.draw`, the JAX package's threefry keys and
            samplers), the samples as the rounds read them, and the
            first carry;
  propose   a round's first half, up to the PEARL gate (`round_propose`);
  update0   a round's second half, no row running PEARL (`round_update`);
  update1   the same with PEARL on the rows its gate selects;
  finish    split, merge, the polishes, the final relabel, the energy;
  rounds    with cfg.unroll_rounds (`engine.unrolled`): all max_rounds
            rounds, PEARL under its gate, and `finish`, one graph.

Between them the host reads nothing before the rounds, then at most two
values a round (engine.fit_rows).

The key is (family, EngineConfig, the scalar RuntimeParams, the shapes and
types of the data, weights and graph coordinates, the samples' shapes,
device): the JAX key's (family, config, pad level, rows, has_graph) and
the scalars that the JAX program takes as arguments but a graph holds as
constants. The data, mask, weights, graph coordinates, per-row threshold
and n_valid and the rows' keys (or the samples given in their place) are
copied into the key's static buffers at each call. Two bounded LRU caches hold the keys, of the JAX package's
sizes: 64 for `engine.fit` (one scene, restarts as rows) and 32 for every
other caller of `fit_rows`.

A graph is warmed up once on a side stream (lazy initialization, the
kernels' libraries, per-device constants; its kernel launches are not
counted, kernels/_build.py), then captured with
capture_error_mode="thread_local" (a device mesh runs a thread a card,
_device.run_per_device) into the key's memory pool. Every graph writes
its results into buffers allocated outside the pool, so that the order in
which a key's graphs replay does not matter; the results are cloned out.
A capture or replay that fails raises: nothing falls back to the eager
path. A key serves one call at a time (a lock a key), and one capture runs
at a time in the process.

`eager()` runs the fits inside it eagerly on the card: the phase timing
of io/profiling.py needs the per-operation scopes that a replay does not
have. So do replicas on another device (`applies`).

Spans (io/profiling.py): `progx.replay.<stage>` around each
`graph.replay()` (with its device interval when recorded); the reads
between replays open theirs in engine.fit_rows. With no recording and no
profiler on, each is a shared no-op after two flag checks (about 1 us a
`with` block on the CPU): a fit of ten rounds opens about 45 spans in
all, two replays and two reads a round.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import numpy as np
import torch

from progressivex_tpu_torch._device import device_guard
from progressivex_tpu_torch.io import profiling
from progressivex_tpu_torch.kernels import _build

_SIZES = {"fit": 64, "rows": 32}
_CACHES = {name: collections.OrderedDict() for name in _SIZES}
_LOCK = threading.Lock()  # the caches and the eager depth
_CAPTURE_LOCK = threading.Lock()
_STREAMS: dict = {}  # device -> the side stream of warm-ups and captures
_EAGER = [0]
# Graphs built since the last reset, with the seconds of their warm-ups
# (the eager run before a capture) and captures.
BUILDS = {"graphs": 0, "warmup_s": 0.0, "capture_s": 0.0}


@contextlib.contextmanager
def eager():
    """Inside, every fit runs its stages eagerly, on the card too (the
    whole process: a device mesh's threads see it)."""
    with _LOCK:
        _EAGER[0] += 1
    try:
        yield
    finally:
        with _LOCK:
            _EAGER[0] -= 1


def _same_device(d, dev: torch.device) -> bool:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d == dev


def applies(dev: torch.device, hyp_devices=None) -> bool:
    """Whether a fit on `dev` runs as graphs: a CUDA device, outside
    `eager()`, with every hypothesis replica on `dev` (replicas on other
    devices run the eager round)."""
    return (dev.type == "cuda" and _EAGER[0] == 0
            and (hyp_devices is None or all(_same_device(d, dev) for d in hyp_devices)))


def clear():
    """Drop every cached key, its graphs and buffers."""
    with _LOCK:
        for lru in _CACHES.values():
            lru.clear()


def _leaves(tree):
    """The tensors of a nest of tuples and NamedTuples, in order (None
    and other values hold none)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


def _map(fn, tree):
    """The nest with fn applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        items = [_map(fn, t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


def _write(outs, vals):
    """Copy the tensors of `vals` into those of `outs` (the same nest). A
    value that shares storage with an output is cloned first, so that no
    copy reads what an earlier one wrote."""
    outs, vals = _leaves(outs), _leaves(vals)
    if len(outs) != len(vals):
        raise ValueError(f"{len(vals)} results for {len(outs)} buffers")
    ptrs = {o.untyped_storage().data_ptr() for o in outs}
    vals = [v.clone() if v.untyped_storage().data_ptr() in ptrs else v for v in vals]
    for o, v in zip(outs, vals):
        o.copy_(v)


def _stream(dev: torch.device) -> torch.cuda.Stream:
    stream = _STREAMS.get(dev)
    if stream is None:
        stream = _STREAMS[dev] = torch.cuda.Stream(device=dev)
    return stream


class _Graphs:
    """One key's static buffers and graphs, on `dev`: the graph form of
    `engine.fit_rows`' stages (see `runner`)."""

    captures = True

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.lock = threading.Lock()
        self.pool = None  # the memory pool of the key's graphs, made at the first capture
        self.graphs: dict = {}  # name -> (CUDAGraph, recorded launches)
        self.outs: dict = {}  # name -> its output buffers
        self.inputs: dict = {}  # name -> a static input buffer

    def stage(self, name, fn, outs=None):
        """Replay graph `name`, capturing fn() at its first use into
        `outs(warm)` (buffers for fn's results, given the warm-up's) or
        into new buffers of the results' shapes. Counts the graph's kernel
        launches and returns its output buffers."""
        if name not in self.graphs:
            self._capture(name, fn, outs)
        graph, tally = self.graphs[name]
        with profiling.replay(f"progx.replay.{name}"):
            graph.replay()
        _build.add_counts(tally)
        return self.outs[name]

    def _capture(self, name, fn, outs):
        dev = self.dev
        with _CAPTURE_LOCK:
            stream = _stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            t0 = time.perf_counter()
            with torch.cuda.stream(stream), _build.recording():
                warm = fn()
            bufs = _map(torch.empty_like, warm) if outs is None else outs(warm)
            del warm
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with _build.recording() as tally, torch.cuda.stream(stream):
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    _write(bufs, fn())
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(stream)
            t2 = time.perf_counter()
            BUILDS["graphs"] += 1
            BUILDS["warmup_s"] += t1 - t0
            BUILDS["capture_s"] += t2 - t1
        self.graphs[name] = (graph, tuple(tally))
        self.outs[name] = bufs

    def static(self, name, src, dtype=None):
        """The static input buffer `name`, holding a copy of `src` (None
        stays None)."""
        if src is None:
            return None
        buf = self.inputs.get(name)
        if buf is None:
            buf = self.inputs[name] = torch.empty(
                src.shape, dtype=src.dtype if dtype is None else dtype, device=self.dev)
        buf.copy_(src)
        return buf

    def result(self, tree):
        """A stage's results cloned out of its buffers."""
        return _map(torch.clone, tree)


def _key(family, cfg, params, data, point_weights, graph_data, keys, presampled):
    scalars = tuple(np.asarray(v).item() for f, v in params._asdict().items()
                    if f not in ("threshold", "n_valid"))
    if presampled is not None:
        samples = tuple(tuple(t.shape) for t in presampled)
    else:
        samples = ("keys", tuple(keys.shape))
    return (family.name, cfg, scalars, tuple(data.shape), data.dtype,
            point_weights.dtype,
            None if graph_data is None else (tuple(graph_data.shape), graph_data.dtype),
            samples, data.device)


def _entry(cache: str, key, dev: torch.device) -> _Graphs:
    with _LOCK:
        lru = _CACHES[cache]
        entry = lru.get(key)
        if entry is None:
            entry = lru[key] = _Graphs(dev)
            while len(lru) > _SIZES[cache]:
                lru.popitem(last=False)
        else:
            lru.move_to_end(key)
        return entry


class _EagerRunner:
    """The eager form of `engine.fit_rows`' stages: each runs as it is
    called, on its inputs as given, and its results are handed back as
    they are."""

    captures = False

    def stage(self, name, fn, outs=None):
        return fn()

    def static(self, name, src, dtype=None):
        return src

    def result(self, tree):
        return tree


_EAGER_RUNNER = _EagerRunner()


@contextlib.contextmanager
def runner(family, cfg, params, data, point_weights, graph_data, keys, presampled,
           hyp_devices=None, cache="rows"):
    """The runner of one `engine.fit_rows` call on `data`'s device: the
    eager form unless `applies`, else the key's `_Graphs` (`params` with
    its per-row tensors, `keys` the rows' keys on the device, or None with
    `presampled`), held under its lock, with the device current, for the
    whole call. A runner has `stage(name, fn, outs=None)`, `static(name,
    src, dtype=None)` (an input in the key's static buffer) and
    `result(tree)`; `captures` says whether its stages are graphs."""
    dev = data.device
    if not applies(dev, hyp_devices):
        yield _EAGER_RUNNER
        return
    key = _key(family, cfg, params, data, point_weights, graph_data, keys, presampled)
    entry = _entry(cache, key, dev)
    with device_guard(dev), entry.lock:
        yield entry
