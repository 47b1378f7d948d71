"""CUDA graphs of a fit — the counterpart of the JAX package's compiled
fit, `api._compiled_fit` and `api_batch._compiled_fit_rows`
(progressivex_tpu/api.py:169-177, progressivex_tpu/api_batch.py:46-87),
which make one device program per (family, config, pad level, rows) and
keep it in an lru_cache.

A fit on a CUDA device (`engine.fit_rows`) runs its stages as graphs,
each captured at the first call of its key and replayed after:

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
values a round: `any_pearl` between the halves, so that a round in which no row
runs PEARL skips its work, and `all_done` at the round's end (the JAX
while_loop's condition). A live-progress fit reads the round's statistics
there too.

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
counted, kernels/scoring.py), then captured with
capture_error_mode="thread_local" (a device mesh runs a thread a card,
_device.run_per_device) into the key's memory pool. Every graph writes
its results into buffers allocated outside the pool, so that the order in
which a key's graphs replay does not matter; the results are cloned out.
A capture or replay that fails raises: nothing falls back to the eager
path. A key serves one call at a time (a lock a key), and one capture runs
at a time in the process.

`eager()` runs the fits inside it eagerly on the card: the phase timing
of io/profiling.py needs the per-operation scopes that a replay does not
have.

Spans (io/profiling.py): `progx.replay.<stage>` around each
`graph.replay()` (with its device interval when recorded), and `progx.read.any_pearl`,
`progx.read.all_done` and `progx.read.progress` around the host reads
between replays. With no recording and no profiler on, each is a shared
no-op after two flag checks (about 1 us a `with` block on the CPU): a
fit of ten rounds opens about 45 spans in all, two replays and two
reads a round.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import numpy as np
import torch

from progressivex_tpu_torch._device import device_guard
from progressivex_tpu_torch.core import engine
from progressivex_tpu_torch.io import profiling
from progressivex_tpu_torch.kernels import scoring

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
    """One key's static buffers and graphs, on `dev`."""

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
        scoring.add_counts(tally)
        return self.outs[name]

    def _capture(self, name, fn, outs):
        dev = self.dev
        with _CAPTURE_LOCK:
            stream = _stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            t0 = time.perf_counter()
            with torch.cuda.stream(stream), scoring.recording():
                warm = fn()
            bufs = _map(torch.empty_like, warm) if outs is None else outs(warm)
            del warm
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with scoring.recording() as tally, torch.cuda.stream(stream):
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

    def _static(self, name, src, dtype=None):
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

    def fit(self, family, cfg, params, data, point_mask, point_weights, keys,
            presampled, graph_data):
        """`engine.fit_rows`' stages as this key's graphs, on this call's
        inputs; returns the FitResult's tensors cloned out of the
        buffers."""
        p = params._replace(threshold=self._static("threshold", params.threshold),
                            n_valid=self._static("n_valid", params.n_valid))
        data, mask, weights, gd = (self._static(k, t) for k, t in (
            ("data", data), ("mask", point_mask), ("weights", point_weights),
            ("graph", graph_data)))
        prep = self.stage("prepare", lambda: engine.prepare(cfg, p, data, mask, weights, gd))
        if presampled is not None:
            raw = tuple(self._static(f"samples{i}", torch.as_tensor(t), dtype)
                        for i, (t, dtype) in enumerate(zip(presampled,
                                                           (torch.int64, torch.bool) * 2)))

            def sampled():
                return raw
        else:
            k = self._static("keys", keys)

            def sampled():
                return engine.draw(family, cfg, p.n_valid, k, prep)

        samples, carry = self.stage(
            "start", lambda: engine.start(family, cfg, prep.data, prep.rank, sampled()))
        moves = (family, cfg, p, prep.data, prep.point_mask, prep.point_weights, prep.adj)

        def propose():
            return engine._make_propose(*moves, samples)

        if engine.unrolled(cfg):
            def whole():
                c, prop_fn = carry, propose()
                for _ in range(cfg.max_rounds):
                    c = engine.round_update(*moves, c, engine.round_propose(*moves, prop_fn, c),
                                            True)[0]
                return engine.finish(*moves, prep.rank, c)

            return _map(torch.clone, self.stage("rounds", whole))

        def update_outs(warm):
            return (carry, *_map(torch.empty_like, warm[1:]))

        for _ in range(cfg.max_rounds):
            prop = self.stage("propose",
                              lambda: engine.round_propose(*moves, propose(), carry))
            with profiling.span("progx.read.any_pearl"):
                pearl = bool(prop.any_pearl)
            _, progress, all_done = self.stage(
                f"update{int(pearl)}",
                lambda pearl=pearl: engine.round_update(*moves, carry, prop, pearl),
                update_outs)
            if cfg.live_progress:
                with profiling.span("progx.read.progress"):
                    engine._emit_progress(*progress)
            with profiling.span("progx.read.all_done"):
                done = bool(all_done)
            if done:
                break
        return _map(torch.clone, self.stage(
            "finish", lambda: engine.finish(*moves, prep.rank, carry)))


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


def fit_rows(family, cfg, params, data, point_mask, point_weights, keys, presampled,
             graph_data, cache="rows") -> engine.FitResult:
    """`engine.fit_rows` on a CUDA device as graphs (`params` with its
    per-row tensors, `keys` the rows' keys on the device, or None with
    `presampled`); the FitResult's tensors are the graphs' results,
    cloned."""
    dev = data.device
    key = _key(family, cfg, params, data, point_weights, graph_data, keys, presampled)
    entry = _entry(cache, key, dev)
    with device_guard(dev), entry.lock:
        return entry.fit(family, cfg, params, data, point_mask, point_weights,
                         keys, presampled, graph_data)
