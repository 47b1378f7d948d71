"""The port's spans (io/profiling.py `span`, `call`, `replay`,
`recording`) and the benchmark's readers of them (bench_port/recorder.py,
bench_port/metrics/).

On the CPU: with no recording and no profiler nothing is recorded and no
`record_function` is entered; a recorded call's spans nest and share its
id; a batched call's `progx.inputs` counts its filler lanes apart; a mesh's
shard threads record under the call's id; the profiler sees the names;
results do not change; the recorder keeps every span of many threads;
each reader's value from a span list built by hand. The `cuda` test
(skips here) holds a graph fit's replays and reads to its round count,
its replays' device intervals to one order, and its outputs with the
recorder on to those with it off, bit for bit:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py
"""

import sys
import threading

import numpy as np
import pytest
import torch

import progressivex_tpu_torch as px
from progressivex_tpu_torch.io import profiling
from progressivex_tpu_torch.io.profiling import Span

from bench_port import recorder
from bench_port.metrics import (finish_ms_per_scene, host_ms_per_scene, lane_fill_pct,
                                read_idle_ms_per_round, round_ms_per_scene)

KW = dict(max_iters=100, max_rounds=3, random_seed=1, device="cpu")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(seed, n=100):
    """Two planes of 40 correspondences each and n - 80 outliers."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(2):
        h = np.eye(3) + rng.normal(0, 0.05, (3, 3))
        h[2, :2] *= 0.01
        x = rng.uniform(0, 500, (40, 2))
        y = np.c_[x, np.ones(40)] @ h.T
        parts.append(np.c_[x, y[:, :2] / y[:, 2:]])
    parts.append(rng.uniform(0, 500, (n - 80, 4)))
    return np.concatenate(parts)


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered, lives = [], []
    original, live = torch.profiler.record_function, profiling._Live

    def counting(name, *a, **k):
        entered.append(name)
        return original(name, *a, **k)

    def counting_live(*a, **k):
        lives.append(a[0])
        return live(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(profiling, "_Live", counting_live)
    px.findHomographies(_scene(0), **KW)
    assert not [n for n in entered if n.startswith("progx.")]
    assert lives == []
    assert profiling.span("progx.inputs") is profiling.span("progx.fit", rows=1)


def test_a_recorded_call_nests_under_one_id():
    with profiling.recording() as spans:
        px.findHomographies(_scene(0), **KW)
    call, = _by_name(spans, "progx.call")
    assert call.parent is None and call.call == call.id and call.counts == {"scenes": 1}
    names = [s.name for s in sorted(spans, key=lambda s: s.start_ns)]
    assert names[:3] == ["progx.call", "progx.inputs", "progx.fit"]
    # an eager fit (the CPU) reads to the host where a graph fit does
    assert set(names) == {"progx.call", "progx.inputs", "progx.fit", "progx.read.any_pearl",
                          "progx.read.all_done", "progx.results"}
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.call == call.id and s.thread == call.thread and s.device is None
        assert s.start_ns <= s.end_ns
        if s is not call:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    fit, = _by_name(spans, "progx.fit")
    assert fit.parent == call.id and fit.counts == {}
    assert all(s.parent == fit.id for s in spans if s.name.startswith("progx.read."))
    assert _by_name(spans, "progx.inputs")[0].counts == {}


def test_results_equal_with_the_recorder_on_and_off():
    off = px.findHomographies(_scene(2), **KW)
    with profiling.recording() as spans:
        on = px.findHomographies(_scene(2), **KW)
    assert spans
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def test_batched_fit_counts_filler_lanes_apart():
    with profiling.recording() as spans:
        px.findHomographiesBatched([_scene(s) for s in range(5)], **KW)
    call, = _by_name(spans, "progx.call")
    assert call.counts == {"scenes": 5}
    inputs, = _by_name(spans, "progx.inputs")
    assert inputs.counts == {"rows": 8, "real_rows": 5}
    assert len(_by_name(spans, "progx.fit")) == len(_by_name(spans, "progx.results")) == 1
    assert lane_fill_pct.value(spans) == pytest.approx(62.5)


def test_shard_threads_record_under_the_call():
    from progressivex_tpu_torch.parallel.sharding import make_mesh

    with profiling.recording() as spans:
        px.findHomographiesBatched([_scene(s) for s in range(5)], **KW,
                                   mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    call, = _by_name(spans, "progx.call")
    fits = _by_name(spans, "progx.fit")
    assert len(fits) == 2 and {f.thread for f in fits} != {call.thread}
    assert all(f.call == call.id and f.parent == call.id for f in fits)
    inputs, = _by_name(spans, "progx.inputs")
    assert inputs.counts == {"rows": 8, "real_rows": 5} and inputs.thread == call.thread


def test_profiler_sees_the_span_names():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        px.findHomographies(_scene(0), **KW)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"progx.call", "progx.inputs", "progx.fit", "progx.results"} <= names


def test_recorder_keeps_every_span_of_many_threads():
    """More threads than cores, a short switch interval: every span is
    kept once, under its own thread's root."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as spans:
            def work(k):
                with profiling.span("progx.call", scenes=k):
                    for _ in range(50):
                        with profiling.span("progx.inputs"):
                            pass

            threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(spans) == 16 * 51 and len({s.id for s in spans}) == len(spans)
    roots = {s.id: s for s in _by_name(spans, "progx.call")}
    for s in _by_name(spans, "progx.inputs"):
        assert s.parent == s.call and roots[s.call].thread == s.thread


# --- the benchmark's readers, on a call built by hand ------------------------

MS = 1_000_000


def _span(name, id, parent, start, end, device=None, **counts):
    s = Span(name, id, parent, 1, 7, counts)
    s.start_ns, s.end_ns = start * MS, end * MS
    s.device = None if device is None else (device[0] * MS, device[1] * MS)
    return s


def _hand_call():
    """One call of 4 scenes, 100 ms: inputs 0-8, a fit 8-90 with a round
    (propose, any_pearl, update0, all_done) between prepare/start and
    finish, which runs on the device until 93, results 90-99."""
    return [
        _span("progx.call", 1, None, 0, 100, scenes=4),
        _span("progx.inputs", 2, 1, 0, 8, rows=8, real_rows=5),
        _span("progx.fit", 3, 1, 8, 90),
        _span("progx.replay.prepare", 4, 3, 9, 10, device=(10, 20)),
        _span("progx.replay.start", 5, 3, 10, 11, device=(20, 25)),
        _span("progx.replay.propose", 6, 3, 11, 12, device=(30, 40)),
        _span("progx.read.any_pearl", 7, 3, 12, 41),
        _span("progx.replay.update0", 8, 3, 42, 43, device=(45, 50)),
        _span("progx.read.all_done", 9, 3, 43, 51),
        _span("progx.replay.finish", 10, 3, 55, 56, device=(60, 93)),
        _span("progx.results", 11, 1, 90, 99),
    ]


def test_readers_on_a_call_built_by_hand(monkeypatch):
    spans = _hand_call()
    split = recorder.split(spans[0], spans)
    assert split == {"gap.entry": 10 * MS, "replay.prepare": 10 * MS, "replay.start": 5 * MS,
                     "gap.between replays": 5 * MS, "replay.propose": 10 * MS,
                     "gap.read.any_pearl": 5 * MS, "replay.update0": 5 * MS,
                     "gap.read.all_done": 10 * MS, "replay.finish": 33 * MS,
                     "gap.after": 7 * MS}
    assert sum(split.values()) == 100 * MS
    want = {host_ms_per_scene: (100 - 82 - 3) / 4, lane_fill_pct: 62.5,
            read_idle_ms_per_round: 15.0, round_ms_per_scene: 15 / 4, finish_ms_per_scene: 33 / 4}
    readings = object()
    for reader, value in want.items():
        monkeypatch.setattr(recorder, "spans", lambda r: spans)
        assert reader.read(readings) == pytest.approx(value)
        monkeypatch.setattr(recorder, "spans", lambda r: None)
        assert reader.read(readings) is None
    eager = [s for s in spans if not s.name.startswith("progx.replay.")]
    for reader in (read_idle_ms_per_round, round_ms_per_scene, finish_ms_per_scene):
        assert reader.value(eager) is None


def test_no_part_without_a_seed_on_the_command_line(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "adelH-single"])

    class Window:
        traced_requests = 1
        latencies = [0.1, 0.1]

    class Readings:
        window = Window()
        cell = None

    assert recorder.spans(Readings()) is None


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from progressivex_tpu_torch.core import graphs

    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


@pytest.mark.cuda
def test_graph_fit_replays_and_reads(cuda):
    from progressivex_tpu_torch.eval.adelaide import scene_kwargs
    from progressivex_tpu_torch.io.data import load_corr_scene

    corrs = load_corr_scene("oldclassicswing")[0]
    kw = dict(scene_kwargs(len(corrs), "H"), random_seed=0, with_statistics=True)
    px.findHomographies(corrs, **kw)  # warm: every graph of the key captured
    off = px.findHomographies(corrs, **kw)
    with profiling.recording() as spans:
        on = px.findHomographies(corrs, **kw)
    rounds = on[2].rounds_run
    assert rounds == off[2].rounds_run > 0
    for a, b in zip(off[:2], on[:2]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    call, = _by_name(spans, "progx.call")
    assert all(s.call == call.id for s in spans)
    assert len(_by_name(spans, "progx.replay.propose")) == rounds
    assert len(_by_name(spans, "progx.read.any_pearl")) == rounds
    assert len(_by_name(spans, "progx.read.all_done")) == rounds
    replays = sorted((s for s in spans if s.name.startswith("progx.replay.")),
                     key=lambda s: s.start_ns)
    assert len(replays) == 2 * rounds + 3
    for a, b in zip(replays, replays[1:]):
        assert a.device[0] <= a.device[1] <= b.device[0] <= b.device[1]
    assert call.start_ns <= replays[0].device[0] and replays[-1].device[1] <= call.end_ns
    assert sum(recorder.split(call, spans).values()) == call.end_ns - call.start_ns
