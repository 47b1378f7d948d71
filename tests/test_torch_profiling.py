"""io/profiling.op_self_times and io/data.list_scenes of the port against the
JAX package's, on the CPU.

- The same nested events, written as an XLA trace
  (plugins/profile/<run>/<host>.trace.json.gz, an "XLA Ops" thread) for the
  JAX package's op_self_times and as a torch.profiler chrome trace
  (*.pt.trace.json, or .gz) for the port's, give the same self times,
  exactly.
- On a CUDA trace the port returns one pair a device operation, its
  duration, with the names of the annotations around the host call that
  launched it; device-side annotation ranges are not operations.
- On a real CPU profile of a small findLines fit, the port's self times
  total the profiler's own self CPU time of its operations (relative 1e-6:
  the trace writes times to the nanosecond).
- list_scenes equals the JAX package's on data/ and on a root of its own.
"""

import gzip
import json
import os

import jax
import numpy as np
import pytest

from progressivex_tpu.io import data as jdata
from progressivex_tpu.io import profiling as jprofiling

from progressivex_tpu_torch import findLines
from progressivex_tpu_torch.io import data, profiling

# (name, start us, duration us, thread): a nested stack on thread 1 (an
# outer op with two children, one of which has a child, then a sibling
# starting where the outer one ends), and an op on thread 2.
NESTED = (
    ("outer", 10.0, 100.0, 1), ("child_a", 15.0, 30.0, 1), ("grandchild", 20.0, 5.5, 1),
    ("child_b", 60.0, 40.0, 1), ("after", 110.0, 7.25, 1), ("other_thread", 12.0, 50.0, 2),
    ("same_start", 120.0, 3.0, 1), ("inside_same_start", 120.0, 1.0, 1),
)


def _write_xla_trace(root):
    path = os.path.join(root, "plugins", "profile", "run1", "host.trace.json.gz")
    os.makedirs(os.path.dirname(path))
    events = [{"ph": "M", "name": "thread_name", "pid": 7, "tid": t,
               "args": {"name": "XLA Ops"}} for t in (1, 2)]
    events += [{"ph": "X", "pid": 7, "tid": t, "ts": ts, "dur": dur, "name": name,
                "args": {"long_name": name}} for name, ts, dur, t in NESTED]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _write_torch_trace(root, events, name="worker.1.pt.trace.json", compress=False):
    path = os.path.join(root, name + (".gz" if compress else ""))
    with (gzip.open(path, "wt") if compress else open(path, "w")) as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return path


def _cpu_ops(events):
    return [{"ph": "X", "cat": "cpu_op", "pid": 7, "tid": t, "ts": ts, "dur": dur,
             "name": name, "args": {}} for name, ts, dur, t in events]


@pytest.mark.parametrize("compress", [False, True])
def test_self_times_match_jax_on_the_same_events(tmp_path, compress):
    _write_xla_trace(str(tmp_path / "xla"))
    os.makedirs(tmp_path / "torch")
    _write_torch_trace(str(tmp_path / "torch"), _cpu_ops(NESTED), compress=compress)
    want = sorted((text.split()[0], us) for text, us in
                  jprofiling.op_self_times(str(tmp_path / "xla")))
    got = sorted((text.split()[0], us) for text, us in
                 profiling.op_self_times(str(tmp_path / "torch")))
    assert got == want
    assert dict(got)["outer"] == 100.0 - 30.0 - 40.0
    assert dict(got)["child_a"] == 30.0 - 5.5


def test_host_operations_carry_their_annotations(tmp_path):
    events = _cpu_ops(NESTED) + [
        {"ph": "X", "cat": "user_annotation", "pid": 7, "tid": 1, "ts": 5.0, "dur": 200.0,
         "name": "progx_proposal", "args": {}},
        {"ph": "X", "cat": "user_annotation", "pid": 7, "tid": 1, "ts": 59.0, "dur": 42.0,
         "name": "progx_refit", "args": {}}]
    _write_torch_trace(str(tmp_path), events)
    got = dict((text, us) for text, us in profiling.op_self_times(str(tmp_path)))
    assert got["child_b progx_proposal progx_refit"] == 40.0
    assert got["other_thread"] == 50.0
    assert got["outer progx_proposal"] == 30.0


def test_device_operations_carry_their_launch_annotations(tmp_path):
    host = [
        {"ph": "X", "cat": "user_annotation", "pid": 7, "tid": 1, "ts": 0.0, "dur": 100.0,
         "name": "progx_proposal", "args": {}},
        {"ph": "X", "cat": "user_annotation", "pid": 7, "tid": 1, "ts": 10.0, "dur": 20.0,
         "name": "score_homography", "args": {}},
        {"ph": "X", "cat": "cpu_op", "pid": 7, "tid": 1, "ts": 40.0, "dur": 20.0,
         "name": "aten::add", "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "pid": 7, "tid": 1, "ts": 12.0, "dur": 5.0,
         "name": "cudaLaunchKernel", "args": {"correlation": 11}},
        {"ph": "X", "cat": "cuda_runtime", "pid": 7, "tid": 1, "ts": 42.0, "dur": 5.0,
         "name": "cudaLaunchKernel", "args": {"correlation": 12}},
        {"ph": "X", "cat": "cuda_driver", "pid": 7, "tid": 1, "ts": 150.0, "dur": 5.0,
         "name": "cuMemcpyAsync", "args": {"correlation": 13}},
    ]
    device = [
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 20.0, "dur": 3.5,
         "name": "void score_kernel<1, 4>(ScoreArgs)", "args": {"correlation": 11}},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 50.0, "dur": 1.25,
         "name": "vectorized_elementwise_kernel", "args": {"correlation": 12}},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "ts": 160.0, "dur": 2.0,
         "name": "Memcpy DtoH", "args": {"correlation": 13}},
        {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7, "ts": 170.0, "dur": 0.5,
         "name": "Memset", "args": {}},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 8, "ts": 19.0,
         "dur": 40.0, "name": "progx_proposal", "args": {}},
    ]
    _write_torch_trace(str(tmp_path), host + device)
    got = profiling.op_self_times(str(tmp_path))
    assert sorted(got) == sorted([
        ("void score_kernel<1, 4>(ScoreArgs) progx_proposal score_homography", 3.5),
        ("vectorized_elementwise_kernel progx_proposal", 1.25),
        ("Memcpy DtoH", 2.0), ("Memset", 0.5)])


def test_the_newest_trace_is_read(tmp_path):
    old = _write_torch_trace(str(tmp_path), _cpu_ops(NESTED[:1]), "a.1.pt.trace.json")
    os.makedirs(tmp_path / "later")
    new = _write_torch_trace(str(tmp_path / "later"), _cpu_ops(NESTED[4:5]),
                             "b.2.pt.trace.json")
    os.utime(old, (1_000_000, 1_000_000))
    os.utime(new, (2_000_000, 2_000_000))
    assert profiling.op_self_times(str(tmp_path)) == [("after", 7.25)]
    assert profiling.op_self_times(str(tmp_path / "empty")) == []


def test_a_real_cpu_profile_totals_its_self_times(tmp_path):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    r = np.random.default_rng(0)
    t = r.uniform(0, 100, 64)
    pts = np.r_[np.c_[t, 0.5 * t + 5], np.c_[t, -0.3 * t + 60]] + r.normal(scale=0.2,
                                                                         size=(128, 2))
    with profile(activities=[ProfilerActivity.CPU],
                 on_trace_ready=tensorboard_trace_handler(str(tmp_path))) as prof:
        findLines(pts, threshold=1.0, conf=0.95, minimum_point_number=20, max_iters=128,
                  random_seed=0, device="cpu")
    ops = profiling.op_self_times(str(tmp_path))
    want = sum(e.self_cpu_time_total for e in prof.events() if not e.is_user_annotation)
    assert len(ops) > 1000
    assert sum(us for _, us in ops) == pytest.approx(want, rel=1e-6)
    assert any("progx_proposal" in text for text, _ in ops)


def test_list_scenes_matches_jax(tmp_path):
    assert data.list_scenes() == jdata.list_scenes(data.DEFAULT_ROOT)
    assert "unihouse" in data.list_scenes()
    for name in ("b", "a"):
        os.makedirs(tmp_path / name)
        (tmp_path / name / f"{name}.txt").write_text("0 0 1 0 0 1 0\n")
    os.makedirs(tmp_path / "no_file")
    assert data.list_scenes(str(tmp_path)) == jdata.list_scenes(str(tmp_path)) == ["a", "b"]


@pytest.fixture(autouse=True, scope="module")
def _jax_on_cpu():
    jax.config.update("jax_platforms", "cpu")
