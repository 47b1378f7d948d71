"""Builds the CUDA sources of csrc/ into plain-C shared libraries, and
loads, launches and counts their kernels.

Each source is compiled by `nvcc` for sm_90a into
`<checkout>/build/torch_kernels/<name>-<hash>.so`, where the hash covers
the source, every shared header (csrc/*.cuh) and the flags, and loaded
with ctypes. A library is built at its first use in a process, or by
`build_all`, which starts one `nvcc` per source at once; a lock makes
host threads that first use a library at once (a device mesh) build and
load it once. Nothing here runs when the module is imported.

Every kernel module (scoring.py, threefry.py, linalg.py, pnp.py) routes
through `dispatch` (a CPU tensor takes the plain version, a CUDA tensor
the kernel, any other device raises) and `launch`, which calls the
source's entry point `<name>(..., stream)` with its C argument types, on
the current stream of the tensors' device, whatever the calling thread's
current device. That stream may be capturing a CUDA graph
(core/graphs.py): the launch then becomes a node of the graph. A
non-zero return raises.

The launch table: `LAUNCHES` counts each kernel's launches and `UNITS`
what they covered (rows for the scoring kernels, keys for threefry,
matrices for eigvec_psd, problems for pnp_refine), both incremented
under a lock at the one place a launch happens, so that the counts are
exact when several host threads launch (a device mesh,
parallel/sharding). Inside `recording()` a launch is tallied for the
calling thread instead: a graph's capture records its launches so, and
each replay adds them (`add_counts`), which keeps the counts of a graph
fit equal to those of the same fit run eagerly; the launches of a
graph's warm-up, made only to build it, are recorded and dropped.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from progressivex_tpu_torch._device import device_guard

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = ("score_homography", "score_fundamental", "threefry", "eigvec_psd", "pnp_refine")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()
LAUNCHES = {name: 0 for name in SOURCES}
UNITS = {name: 0 for name in SOURCES}
_COUNT_LOCK = threading.Lock()
_RECORDING = threading.local()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source into a temporary file; None if built."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)
    return out


def build_all() -> dict:
    """Compile every source not yet built, all nvcc processes at once.
    Returns {name: compiler output} for the sources compiled now."""
    with _LOCK:
        jobs = {name: _start(name) for name in SOURCES}
        return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                _finish(name, _start(name))
                lib = _LIBS[name] = ctypes.CDLL(_target(name))
    return lib


def entry_point(name: str, argtypes):
    """The entry point <name> of csrc/<name>.cu, returning an int error
    code, with `argtypes` and the stream declared."""
    fn = getattr(load(name), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int  # before argtypes, which another thread tests
        fn.argtypes = [*argtypes, ctypes.c_void_p]
    return fn


def launch(name: str, dev: torch.device, units: int, argtypes, *args):
    """Call <name>(*args, stream) on `dev`'s current stream and count one
    launch over `units`. The library's CUDA runtime launches on the
    thread's current device, so the guard makes that `dev`. The annotation
    ties the launch to the engine's phase scopes in a profile
    (io/profiling.py); it launches nothing."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    with device_guard(dev), torch.profiler.record_function(name):
        err = entry_point(name, argtypes)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count(name, units)


def dispatch(what: str, dev: torch.device, plain, cuda):
    """`plain` for a CPU device, `cuda` for a CUDA device; any other
    device raises."""
    if dev.type == "cpu":
        return plain
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")
    return cuda


def _count(name: str, units: int):
    """One launch of `name` over `units`, counted, or tallied where the
    calling thread is inside `recording()`."""
    tally = getattr(_RECORDING, "tally", None)
    if tally is not None:
        tally.append((name, units))
        return
    add_counts([(name, units)])


def add_counts(tally):
    """Count the launches of `tally`, [(name, units), ...]."""
    with _COUNT_LOCK:
        for name, units in tally:
            LAUNCHES[name] += 1
            UNITS[name] += units


@contextlib.contextmanager
def recording():
    """Inside, the calling thread's launches are appended to the yielded
    list as (name, units) instead of counted."""
    outer = getattr(_RECORDING, "tally", None)
    _RECORDING.tally = tally = []
    try:
        yield tally
    finally:
        _RECORDING.tally = outer
