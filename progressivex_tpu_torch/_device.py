"""Device resolution for the port's entry points, and work on several
devices at once.

The port runs on the CUDA device. The CPU is used only when a caller asks
for it by name (the parity tests do); there is no silent fallback.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device. Raises when CUDA is asked for (or
    implied) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def device_guard(dev: torch.device):
    """A context that makes `dev` the calling thread's current CUDA device
    (a new thread starts on device 0); nothing for a CPU device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _guarded(dev, fn, args):
    with device_guard(dev):
        return fn(*args)


def run_per_device(fn, jobs):
    """fn(*args) for every (device, args) of `jobs`, each with its device
    current, one host thread a job when there are several, so that
    several cards are fed at once. Returns the results in the order of
    `jobs`; every job runs to its end, and the first exception is raised
    here once all have."""
    if len(jobs) == 1:
        (dev, args), = jobs
        return [_guarded(dev, fn, args)]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(_guarded, dev, fn, args) for dev, args in jobs]
    return [f.result() for f in futures]
