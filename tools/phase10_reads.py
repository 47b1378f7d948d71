"""Phase 10 of `chip_smoke.py` (the compiled fit against the eager fit)
in the checkout of the current directory, plus a count of the host reads
of one warm graph fit of each path (chip_smoke.py's `_host_reads`):
before its rounds (from `engine.fit_rows`' call to its first round
graph), in its rounds and after. A host read is a call of torch.Tensor's
__bool__, __int__, __float__, __index__, item, tolist, cpu or numpy on a
CUDA tensor.

  cd <checkout> && python3 <path to>/tools/phase10_reads.py

It needs a CUDA device. To compare two commits on one card, unpack the
other into a git-ignored directory (`git archive <commit> | tar -x -C
build/parent`) and run this file from each checkout in turns, in one
command: parent, change, change, parent. Prints the nvidia-smi line,
phase 10's seconds and one "p10" JSON line a path.
"""
import importlib.util
import json
import os
import sys
import time

import torch

root = os.getcwd()
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from progressivex_tpu_torch.kernels import _build

print(cs._smi(), flush=True)
_build.build_all()
t0 = time.perf_counter()
res = cs.phase_compiled_fit(torch)
print("phase 10 s", time.perf_counter() - t0, flush=True)
reads = {}
for label, call in cs._compiled_paths():
    call()
    torch.cuda.synchronize()
    reads[label] = cs._host_reads(torch, call)
for row in res["paths"]:
    out = {k: row.get(k) for k in ("path", "eager_s", "cold_s", "warmup_s", "capture_s",
                                    "warm_s", "graphs", "round_passes",
                                    "host_reads_per_round", "reserved_eager_bytes",
                                    "reserved_graph_bytes", "busy_share_warm", "launches")}
    out["host_reads"] = reads.get(row["path"])
    print("p10", json.dumps(out), flush=True)
