"""A census of the operations that one eager call of the port launches,
on the CPU: every aten operation that would launch a kernel on the card
(views, allocations without data and host reads left out), with the
elements it writes, tagged by the engine stage it runs in and by named
functions it runs under.

  python3 tools/op_census.py --workload tless6d-single [--seed S] [--index I]
      [--function NAME ...] [--set KEY=VALUE ...] [--top K] [--out FILE]

The call is the benchmark cell's own: request I of seed S
(`bench_port.harness.make_request`), served by `harness.calls_of` under
the cell's protocol on the CPU, where the engine's stages run eagerly;
`--set` overrides a protocol keyword (e.g. `--set n_restarts=1` for a
quicker look). A stage is the innermost of core/engine.STAGES' functions
on the Python stack when the operation runs ("other" outside them: the
entry point's inputs and results). A `--function` is a function's
qualified name (`_refine`), optionally after the tail of its file's path
(`models/pnp.py:_refine`); an operation counts under it when the function
is on the stack, and its calls are counted as they start
(`sys.monitoring`). The default is `_refine`, the families' refits.

On the card the same operations run in CUDA graphs, about a microsecond
a node (PERF.md §5), so the counts say where a fit's small kernels come
from, which a device trace of a replay does not tag. A kernel of the
port's own (csrc/) is one operation here only where its plain version is
one. Prints a summary and one JSON line (also written to `--out`).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

# The engine's stage functions (core/engine.py), as the graphs split a fit.
STAGES = ("prepare", "draw", "start", "round_propose", "round_update", "finish")
# Operations that launch nothing: allocations, reads of one element to
# the host, and metadata changes.
NO_LAUNCH = ("empty", "empty_like", "empty_strided", "_local_scalar_dense", "resize_",
             "set_", "lift_fresh", "sym_size", "sym_stride", "sym_numel",
             "sym_storage_offset")
_TOOL_ID = 4  # a free sys.monitoring tool id (0-2 and 5 are taken by convention)


def _match(code, spec):
    path, _, name = spec.rpartition(":")
    return (getattr(code, "co_qualname", code.co_name) == name
            and (not path or code.co_filename.replace(os.sep, "/").endswith(path)))


def _functions_named(specs):
    """{spec: set of code objects} of the loaded port functions (module
    level and class attributes) that `spec` names."""
    found = {spec: set() for spec in specs}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("progressivex_tpu_torch") or mod is None:
            continue
        for obj in list(vars(mod).values()):
            members = [obj] + (list(vars(obj).values()) if isinstance(obj, type) else [])
            for fn in members:
                code = getattr(getattr(fn, "__wrapped__", fn), "__code__", None)
                if code is None:
                    continue
                for spec in specs:
                    if _match(code, spec):
                        found[spec].add(code)
    return found


class _Counter(TorchDispatchMode):
    """Counts each launching operation with its output elements, under
    its stage and under every named function on the stack."""

    def __init__(self, stage_codes, function_codes):
        super().__init__()
        self.stage_codes = stage_codes  # code -> stage name
        self.function_codes = function_codes  # code -> specs
        self.tags = {}  # code -> (stage or None, specs), cached
        self.rows = collections.Counter()  # (stage, spec or "", op) -> ops
        self.elements = collections.Counter()

    def _tag(self, code):
        tag = self.tags.get(code)
        if tag is None:
            tag = self.tags[code] = (self.stage_codes.get(code),
                                     self.function_codes.get(code, ()))
        return tag

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in NO_LAUNCH:
            return out
        stage, inside = None, set()
        frame = sys._getframe(1)
        while frame is not None:
            st, specs = self._tag(frame.f_code)
            inside.update(specs)
            if stage is None and st is not None:
                stage = st
            frame = frame.f_back
        n = sum(t.numel() for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        name = str(func.overloadpacket)
        for spec in ("", *inside):
            key = (stage or "other", spec, name)
            self.rows[key] += 1
            self.elements[key] += n
        return out


def census(fn, functions=("_refine",), top=15):
    """Run fn() eagerly under the counter. Returns {"ops", "elements",
    "by_stage": {stage: [ops, elements]}, "functions": {spec: {"calls",
    "ops", "elements", "by_stage"}}, "top_ops": [[op, ops, elements]]}."""
    from progressivex_tpu_torch.core import engine

    stage_codes = {getattr(engine, s).__code__: s for s in STAGES}
    named = _functions_named(functions)
    function_codes = collections.defaultdict(tuple)
    for spec, codes in named.items():
        for code in codes:
            function_codes[code] += (spec,)
    calls = collections.Counter()
    mon = sys.monitoring
    mon.use_tool_id(_TOOL_ID, "op_census")
    try:
        mon.register_callback(_TOOL_ID, mon.events.PY_START,
                              lambda code, offset: calls.update(function_codes[code]))
        for code in function_codes:
            mon.set_local_events(_TOOL_ID, code, mon.events.PY_START)
        counter = _Counter(stage_codes, dict(function_codes))
        with counter:
            fn()
    finally:
        for code in function_codes:
            mon.set_local_events(_TOOL_ID, code, 0)
        mon.register_callback(_TOOL_ID, mon.events.PY_START, None)
        mon.free_tool_id(_TOOL_ID)

    def summary(spec):
        by_stage = collections.defaultdict(lambda: [0, 0])
        ops = elements = 0
        for key, n in counter.rows.items():
            if key[1] == spec:
                by_stage[key[0]][0] += n
                by_stage[key[0]][1] += counter.elements[key]
                ops += n
                elements += counter.elements[key]
        return ops, elements, dict(sorted(by_stage.items()))

    ops, elements, by_stage = summary("")
    per_op = collections.defaultdict(lambda: [0, 0])
    for (stage, s, op), n in counter.rows.items():
        if s == "":
            per_op[op][0] += n
            per_op[op][1] += counter.elements[(stage, s, op)]
    out = {"ops": ops, "elements": elements, "by_stage": by_stage, "functions": {},
           "top_ops": sorted(([op, *v] for op, v in per_op.items()),
                             key=lambda r: -r[1])[:top]}
    for spec in functions:
        f_ops, f_el, f_stage = summary(spec)
        out["functions"][spec] = {"calls": calls[spec], "ops": f_ops, "elements": f_el,
                                  "by_stage": f_stage, "found": len(named[spec])}
    return out


def cell_census(workload, seed, index=0, functions=("_refine",), protocol=None, top=15):
    """`census` of request `index` of `seed` in the benchmark cell
    `workload`, served on the CPU, with `protocol` keywords overriding the
    cell's."""
    import progressivex_tpu_torch
    from bench_port import harness

    cell = harness.load_cell(workload)
    if protocol:
        cell = cell._replace(config=dict(cell.config, protocol=dict(
            cell.config["protocol"], **protocol)))
    request = harness.make_request(cell, seed, index)
    calls = harness.calls_of(cell, progressivex_tpu_torch, request, "cpu")

    def run():
        for call in calls:
            call.run()

    t0 = time.perf_counter()
    out = census(run, functions, top)
    out.update({"workload": workload, "seed": seed, "index": index,
                "protocol": dict(cell.config["protocol"]),
                "calls": [c.label for c in calls], "host_s": time.perf_counter() - t0,
                "device": "cpu"})
    return out


def _value(text):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**33 + 5)
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--function", action="append", dest="functions")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    protocol = {k: _value(v) for k, _, v in (s.partition("=") for s in args.set)}
    res = cell_census(args.workload, args.seed, args.index,
                      tuple(args.functions or ("_refine",)), protocol, args.top)
    print(f"{args.workload} seed {args.seed} request {args.index} on the CPU: "
          f"{res['ops']} ops, {res['elements']:.4g} output elements, "
          f"{res['host_s']:.1f} s")
    for stage, (n, e) in res["by_stage"].items():
        print(f"  {stage:14s} {n:8d} ops {e:12.4g} elements")
    for spec, f in res["functions"].items():
        share = f["ops"] / max(res["ops"], 1)
        print(f"  under {spec}: {f['calls']} calls, {f['ops']} ops ({share:.1%}), "
              f"{f['elements']:.4g} elements; by stage {f['by_stage']}")
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
