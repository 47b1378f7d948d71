"""The compiled fit (core/graphs.py) on the card: the CUDA graph form of a
fit against its eager form, bit for bit, and a capture that fails.

These tests need a CUDA device and nvcc; elsewhere they skip. They import
neither JAX nor the JAX package:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graphs_cuda.py

- findHomographies (oldclassicswing) and findTwoViewMotions (book, four
  restarts as rows) at the AdelaideRMF protocols' keywords: every tensor of
  the FitResult (descriptors, labels, energy, round log, samples drawn,
  models) and the launch table (kernels/_build.py) the same in the eager form,
  a cold graph call (warm-up, capture, replay) and a warm one.
- A stage that reads a value to the host inside its capture raises, and
  no result comes back from an eager run in its place.
"""

import pytest
import torch

import progressivex_tpu_torch as px
from progressivex_tpu_torch.core import engine, graphs
from progressivex_tpu_torch.eval.adelaide import scene_kwargs
from progressivex_tpu_torch.io.data import load_corr_scene
from progressivex_tpu_torch.kernels import _build


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


def _run(fn, monkeypatch):
    """fn() with the launch counts zeroed: (every FitResult's tensors as
    bytes, LAUNCHES, UNITS)."""
    seen, orig = [], engine.fit_rows

    def keep(*a, **k):
        seen.append(orig(*a, **k))
        return seen[-1]

    for counts in (_build.LAUNCHES, _build.UNITS):
        for k in counts:
            monkeypatch.setitem(counts, k, 0)
    monkeypatch.setattr(engine, "fit_rows", keep)
    try:
        fn()
    finally:
        monkeypatch.setattr(engine, "fit_rows", orig)
    out = []
    for res in seen:
        fields = {}
        for f in res._fields:
            v = getattr(res, f)
            if f == "round_log":
                fields.update({f"round_log.{n}": c.cpu().numpy().tobytes()
                               for n, c in zip(v._fields, v)})
            elif isinstance(v, torch.Tensor):
                fields[f] = v.cpu().numpy().tobytes()
        out.append(fields)
    return out, dict(_build.LAUNCHES), dict(_build.UNITS)


@pytest.mark.cuda
@pytest.mark.parametrize("problem,scene,entry", [
    ("H", "oldclassicswing", px.findHomographies),
    ("F", "book", px.findTwoViewMotions)])
def test_graph_fit_matches_the_eager_fit(cuda, monkeypatch, problem, scene, entry):
    corrs = load_corr_scene(scene)[0]

    def fit():
        entry(corrs, **scene_kwargs(len(corrs), problem), random_seed=0)

    with graphs.eager():
        want = _run(fit, monkeypatch)
    assert sum(want[1].values()) > 0
    cold = _run(fit, monkeypatch)
    warm = _run(fit, monkeypatch)
    assert cold == want
    assert warm == want


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda, monkeypatch):
    corrs = load_corr_scene("oldclassicswing")[0]
    finish = engine.finish

    def reads(*a, **k):
        res = finish(*a, **k)
        res.energy.sum().item()  # a host read, which no capture may hold
        return res

    monkeypatch.setattr(engine, "finish", reads)
    with pytest.raises(Exception):
        px.findHomographies(corrs, **scene_kwargs(len(corrs), "H"), random_seed=0)
