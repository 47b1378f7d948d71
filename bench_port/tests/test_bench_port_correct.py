"""The check that decides `correct`, driven end to end on the CPU at a
size a test run holds: the harness's look for a card is skipped
(harness.run_cell with device "cpu"), the port fits a few scenes of each
cell's shapes, and the plain reference judges them. A sound run comes
out correct; the control in the program's place, and each fault a cell
can have planted under the timed path, come out not correct.

  python -m pytest bench_port/tests -q -p no:cacheprovider
"""

import os
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import harness, reference  # noqa: E402

# A few shapes of each cell, one draw each: a size the CPU fits in seconds.
SHAPES = {"adelH-pass": ("physics", "hartley", "johnssona"),
          "adelF-pass": ("book", "breadcube"),
          "adelH-single": ("physics", "hartley", "johnssona"),
          "adelF-single": ("book", "breadcube")}
SEED = 2**31 + 77
PAD_LEVELS = harness.load_cell("adelH-pass").config["pad_levels"]
# Window seconds that serve every shape once on the CPU (a single-scene
# fit takes about 0.6 s there, 2 s with F's 4 restarts; a batched request
# holds every shape).
SECONDS = {"adelH-pass": 0.0, "adelF-pass": 0.0, "adelH-single": 1.5, "adelF-single": 3.0}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small(name):
    cell = harness.load_cell(name)
    cfg = dict(cell.config, specs=[s for s in cell.config["specs"] if s[0] in SHAPES[name]])
    traffic = dict(cell.traffic, copies=1, pool_requests=len(cfg["specs"]), warm_passes=1,
                   settle_seconds=0)
    return cell._replace(config=cfg, traffic=traffic)


def run(cell, program=None, seconds=0.0):
    import progressivex_tpu_torch

    return harness.run_cell(cell, SEED, seconds, False, "cpu",
                            program=program or progressivex_tpu_torch)[0]


def _shifted(models, labels):
    """The answer with every label moved to the next class (outliers to
    the first model)."""
    return models, (labels + 1) % (len(models) // 3 + 1)


def _empty(models, labels):
    """The answer as the fit started: no model, every point an outlier."""
    return np.zeros((0, 3)), np.zeros_like(labels)


class Broken:
    """The port with a fault planted where its answers are produced.
    "altered_one" alters the answer numbered `nth` among all it produces
    (the warm-up's answers come first); "emptied_level" empties the
    answers of scenes padded to `pad` points."""

    def __init__(self, fault, nth=0, pad=None):
        import progressivex_tpu_torch

        self.program, self.fault, self.nth, self.pad, self.produced = (
            progressivex_tpu_torch, fault, nth, pad, 0)

    def __getattr__(self, name):
        entry = getattr(self.program, name)

        def call(*args, **kwargs):
            out = entry(*args, **kwargs)
            single = not name.endswith("Batched")
            answers = [out[:2]] if single else list(out)
            if self.fault == "unchanged":  # the fit's state as it started: no model
                answers = [_empty(*a) for a in answers]
            elif self.fault == "half":  # half of the batch left out
                answers = answers[:len(answers) // 2]
            elif self.fault == "emptied_half":  # half the rows left as they started
                answers = [_empty(*a) if (self.produced + k) % 2 else a
                           for k, a in enumerate(answers)]
            elif self.fault == "emptied_level":  # one pad level's rows left as they started
                answers = [_empty(*a) if harness.pad_of(len(a[1]), PAD_LEVELS) == self.pad
                           else a for a in answers]
            elif self.fault == "altered_one":  # one answer's labels shifted where produced
                i = self.nth - self.produced
                if 0 <= i < len(answers):
                    answers[i] = _shifted(*answers[i])
            elif self.fault == "altered_all":  # every answer's labels shifted
                answers = [_shifted(*a) for a in answers]
            self.produced += len(out) if not single else 1
            if single:
                stats = out[2] if len(out) > 2 else types.SimpleNamespace(rounds_run=0)
                return (*answers[0], stats)
            return answers

        return call


@pytest.mark.parametrize("name", list(SHAPES))
def test_sound_run_is_correct(name):
    result = run(small(name), seconds=SECONDS[name])
    assert result["failed"] == 0
    assert result["correct"], result["checks"]


# (cell, fault): the faults each cell can have. A single-scene request has
# no batch to halve (its "emptied_half" empties every other fit); one card
# has no exchange between cards to leave out. Rows left as they started
# keep the answers' count: H's empty share sees them down to one pad
# level, F's mean ME too. H's gross share sees one altered answer among
# any number; F's numbers are means, which see an alteration that
# reaches every answer of a call.
FAULTS = [("adelH-pass", f) for f in ("unchanged", "half", "emptied_half", "emptied_level",
                                      "altered_one")]
FAULTS += [("adelH-single", f) for f in ("unchanged", "emptied_half", "emptied_level",
                                         "altered_one")]
FAULTS += [("adelF-pass", f) for f in ("unchanged", "half", "emptied_half", "emptied_level",
                                       "altered_all")]
FAULTS += [("adelF-single", f) for f in ("unchanged", "emptied_half", "emptied_level",
                                         "altered_all")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_makes_correct_false(name, fault):
    cell = small(name)
    warm = sum(len(r.scenes) for r in harness.warm_requests(cell, SEED, 0))
    pad = min(harness.pad_of(s[1], PAD_LEVELS) for s in cell.config["specs"])
    result = run(cell, Broken(fault, nth=warm, pad=pad), seconds=SECONDS[name])
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", list(SHAPES))
def test_control_in_the_programs_place_is_not_correct(name):
    """The reference computed in bfloat16 on the program's answers, judged
    as the program's answers are, fails a number the cell compares."""
    import progressivex_tpu_torch
    import torch

    cell = small(name)
    pool = harness.Pool(cell, SEED, len(cell.config["specs"]))
    answers = []
    for i in range(len(pool.items)):
        answers += harness._serve(cell, progressivex_tpu_torch, pool.get(i),
                                  torch.device("cpu"), False)[0]
    sample = harness.check_sample(cell, types.SimpleNamespace(answers=answers), SEED)
    sound, _ = harness.verdict(cell, harness.judge_answers(cell, sample))
    low, checks = harness.verdict(
        cell, harness.judge_answers(cell, sample, judge=reference.control))
    assert sound and not low, checks
