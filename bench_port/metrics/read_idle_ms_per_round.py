"""Device time lost to the compiled fit's host reads, a round, in
milliseconds: in the recorder part (bench_port/recorder.py), from the
device end of each replay that a `progx.read.*` span follows to the
device start of the next replay, summed, over the `propose` replays (one
a round)."""

from bench_port import recorder


def read(readings):
    return value(recorder.spans(readings))


def value(recorded):
    if not recorded:
        return None
    split, proposes, _ = recorder.totals(recorded)
    if proposes == 0:
        return None
    return sum(v for k, v in split.items() if k.startswith("gap.read.")) / 1e6 / proposes
