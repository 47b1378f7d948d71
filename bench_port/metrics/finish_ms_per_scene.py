"""Device time of PEARL's final moves a scene, in milliseconds: the device
intervals of the recorder part's `finish` replays (split, merge, the
polishes, the final relabel, the energy; bench_port/recorder.py), over
the scenes served."""

from bench_port import recorder


def read(readings):
    return value(recorder.spans(readings))


def value(recorded):
    if not recorded:
        return None
    split, _, n = recorder.totals(recorded)
    if n == 0 or not any(k.startswith("replay.") for k in split):
        return None
    return split["replay.finish"] / 1e6 / n
