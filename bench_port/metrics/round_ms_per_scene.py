"""Device time of the engine's rounds a scene, in milliseconds: the device
intervals of the recorder part's `propose`, `update0`, `update1` and
`rounds` replays (bench_port/recorder.py), over the scenes served."""

from bench_port import recorder


def read(readings):
    return value(recorder.spans(readings))


def value(recorded):
    if not recorded:
        return None
    split, _, n = recorder.totals(recorded)
    if n == 0 or not any(k.startswith("replay.") for k in split):
        return None
    return sum(split[f"replay.{stage}"] for stage in recorder.ROUND_STAGES) / 1e6 / n
