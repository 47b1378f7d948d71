"""Share of the rows a batched call launches that fit a caller's scene:
100 * the `real_rows` over the `rows` of the recorder part's
`progx.inputs` spans (bench_port/recorder.py), one a pad level. Filler
lanes (a pad level's lanes rounded up to a power of two by repeating
scenes) are fitted and thrown away."""

from bench_port import recorder


def read(readings):
    return value(recorder.spans(readings))


def value(recorded):
    inputs = [s for s in recorded or () if s.name == "progx.inputs"]
    rows = sum(s.counts.get("rows", 0) for s in inputs)
    if rows == 0:
        return None
    return 100.0 * sum(s.counts.get("real_rows", 0) for s in inputs) / rows
