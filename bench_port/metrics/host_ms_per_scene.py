"""Wall time of the entry points' own work a scene, in milliseconds: in
the recorder part (bench_port/recorder.py), the time of each `progx.call`
span outside its `progx.fit` spans and outside the device intervals of
its replays (a fit returns while its last replay runs; the results' first
read waits for it), summed over the calls, over the scenes they served:
the padding, the copies and the results on the host, with the device
running no replay."""

from bench_port import recorder


def read(readings):
    return value(recorder.spans(readings))


def value(recorded):
    if not recorded:
        return None
    n = recorder.scenes(recorded)
    if n == 0:
        return None
    own = sum(recorder.outside(c, [(s.start_ns, s.end_ns) for s in m if s.name == "progx.fit"]
                               + [s.device for s in m if s.device])
              for c, m in recorder.calls(recorded))
    return own / 1e6 / n
