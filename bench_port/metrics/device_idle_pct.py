"""Share of the traced requests' wall time in which no device operation
runs: 100 * (1 - busy / wall). Busy is the union of the intervals of the
kernels, copies and sets of the CUPTI trace (tracing.summarize); wall is
the same requests served again without the profiler (harness.untraced_s),
since the tracer's cost per device operation would read as idle time."""


def read(readings):
    summary = readings.window.summary
    if summary is None or not readings.untraced_s:
        return None
    return 100.0 * (1.0 - summary.busy_s / readings.untraced_s)
