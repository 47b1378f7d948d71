"""One reader a per-layer metric of BENCHMARK.json, found by the metric's
name: `read(readings)` (harness.Readings) returns its value, or None
when the run holds nothing for it to read."""
