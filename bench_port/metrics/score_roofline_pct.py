"""The scoring kernels' share of their roofline in the traced part: the
least time of the scoring the traced calls' fits did (roofline.py: each
round's proposal and LO passes over the valid points of every real row,
the rounds from the kernel launches the program counted, the pass shapes
from the configuration's protocol), over the device time of the kernels
whose names match below."""

from bench_port import roofline, tracing

# The scoring kernels by the names the CUDA trace gives them: one body,
# score_common.cuh's `score_kernel`, instanced per residual.
KERNELS = {"homography": [["score_kernel", "HomographyR2"]],
           "fundamental": [["score_kernel", "SampsonR2"]]}


def read(readings):
    window, config = readings.window, readings.cell.config
    if window.summary is None:
        return None
    least = 0.0
    for family, groups, launches in window.traced_calls:
        bound = roofline.call_bound_s(config["work"], family, groups, launches)
        if bound is None:
            return None
        least += bound
    _, measured = tracing.matching(window.summary.ops, KERNELS[config["family"]])
    if measured <= 0 or least <= 0:
        return None
    return 100.0 * least / measured
