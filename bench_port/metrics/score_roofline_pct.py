"""The scoring kernels' share of their roofline in the traced part: the
least time of the scoring the traced calls' fits did (roofline.py: each
round's proposal and LO passes over the valid points of every real row,
the rounds from the kernel launches the program counted, the pass shapes
from the configuration's protocol), over the device time of the kernels
whose names match the KERNEL_NAMES of the calls' families. Nothing to
read where a family scores with no kernel of its own (KERNEL None)."""

from bench_port import families, roofline, tracing


def read(readings):
    window, config = readings.window, readings.cell.config
    if window.summary is None:
        return None
    least, names = 0.0, []
    for family, groups, launches in window.traced_calls:
        module = families.load(family)
        if module.KERNEL is None:
            return None
        bound = roofline.call_bound_s(config["work"], family, groups, launches)
        if bound is None:
            return None
        least += bound
        names += module.KERNEL_NAMES
    _, measured = tracing.matching(window.summary.ops, names)
    if measured <= 0 or least <= 0:
        return None
    return 100.0 * least / measured
