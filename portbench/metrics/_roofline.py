"""A wavelet kernel family's share of its roofline over the traced
stretch: the least time of every recorded call of the family
(``portbench.roofline``) over the profiler's device time of the family's
kernels in the same calls, in percent.  Nothing without device time."""

from portbench import roofline


def share(run, family):
    if run.trace is None:
        return None
    calls = run.trace.calls.get(family, [])
    device_s = run.trace.family_device_s(family)
    if not calls or device_s <= 0:
        return None
    least = sum(roofline.call_bound_s(kind, shape, levels)
                for kind, shape, levels in calls)
    return 100.0 * least / device_s
