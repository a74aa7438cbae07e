"""Thread seconds of the program's stage timers (``EBCC_TIMING=2``) per
million grid points of the window; shared by the stage metrics."""


def per_mpt(run, *stages):
    if not run.stats:
        return None
    found = [run.stats[s][1] for s in stages if s in run.stats]
    if not found:
        return None
    return sum(found) / (run.points / 1e6)
