"""Seconds of the program's stage spans (``utils/timing.STATS``: name ->
[count, thread seconds, self seconds], snapshot at the end of the window,
every thread) per million grid points of the window; shared by the span
metrics.

None in an untraced run, and where the table holds no self seconds (a
program without the span tree): the metric is then left out of the line.
0.0 where none of the spans opened in the window."""

THREAD_S, SELF_S = 1, 2


def per_mpt(run, spans, item=THREAD_S):
    stats = run.stats
    if stats is None or not any(len(v) > SELF_S for v in stats.values()):
        return None
    return (sum(stats[s][item] for s in spans if s in stats)
            / (run.points / 1e6))
