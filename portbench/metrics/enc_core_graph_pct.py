"""Share of the encode core's segments that ran as replays of CUDA graphs
captured before, in percent: the program's counter ``core: graph
replays`` over it plus ``core: graph captures`` (``utils/timing.STATS``,
[additions, segments], snapshot at the end of the window;
``ebcc_tpu_torch/core/graphs.py``).  A segment captured in the window
counts as a capture; one that ran eagerly counts in neither.

None in an untraced run and where the table holds neither counter (a
program without the graphs, or an encode core that ran on no CUDA
tensor)."""

COUNTERS = ("core: graph replays", "core: graph captures")


def read(run):
    stats = run.stats
    if not stats or not any(c in stats for c in COUNTERS):
        return None
    replays, captures = (stats[c][1] if c in stats else 0 for c in COUNTERS)
    total = replays + captures
    return 100.0 * replays / total if total else None
