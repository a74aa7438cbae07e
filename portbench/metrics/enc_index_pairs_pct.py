"""Share of the encode exchange's significant pairs that took the int32
index fallback (``torch.nonzero`` and two copies at 8 B a pair, above
``transfer.COMPACT_CAP_LIMIT`` or without the Rice exchange), in percent:
the program's counter ``exch: index pairs`` over the sum of it and
``exch: compact pairs`` (``utils/timing.STATS``, [additions, pairs],
snapshot at the end of the window; ``core/codec.py``
``_fetch_encode_outputs``).

None in an untraced run and where the table holds neither counter (a
program without them); 0.0 where no pair took the fallback."""

COUNTERS = ("exch: index pairs", "exch: compact pairs")


def read(run):
    stats = run.stats
    if not stats or not any(c in stats for c in COUNTERS):
        return None
    index, compact = (stats[c][1] if c in stats else 0 for c in COUNTERS)
    total = index + compact
    return 100.0 * index / total if total else 0.0
