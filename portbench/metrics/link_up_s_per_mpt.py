"""Thread seconds of the program's ``link: up`` spans (``core/transfer.py``:
every host-to-device copy whose bytes ``LINK_STATS`` counts, the wait for
the card's queued work kept out) per million grid points of the window."""

from portbench.metrics import _spans

SPANS = ("link: up",)


def read(run):
    return _spans.per_mpt(run, SPANS)
