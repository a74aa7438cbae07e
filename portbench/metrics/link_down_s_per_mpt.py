"""Thread seconds of the program's ``link: down`` spans
(``core/transfer.py``: every device-to-host copy whose bytes
``LINK_STATS`` counts, the wait for the card's queued work kept out) per
million grid points of the window."""

from portbench.metrics import _spans

SPANS = ("link: down",)


def read(run):
    return _spans.per_mpt(run, SPANS)
