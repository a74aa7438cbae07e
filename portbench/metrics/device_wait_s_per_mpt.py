"""Thread seconds of the program's ``device: wait`` spans (the host blocked
on the card's queued work before each blocking copy of
``core/transfer.py``) per million grid points of the window."""

from portbench.metrics import _spans

SPANS = ("device: wait",)


def read(run):
    return _spans.per_mpt(run, SPANS)
