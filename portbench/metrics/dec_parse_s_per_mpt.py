"""Thread seconds in the host parse of a decode, the stages
``dec: entropy decode`` and ``dec: unpack planes``, per million grid points
of the window."""

from portbench.metrics import _stages


def read(run):
    return _stages.per_mpt(run, "dec: entropy decode", "dec: unpack planes")
