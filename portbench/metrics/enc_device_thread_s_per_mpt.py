"""Thread seconds in the stage ``enc: device`` of the encode pipeline
(``core/codec.py`` ``_encode_to_host``: the dispatch of a batch's device
encode, with its syncs inside the call) per million grid points of the
window."""

from portbench.metrics import _stages


def read(run):
    return _stages.per_mpt(run, "enc: device")
