"""Thread seconds of the program's ``enc: wait worker`` spans (the request
thread of ``encode_chunked`` blocked on the encode pipeline's fetch or
assembly workers, ``core/codec.py`` ``_pipeline_encode_slices``; it opens
only where a write is more than one slice of ``max_batch`` chunks) per
million grid points of the window."""

from portbench.metrics import _spans

SPANS = ("enc: wait worker",)


def read(run):
    return _spans.per_mpt(run, SPANS)
