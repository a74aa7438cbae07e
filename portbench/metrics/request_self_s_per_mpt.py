"""Self seconds of the program's ``request:`` spans (the entry points
``encode_chunked`` and ``decode_chunked`` of ``core/codec.py``, less their
child spans on the same thread) per million grid points of the window:
the request's time that no inner span names."""

from portbench.metrics import _spans

SPANS = ("request: encode_chunked", "request: decode_chunked")


def read(run):
    return _spans.per_mpt(run, SPANS, _spans.SELF_S)
