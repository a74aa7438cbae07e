"""Thread seconds of the program's ``dec: wait worker`` spans (the request
thread of ``decode_chunked`` blocked on the worker that parses,
entropy-decodes, uploads and dispatches a batch, ``core/codec.py``
``_decode_chunk_arrays``) per million grid points of the window."""

from portbench.metrics import _spans

SPANS = ("dec: wait worker",)


def read(run):
    return _spans.per_mpt(run, SPANS)
