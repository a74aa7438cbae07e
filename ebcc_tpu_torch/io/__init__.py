"""Streaming file IO of ETPK containers (counterpart of ``ebcc_tpu/io``)."""

from .pipeline import (  # noqa: F401
    append_chunked,
    append_chunked_file,
    compress_hdf5,
    compress_stream,
    decompress_stream,
    repair_chunked_file,
)
