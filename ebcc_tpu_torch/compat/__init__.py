"""Legacy EBCC v1 format interop: the PyTorch port's copy of
``ebcc_tpu/compat/``, with the same API.

The reference codec (reference src/ebcc_codec.c) persists a JPEG2000 base
layer plus a zstd-compressed SPIHT residual inside "EBCC" frame streams and
"EBCK" chunking containers.  This package reads and writes that format so
users migrating from the reference can decode their existing archives with
this framework (and produce archives the reference plugin can read), using:

- the system OpenJPEG (via Pillow) for the J2K base layer — the same
  library family the reference links, so base-layer bytes are genuinely
  interoperable;
- the native SPIHT mirror (the port's copy, csrc/host/spiht_coder.cc) for
  the residual layer, and zstd level 22 through :mod:`..core.entropy`
  (``zstandard``, or ``libzstd.so.1`` where it is missing).

This is host work, as in the JAX package: an interop/validation surface,
not the device path; the ETPU format (core/stream.py, docs/FORMAT.md)
remains the native format.  :func:`ebcc_tpu_torch.decode` dispatches
EBCC/EBCK streams here on their magic.
"""

from .legacy import (LegacyFormatError, decode, decode_container,
                     decode_frame, encode_chunked, encode_chunked_compat,
                     encode_frame, is_legacy)

__all__ = [
    "LegacyFormatError",
    "decode",
    "decode_container",
    "decode_frame",
    "encode_chunked",
    "encode_chunked_compat",
    "encode_frame",
    "is_legacy",
]
