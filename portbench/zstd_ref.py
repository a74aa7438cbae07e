"""The reference decoder's own binding of ``libzstd.so.1`` (decode only).

Independent of the program's binding: it checks that each frame declares
its content size and a content checksum (docs/FORMAT.md: "zstd
(checksummed frame)") and lets ``ZSTD_decompress`` verify the checksum.
"""

from __future__ import annotations

import ctypes
import threading

ZSTD_MAGIC = 0xFD2FB528
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL("libzstd.so.1")
            sz = ctypes.c_size_t
            for name, res, args in (
                    ("ZSTD_isError", ctypes.c_uint, [sz]),
                    ("ZSTD_getErrorName", ctypes.c_char_p, [sz]),
                    ("ZSTD_getFrameContentSize", ctypes.c_ulonglong,
                     [ctypes.c_char_p, sz]),
                    ("ZSTD_findFrameCompressedSize", sz,
                     [ctypes.c_char_p, sz]),
                    ("ZSTD_decompress", sz, [ctypes.c_char_p, sz,
                                             ctypes.c_char_p, sz])):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
    return _lib


class ZstdError(ValueError):
    """A payload that is not one whole, checksummed zstd frame of the
    expected size."""


def decompress(data: bytes, expected_size: int) -> bytes:
    """One zstd frame -> exactly ``expected_size`` bytes."""
    lib = _load()
    data = bytes(data)
    if len(data) < 6 or int.from_bytes(data[:4], "little") != ZSTD_MAGIC:
        raise ZstdError("not a zstd frame")
    if not data[4] & 0x04:
        raise ZstdError("zstd frame without a content checksum")
    if lib.ZSTD_findFrameCompressedSize(data, len(data)) != len(data):
        raise ZstdError("payload is not exactly one zstd frame")
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size in (_CONTENTSIZE_UNKNOWN, _CONTENTSIZE_ERROR):
        raise ZstdError("zstd frame without a content size")
    if size != expected_size:
        raise ZstdError(f"zstd frame holds {size} bytes, "
                        f"{expected_size} expected")
    out = ctypes.create_string_buffer(max(size, 1))
    n = lib.ZSTD_decompress(out, size, data, len(data))
    if lib.ZSTD_isError(n):
        raise ZstdError(lib.ZSTD_getErrorName(n).decode())
    if n != expected_size:
        raise ZstdError(f"zstd frame decoded to {n} bytes")
    return out.raw[:n]
