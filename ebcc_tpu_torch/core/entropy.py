"""Host-side lossless entropy backends for packed bitplane payloads.

The PyTorch port's copy of ``ebcc_tpu/core/entropy.py``.  The backend ids
are part of the stream format and keep the JAX package's values: STORE,
ZSTD, the CAB coders (ids 2 and 4, the port's own C++ in
``csrc/host/cab_coder.cc`` through :mod:`ebcc_tpu_torch.native`), and the
AUTO pseudo-id, which codes with CAB and with ZSTD and keeps the smaller.

zstd comes from the ``zstandard`` module where it imports (the JAX
package's binding, so both packages write the same bytes on one machine),
else from the system's ``libzstd.so.1`` through ``ctypes``
(:class:`_LibZstd`).  The two write the same frame format; the bytes differ
only as far as the library versions do.  Only on a machine with neither
does the ZSTD backend store the payload raw, :func:`default_backend` then
resolve to STORE so the stream header records what was written, and AUTO
compare CAB against STORE.
"""

from __future__ import annotations

import ctypes

from ..utils.logging import logger

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - depends on the installation
    _zstd = None

# zstd.h's ZSTD_cParameter values and content-size sentinels.
_ZSTD_C_COMPRESSION_LEVEL = 100
_ZSTD_C_CHECKSUM_FLAG = 201
_ZSTD_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_ZSTD_CONTENTSIZE_ERROR = (1 << 64) - 2


class _LibZstd:
    """``libzstd.so.1`` bound with ``ctypes``: the same calls as the host
    codec's ``zstd_pack`` / ``zstd_unpack`` (``csrc/host/etpu_codec.cc``).
    ctypes releases the GIL around each call, as ``zstandard`` does."""

    def __init__(self, lib: ctypes.CDLL):
        sz, vp = ctypes.c_size_t, ctypes.c_void_p
        for name, res, args in (
                ("ZSTD_createCCtx", vp, []),
                ("ZSTD_freeCCtx", sz, [vp]),
                ("ZSTD_CCtx_setParameter", sz, [vp, ctypes.c_int,
                                                ctypes.c_int]),
                ("ZSTD_compressBound", sz, [sz]),
                ("ZSTD_compress2", sz, [vp, ctypes.c_char_p, sz,
                                        ctypes.c_char_p, sz]),
                ("ZSTD_isError", ctypes.c_uint, [sz]),
                ("ZSTD_getFrameContentSize", ctypes.c_ulonglong,
                 [ctypes.c_char_p, sz]),
                ("ZSTD_decompress", sz, [ctypes.c_char_p, sz,
                                         ctypes.c_char_p, sz]),
                ("ZSTD_versionNumber", ctypes.c_uint, [])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        self.lib = lib
        v = lib.ZSTD_versionNumber()
        self.version = f"{v // 10000}.{v // 100 % 100}.{v % 100}"

    def compress(self, data: bytes, level: int, checksum: bool) -> bytes:
        lib = self.lib
        data = bytes(data)
        cctx = lib.ZSTD_createCCtx()
        if not cctx:
            raise MemoryError("ZSTD_createCCtx failed")
        try:
            for param, value in ((_ZSTD_C_COMPRESSION_LEVEL, level),
                                 (_ZSTD_C_CHECKSUM_FLAG, int(checksum))):
                if lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, param,
                                                               value)):
                    raise ValueError(f"zstd parameter {param}={value} "
                                     "refused")
            out = ctypes.create_string_buffer(
                lib.ZSTD_compressBound(len(data)))
            n = lib.ZSTD_compress2(cctx, out, len(out), data, len(data))
        finally:
            lib.ZSTD_freeCCtx(cctx)
        if lib.ZSTD_isError(n):
            raise RuntimeError("ZSTD_compress2 failed")
        return out.raw[:n]

    def decompress(self, data: bytes, max_output_size: int) -> bytes:
        """A frame's bytes, at most ``max_output_size`` of them;
        ``ValueError`` on a corrupt frame (the checksum included)."""
        lib = self.lib
        data = bytes(data)
        size = lib.ZSTD_getFrameContentSize(data, len(data))
        if size == _ZSTD_CONTENTSIZE_ERROR:
            raise ValueError("not a zstd frame")
        if size == _ZSTD_CONTENTSIZE_UNKNOWN:
            size = max_output_size
        elif size > max_output_size:
            raise ValueError(f"zstd frame holds {size} bytes, more than "
                             f"the {max_output_size} expected")
        out = ctypes.create_string_buffer(max(size, 1))
        n = lib.ZSTD_decompress(out, size, data, len(data))
        if lib.ZSTD_isError(n):
            raise ValueError("zstd frame failed to decode")
        return out.raw[:n]


def _load_libzstd():
    try:
        return _LibZstd(ctypes.CDLL("libzstd.so.1"))
    except (OSError, AttributeError):  # absent, or too old for compress2
        return None


_libzstd = _load_libzstd()


def zstd_binding():
    """Which zstd codes the ZSTD backend: ``zstandard <version> (libzstd
    <version>)``, ``libzstd.so.1 <version> (ctypes)``, or None (STORE)."""
    if _zstd is not None:
        lib = ".".join(map(str, _zstd.ZSTD_VERSION))
        return f"zstandard {_zstd.__version__} (libzstd {lib})"
    if _libzstd is not None:
        return f"libzstd.so.1 {_libzstd.version} (ctypes)"
    return None


def zstd_compress(data: bytes, level: int, checksum: bool = True) -> bytes:
    """One zstd frame of ``data`` with its content size, through the first
    binding present; ``RuntimeError`` with neither."""
    if _zstd is not None:
        return _zstd.ZstdCompressor(level=level,
                                    write_checksum=checksum).compress(data)
    if _libzstd is not None:
        return _libzstd.compress(data, level, checksum)
    raise RuntimeError("neither zstandard nor libzstd.so.1 is available")


def zstd_decompress(data: bytes, max_output_size: int) -> bytes:
    """Decode one zstd frame; ``ValueError`` when it is corrupt,
    ``RuntimeError`` with no binding."""
    if _zstd is not None:
        try:
            return _zstd.ZstdDecompressor().decompress(
                data, max_output_size=max_output_size)
        except _zstd.ZstdError as e:
            raise ValueError(f"corrupt entropy payload: {e}") from e
    if _libzstd is not None:
        try:
            return _libzstd.decompress(data, max_output_size)
        except ValueError as e:
            raise ValueError(f"corrupt entropy payload: {e}") from e
    raise RuntimeError("zstd (zstandard or libzstd.so.1) required to "
                       "decode this stream")


BACKEND_STORE = 0
BACKEND_ZSTD = 1
BACKEND_NATIVE_CAB = 2   # context-adaptive binary coder (cab_coder.cc)
BACKEND_AUTO = 3         # pseudo-id: CAB or ZSTD, the smaller (never in
                         # streams)
BACKEND_NATIVE_CAB2 = 4  # CAB's relaxed-eligibility profile


def compress(data: bytes, backend: int = BACKEND_ZSTD, level: int = 9,
             meta=None) -> bytes:
    """``meta`` = (kept, d0, hp, wp, levels), required by the CAB backends
    (their context model walks the payload's plane structure)."""
    if backend == BACKEND_ZSTD and default_backend() == BACKEND_STORE:
        logger.warning("no zstd binding; storing uncompressed")
        backend = BACKEND_STORE
    if backend == BACKEND_STORE:
        return bytes(data)
    if backend == BACKEND_ZSTD:
        # The checksum: a flipped payload byte must fail loudly at decode,
        # not silently reconstruct garbage (robust-decoder posture).
        return zstd_compress(data, level)
    if backend == BACKEND_NATIVE_CAB:
        from .. import native
        return native.cab_compress(data, *meta)
    if backend == BACKEND_NATIVE_CAB2:
        from .. import native
        return native.cab2_compress(data, *meta)
    raise ValueError(f"unknown entropy backend {backend}")


def decompress(data: bytes, backend: int, orig_size: int, meta=None) -> bytes:
    if backend == BACKEND_STORE:
        return bytes(data)
    if backend == BACKEND_ZSTD:
        return zstd_decompress(data, orig_size)
    if backend == BACKEND_NATIVE_CAB:
        from .. import native
        return native.cab_decompress(data, *meta)
    if backend == BACKEND_NATIVE_CAB2:
        from .. import native
        return native.cab2_decompress(data, *meta)
    raise ValueError(f"unknown entropy backend {backend}")


def default_backend() -> int:
    if _zstd is None and _libzstd is None:
        return BACKEND_STORE
    return BACKEND_ZSTD


def backend_id(config) -> int:
    """Resolve a CodecConfig's entropy backend to its (pseudo-)id."""
    name = getattr(config, "entropy_backend", "zstd")
    if name == "cab":
        return BACKEND_NATIVE_CAB
    if name == "cab2":
        return BACKEND_NATIVE_CAB2
    if name == "auto":
        return BACKEND_AUTO
    return default_backend()


def compress_best(data: bytes, backend: int, level: int, meta):
    """-> (compressed, backend id used).  AUTO codes with CAB and with the
    default backend (ZSTD, or STORE without a zstd binding) and keeps the
    smaller; a tie keeps the default."""
    if backend != BACKEND_AUTO:
        return compress(data, backend, level, meta=meta), backend
    zbk = default_backend()
    z = compress(data, zbk, level)
    c = compress(data, BACKEND_NATIVE_CAB, level, meta=meta)
    return (c, BACKEND_NATIVE_CAB) if len(c) < len(z) else (z, zbk)
