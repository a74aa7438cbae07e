"""Host-side lossless entropy backends for packed bitplane payloads.

The PyTorch port's copy of ``ebcc_tpu/core/entropy.py``, restricted to the
STORE and ZSTD backends.  The backend ids are part of the stream format and
keep the JAX package's values.  The CAB coders (ids 2 and 4) are C++ under
``ebcc_tpu/native/``; the port has no copy of them yet, so selecting or
decoding them raises ``NotImplementedError`` (ROADMAP Queue 1 item 2).

As in the reference: without ``zstandard`` the ZSTD backend stores the
payload raw, and :func:`backend_id` then resolves to STORE so the stream
header records what was written.
"""

from __future__ import annotations

from ..utils.logging import logger

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - depends on the installation
    _zstd = None

BACKEND_STORE = 0
BACKEND_ZSTD = 1
BACKEND_NATIVE_CAB = 2
BACKEND_AUTO = 3         # pseudo-id of the reference (never in streams)
BACKEND_NATIVE_CAB2 = 4

_CAB_IDS = (BACKEND_NATIVE_CAB, BACKEND_NATIVE_CAB2, BACKEND_AUTO)


def _not_ported(backend: int):
    return NotImplementedError(
        f"entropy backend {backend} (CAB) is not yet ported to "
        "ebcc_tpu_torch (ROADMAP Queue 1 item 2: CAB coder)")


def compress(data: bytes, backend: int = BACKEND_ZSTD,
             level: int = 9) -> bytes:
    if backend == BACKEND_STORE or (backend == BACKEND_ZSTD and _zstd is None):
        if backend != BACKEND_STORE and _zstd is None:
            logger.warning("zstandard unavailable; storing uncompressed")
        return bytes(data)
    if backend == BACKEND_ZSTD:
        # write_checksum: a flipped payload byte must fail loudly at decode,
        # not silently reconstruct garbage (robust-decoder posture).
        cctx = _zstd.ZstdCompressor(level=level, write_checksum=True)
        return cctx.compress(data)
    if backend in _CAB_IDS:
        raise _not_ported(backend)
    raise ValueError(f"unknown entropy backend {backend}")


def decompress(data: bytes, backend: int, orig_size: int) -> bytes:
    if backend == BACKEND_STORE:
        return bytes(data)
    if backend == BACKEND_ZSTD:
        if _zstd is None:
            raise RuntimeError("zstandard required to decode this stream")
        dctx = _zstd.ZstdDecompressor()
        try:
            return dctx.decompress(data, max_output_size=orig_size)
        except _zstd.ZstdError as e:
            raise ValueError(f"corrupt entropy payload: {e}") from e
    if backend in _CAB_IDS:
        raise _not_ported(backend)
    raise ValueError(f"unknown entropy backend {backend}")


def default_backend() -> int:
    return BACKEND_ZSTD if _zstd is not None else BACKEND_STORE


def backend_id(config) -> int:
    """Resolve a CodecConfig's entropy backend to its id."""
    name = getattr(config, "entropy_backend", "zstd")
    if name in ("cab", "cab2", "auto"):
        raise NotImplementedError(
            f"entropy_backend={name!r} is not yet ported to ebcc_tpu_torch "
            "(ROADMAP Queue 1 item 2: CAB coder)")
    return default_backend()
