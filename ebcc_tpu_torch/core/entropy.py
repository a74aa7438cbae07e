"""Host-side lossless entropy backends for packed bitplane payloads.

The PyTorch port's copy of ``ebcc_tpu/core/entropy.py``.  The backend ids
are part of the stream format and keep the JAX package's values: STORE,
ZSTD, the CAB coders (ids 2 and 4, the port's own C++ in
``csrc/host/cab_coder.cc`` through :mod:`ebcc_tpu_torch.native`), and the
AUTO pseudo-id, which codes with CAB and with ZSTD and keeps the smaller.

As in the reference: without ``zstandard`` the ZSTD backend stores the
payload raw, :func:`default_backend` then resolves to STORE so the stream
header records what was written, and AUTO compares CAB against STORE.
"""

from __future__ import annotations

from ..utils.logging import logger

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - depends on the installation
    _zstd = None

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
    if backend == BACKEND_STORE or (backend == BACKEND_ZSTD and _zstd is None):
        if backend != BACKEND_STORE and _zstd is None:
            logger.warning("zstandard unavailable; storing uncompressed")
        return bytes(data)
    if backend == BACKEND_ZSTD:
        # write_checksum: a flipped payload byte must fail loudly at decode,
        # not silently reconstruct garbage (robust-decoder posture).
        cctx = _zstd.ZstdCompressor(level=level, write_checksum=True)
        return cctx.compress(data)
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
        if _zstd is None:
            raise RuntimeError("zstandard required to decode this stream")
        dctx = _zstd.ZstdDecompressor()
        try:
            return dctx.decompress(data, max_output_size=orig_size)
        except _zstd.ZstdError as e:
            raise ValueError(f"corrupt entropy payload: {e}") from e
    if backend == BACKEND_NATIVE_CAB:
        from .. import native
        return native.cab_decompress(data, *meta)
    if backend == BACKEND_NATIVE_CAB2:
        from .. import native
        return native.cab2_decompress(data, *meta)
    raise ValueError(f"unknown entropy backend {backend}")


def default_backend() -> int:
    return BACKEND_ZSTD if _zstd is not None else BACKEND_STORE


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
    default backend (ZSTD, or STORE without ``zstandard``) and keeps the
    smaller; a tie keeps the default."""
    if backend != BACKEND_AUTO:
        return compress(data, backend, level, meta=meta), backend
    zbk = default_backend()
    z = compress(data, zbk, level)
    c = compress(data, BACKEND_NATIVE_CAB, level, meta=meta)
    return (c, BACKEND_NATIVE_CAB) if len(c) < len(z) else (z, zbk)
