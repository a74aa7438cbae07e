"""Legacy EBCC v1 stream reader/writer (the PyTorch port's copy of
``ebcc_tpu/compat/legacy.py``; host code, as there).

Behavioral mirror of the reference codec's serialization and encoder state
machine (reference src/ebcc_codec.c), built on:

- :mod:`ebcc_tpu_torch.compat.j2k` (Pillow/OpenJPEG) for the base layer,
- ``native.spiht_encode/spiht_decode`` (csrc/host/spiht_coder.cc, in
  ``libebcc_host.so``) for the residual layer,
- zstd level 22 for the residual bytes (ebcc_codec.c:816), through
  :mod:`ebcc_tpu_torch.core.entropy`: ``zstandard`` where it imports (the
  JAX package's bytes), else ``libzstd.so.1``.

Stream layouts mirrored exactly:

- 48-byte "EBCC" frame header: magic, version=1, flags (bit0 const field),
  reserved u16, minval/maxval f32 bits, coeffs_size u64, residual
  min/max f32 bits, compressed_size u64, tail_size u64
  (ebcc_header_t, ebcc_codec.c:190-202), followed by the zstd residual
  payload then the J2K codestream (or a u64 element count for const
  fields) (c:870-907).
- 80-byte "EBCK" chunking container: magic, version u32, ndims u32,
  reserved u32, dims[3], chunk_dims[3], num_chunks, chunk_size, followed
  by ``num_chunks`` × [u64 size | frame stream] in raster chunk order
  (ebcc_chunking_header_t, c:204-213, 976-1046).
- The unversioned pre-"EBCC" layout accepted by ebcc_decode_legacy
  (c:1147-1213).

Encoder semantics mirrored: uint16 scaling (c:686-689), const-field
shortcut (c:678), quantile-relaxed base CR search with exponential bracket
+ bisection (error_bound_j2k_compression, c:545-596), SPIHT truncation
bisection (c:765-807), 16-byte residual drop rule (c:811), pure-base
fallback comparison incl. the consistency re-encode (c:819-854), mean-error
adjustment folded into stored min/max (c:863-868), and the same env
switches (EBCC_INIT_BASE_ERROR_QUANTILE,
EBCC_DISABLE_PURE_BASE_COMPRESSION_FALLBACK[_CONSISTENCY],
EBCC_DISABLE_MEAN_ADJUSTMENT, c:630-650).
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..config import (CodecConfig, RESIDUAL_MAX_ERROR, RESIDUAL_NONE,
                      RESIDUAL_RELATIVE_ERROR)
from ..core import entropy
from ..utils.logging import logger
from . import j2k

MAGIC_FRAME = b"EBCC"
MAGIC_CONTAINER = b"EBCK"
VERSION = 1
FLAG_CONST_FIELD = 0x01

_HEADER = struct.Struct("<4sBBHIIQIIQQ")      # 48 B, ebcc_codec.c:190-202
_CHUNK_HEADER = struct.Struct("<4sIII3Q3QQQ")  # 80 B, ebcc_codec.c:204-213
assert _HEADER.size == 48 and _CHUNK_HEADER.size == 80

# Frame-dim validity window (ebcc_codec.h:16-17).
_MIN_DIM, _MAX_DIM = 32, 2047
_WAVELET_LEVELS = 3          # ebcc_codec.c:28
_SPIHT_HEADER_BITS = 112.0   # truncation floor (c:768)
_RESIDUAL_DROP_BYTES = 16    # c:811
_ZSTD_LEVEL = 22             # c:816


class LegacyFormatError(ValueError):
    pass


def _zstd_pack(data: bytes) -> bytes:
    """The residual's zstd frame: level 22, no checksum, as the reference
    writes it."""
    try:
        return entropy.zstd_compress(data, _ZSTD_LEVEL, checksum=False)
    except RuntimeError as e:
        raise LegacyFormatError(f"legacy EBCC interop needs zstd: {e}") from e


def _zstd_unpack(comp: bytes, max_size: int) -> bytes:
    try:
        return entropy.zstd_decompress(comp, max_size)
    except (RuntimeError, ValueError) as e:
        raise LegacyFormatError(f"EBCC residual payload: {e}") from e


def _spiht():
    from .. import native
    native.load_host()
    return native


def is_legacy(buf: bytes) -> bool:
    """True when ``buf`` carries a reference-format magic."""
    return buf[:4] in (MAGIC_FRAME, MAGIC_CONTAINER)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _apply_residual(out: np.ndarray, comp: bytes, coeffs_size: int,
                    rmin: float, rmax: float) -> None:
    """zstd + SPIHT residual decode and in-place add (c:1294-1308)."""
    h, w = out.shape
    coeffs = _zstd_unpack(comp, coeffs_size)
    if len(coeffs) < coeffs_size:
        coeffs = coeffs + b"\x00" * (coeffs_size - len(coeffs))
    norm = _spiht().spiht_decode(coeffs[:coeffs_size], h, w, coeffs_size * 8)
    out += norm * (np.float32(rmax) - np.float32(rmin)) + np.float32(rmin)


def decode_frame(buf: bytes) -> np.ndarray:
    """Decode one "EBCC" v1 frame stream.

    Returns the flattened (rows, width) float32 image — the caller reshapes
    to the original N-D dims, exactly as the reference's callers do.  Const
    fields (unknown geometry) come back 1-D.  Parity: ebcc_decode
    (c:1215-1320) including its bounds and trailing-byte checks.
    """
    if len(buf) < _HEADER.size or buf[:4] != MAGIC_FRAME:
        raise LegacyFormatError("not an EBCC v1 frame stream")
    (_, version, flags, _, min_bits, max_bits, coeffs_size, rmin_bits,
     rmax_bits, comp_size, tail_size) = _HEADER.unpack_from(buf)
    if version != VERSION:
        raise LegacyFormatError(f"unsupported EBCC version {version}")
    body = len(buf) - _HEADER.size
    if comp_size > body or tail_size > body - comp_size:
        raise LegacyFormatError("truncated EBCC payload")
    if _HEADER.size + comp_size + tail_size != len(buf):
        raise LegacyFormatError("EBCC payload size mismatch")
    # decoder sanity cap: one frame stream can hold at most MAX_DIM^2 *
    # (leading dims), and coeffs_size can never exceed the decoded bytes
    if coeffs_size > (1 << 32):
        raise LegacyFormatError("implausible residual size")

    minval = np.uint32(min_bits).view(np.float32)
    maxval = np.uint32(max_bits).view(np.float32)
    comp = buf[_HEADER.size:_HEADER.size + comp_size]
    tail = buf[_HEADER.size + comp_size:_HEADER.size + comp_size + tail_size]

    if flags & FLAG_CONST_FIELD:
        if tail_size != 8:
            raise LegacyFormatError("const field payload must be a u64 count")
        (tot,) = struct.unpack("<Q", tail)
        if tot > (1 << 40):
            raise LegacyFormatError("implausible const-field size")
        if comp_size > 0 and coeffs_size > 0:
            raise LegacyFormatError("residual on a const field")
        return np.full(int(tot), minval, np.float32)

    out = j2k.decode(tail, float(minval), float(maxval))
    if comp_size > 0 and coeffs_size > 0:
        _apply_residual(out, comp, int(coeffs_size),
                        float(np.uint32(rmin_bits).view(np.float32)),
                        float(np.uint32(rmax_bits).view(np.float32)))
    return out


def decode_unversioned(buf: bytes) -> np.ndarray:
    """Decode the pre-versioned layout: minval f32, maxval f32,
    coeffs_size u64, rmin f32, rmax f32, comp_size u64, [zstd residual]
    [J2K | u64 count].  Parity: ebcc_decode_legacy (c:1147-1213)."""
    head = struct.Struct("<ffQffQ")
    if len(buf) < head.size:
        raise LegacyFormatError("truncated legacy header")
    minval, maxval, coeffs_size, rmin, rmax, comp_size = head.unpack_from(buf)
    rest = buf[head.size:]
    if comp_size > len(rest) or coeffs_size > (1 << 32):
        raise LegacyFormatError("truncated legacy residual payload")
    comp, tail = rest[:comp_size], rest[comp_size:]
    if minval == maxval:
        if len(tail) < 8:
            raise LegacyFormatError("missing legacy const-field length")
        (tot,) = struct.unpack_from("<Q", tail)
        if tot > (1 << 40):
            raise LegacyFormatError("implausible const-field size")
        return np.full(int(tot), np.float32(minval), np.float32)
    out = j2k.decode(tail, minval, maxval)
    if comp_size > 0 and coeffs_size > 0:
        _apply_residual(out, comp, int(coeffs_size), rmin, rmax)
    return out


def decode_container(buf: bytes) -> np.ndarray:
    """Decode an "EBCK" container to the original N-D dims.

    Parity: ebcc_decode_chunking (c:1322-1449): validates the recomputed
    chunk grid, per-chunk decode, unpadded scatter in raster chunk order.
    """
    if len(buf) < _CHUNK_HEADER.size or buf[:4] != MAGIC_CONTAINER:
        raise LegacyFormatError("not an EBCK container")
    (_, version, ndims, _, d0, d1, d2, c0, c1, c2, num_chunks,
     chunk_size) = _CHUNK_HEADER.unpack(buf[:_CHUNK_HEADER.size])
    if version != VERSION or ndims != 3:
        raise LegacyFormatError("unsupported EBCK header")
    dims, chunk_dims = (d0, d1, d2), (c0, c1, c2)
    if any(d == 0 for d in dims) or any(c == 0 for c in chunk_dims):
        raise LegacyFormatError("zero EBCK dimensions")
    if any(d > (1 << 32) for d in dims + chunk_dims):
        raise LegacyFormatError("implausible EBCK dimensions")
    counts = tuple(-(-d // c) for d, c in zip(dims, chunk_dims))
    if num_chunks != int(np.prod(counts)) or \
            chunk_size != int(np.prod(chunk_dims)):
        raise LegacyFormatError("EBCK chunk grid mismatch")

    rows = chunk_dims[0] * chunk_dims[1]
    chunks = np.empty((num_chunks, rows, chunk_dims[2]), np.float32)
    off = _CHUNK_HEADER.size
    for i in range(num_chunks):
        if off + 8 > len(buf):
            raise LegacyFormatError("truncated EBCK chunk table")
        (sz,) = struct.unpack_from("<Q", buf, off)
        off += 8
        if sz > len(buf) - off:
            raise LegacyFormatError("truncated EBCK chunk payload")
        frame = decode_frame(buf[off:off + sz])
        off += sz
        if frame.size != chunk_size:
            raise LegacyFormatError("EBCK chunk size mismatch")
        chunks[i] = frame.reshape(rows, chunk_dims[2])
    if off != len(buf):
        raise LegacyFormatError("trailing bytes after EBCK chunks")

    from ..core.codec import _scatter_chunks
    return _scatter_chunks(chunks.reshape(num_chunks, *chunk_dims), dims,
                           chunk_dims, counts)


def decode(buf: bytes) -> np.ndarray:
    """Magic-dispatched legacy decode (frame, container, or unversioned)."""
    if buf[:4] == MAGIC_CONTAINER:
        return decode_container(buf)
    if buf[:4] == MAGIC_FRAME:
        return decode_frame(buf)
    return decode_unversioned(buf)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

@dataclass
class _EncodeEnv:
    quantile: float = 1e-6
    pure_base_disabled: bool = False
    consistency_disabled: bool = False
    mean_adjust_disabled: bool = False

    @classmethod
    def from_env(cls) -> "_EncodeEnv":
        e = cls()
        q = os.environ.get("EBCC_INIT_BASE_ERROR_QUANTILE")
        if q is not None:
            e.quantile = float(q)
        e.pure_base_disabled = bool(
            os.environ.get("EBCC_DISABLE_PURE_BASE_COMPRESSION_FALLBACK"))
        e.consistency_disabled = bool(os.environ.get(
            "EBCC_DISABLE_PURE_BASE_COMPRESSION_FALLBACK_CONSISTENCY"))
        e.mean_adjust_disabled = bool(
            os.environ.get("EBCC_DISABLE_MEAN_ADJUSTMENT"))
        return e


def _quantile_below(data: np.ndarray, approx: np.ndarray,
                    target: float) -> float:
    """Fraction of points whose abs error is <= target
    (get_error_target_quantile, c:503-513)."""
    err = np.abs(data - approx)
    return 1.0 - float(np.count_nonzero(err > np.float32(target))) / data.size


def _search_base_cr(scaled: np.ndarray, tile_rows: int, start_cr: float,
                    data: np.ndarray, minval: float, maxval: float,
                    error_target: float, quantile_target: float,
                    blob0: bytes, decoded0: np.ndarray):
    """Quantile-relaxed base-layer CR search: exponential bracket then
    bisection, returning (cr_lo, j2k_bytes, decoded) with the result left
    at the final cr_lo encode (error_bound_j2k_compression, c:545-596).
    ``blob0``/``decoded0`` are the already-done start_cr encode (the search
    never re-encodes the start point)."""
    def trial(cr):
        blob = j2k.encode(scaled, cr, tile_rows)
        dec = j2k.decode(blob, minval, maxval)
        return blob, dec, _quantile_below(data, dec, error_target)

    cr_lo = cr_hi = float(start_cr)
    q0 = _quantile_below(data, decoded0, error_target)
    blob, dec = blob0, decoded0

    q = q0
    while q < quantile_target and cr_lo >= 0.5:
        cr_lo /= 2
        blob, dec, q = trial(cr_lo)
    q = q0
    while q >= quantile_target and cr_hi <= 1000:
        cr_hi *= 2
        blob, dec, q = trial(cr_hi)
    if q >= quantile_target:
        return cr_hi, blob, dec

    q = q0
    eps = 1e-8
    while (abs(q - quantile_target) > eps or q == 1.0) and cr_hi - cr_lo > 1.0:
        mid = (cr_lo + cr_hi) / 2
        blob, dec, q = trial(mid)
        if q < quantile_target:
            cr_hi = mid
        else:
            cr_lo = mid
    blob, dec, q = trial(cr_lo)
    if q < quantile_target:
        logger.warning("Could not reach error target quantile of (1-%.2e) "
                       "(1-%.2e instead).", 1 - quantile_target, 1 - q)
    return cr_lo, blob, dec


def _layout(dims: Tuple[int, ...]) -> Tuple[int, int, int]:
    """(flattened rows, width, per-frame rows) with the reference's
    validity window on the flattened image (dims_are_valid, c:286-297)."""
    rows = int(np.prod(dims[:-1]))
    width = int(dims[-1])
    tile_rows = int(dims[-2]) if len(dims) >= 2 else rows
    if not (_MIN_DIM <= rows <= _MAX_DIM and _MIN_DIM <= width <= _MAX_DIM):
        raise ValueError(
            f"legacy EBCC dims out of range [{_MIN_DIM},{_MAX_DIM}]: "
            f"flattened {rows}x{width}")
    return rows, width, tile_rows


def _assemble(flags: int, minval: float, maxval: float, coeffs_size: int,
              rmin: float, rmax: float, comp: bytes, tail: bytes) -> bytes:
    header = _HEADER.pack(
        MAGIC_FRAME, VERSION, flags, 0,
        int(np.float32(minval).view(np.uint32)),
        int(np.float32(maxval).view(np.uint32)),
        coeffs_size,
        int(np.float32(rmin).view(np.uint32)),
        int(np.float32(rmax).view(np.uint32)),
        len(comp), len(tail))
    return header + comp + tail


def encode_frame(data: np.ndarray, config: CodecConfig,
                 env: Optional[_EncodeEnv] = None) -> bytes:
    """Encode one array into an "EBCC" v1 frame stream the reference codec
    can decode.  Parity: ebcc_encode (c:607-918); failures raise instead of
    exit(1)."""
    env = env or _EncodeEnv.from_env()
    data = np.ascontiguousarray(data, dtype=np.float32)
    rows, width, tile_rows = _layout(config.dims)
    if data.size != rows * width:
        raise ValueError("data does not match config.dims")
    if not np.isfinite(data).all():
        raise ValueError("NaN or Inf in legacy encode input")
    img = data.reshape(rows, width)

    minval = np.float32(img.min())
    maxval = np.float32(img.max())
    if minval == maxval:  # const-field shortcut (c:678, 883-885, 899-902)
        return _assemble(FLAG_CONST_FIELD, minval, maxval, 0, 0.0, 0.0, b"",
                         struct.pack("<Q", img.size))

    scaled = (((img - minval) / (maxval - minval))
              * np.float32(65535)).astype(np.uint16)
    base = j2k.encode(scaled, config.base_cr, tile_rows)

    if config.residual_mode == RESIDUAL_NONE:
        return _assemble(0, minval, maxval, 0, 0.0, 0.0, b"", base)
    if config.residual_mode not in (RESIDUAL_MAX_ERROR,
                                    RESIDUAL_RELATIVE_ERROR):
        raise ValueError(f"unsupported residual mode {config.residual_mode}")

    quantile_target = 1.0 - env.quantile
    error_target = np.float32(config.error)
    if config.residual_mode == RESIDUAL_RELATIVE_ERROR:
        error_target = np.float32(error_target * (maxval - minval))

    decoded = j2k.decode(base, minval, maxval)
    mean_error = float(np.mean((img - decoded).astype(np.float64)))

    current_cr, base, decoded = _search_base_cr(
        scaled, tile_rows, config.base_cr, img, float(minval), float(maxval),
        float(error_target), quantile_target, base, decoded)

    residual = img - decoded
    rmin = np.float32(residual.min())
    rmax = np.float32(residual.max())
    cur_max_error = max(abs(float(rmin)), abs(float(rmax)))
    skip_residual = cur_max_error <= error_target
    pure_base_done = quantile_target == 1.0
    pure_base_required = False
    best_feasible_error = -1.0
    coeffs = b""
    coeffs_size = 0
    nat = _spiht()

    if not skip_residual:
        span = rmax - rmin
        norm = ((residual - rmin) / span).astype(np.float32)
        coeffs = nat.spiht_encode(norm, trunc_bits=len(base) * 8,
                                  num_stages=_WAVELET_LEVELS)
        coeffs_size = len(coeffs)

        def recon_error(nbytes: int):
            dec_norm = nat.spiht_decode(coeffs[:nbytes], rows, width,
                                        nbytes * 8)
            res = dec_norm * span + rmin
            err = np.abs(img - (decoded + res))
            return float(err.max()), float(np.mean(
                (img - (decoded + res)).astype(np.float64)))

        cur_max_error, full_mean = recon_error(coeffs_size)
        if cur_max_error > error_target:
            logger.info(
                "Could not reach error target of %f (%f instead). Retry "
                "with pure base compression.", error_target, cur_max_error)
            skip_residual = True
            pure_base_required = True
        else:
            best_feasible_error = cur_max_error
            mean_error = full_mean

    if not skip_residual:
        # Truncation bisection over the embedded stream (c:765-807).
        trunc_hi = float(coeffs_size * 8)
        trunc_lo = _SPIHT_HEADER_BITS
        best_trunc = trunc_hi
        eps = 1e-8
        while ((error_target - best_feasible_error) / error_target > eps
               and trunc_hi - trunc_lo > 32):
            bits = int(math.ceil((trunc_hi + trunc_lo) / 2 / 8)) * 8
            err, mean = recon_error(bits // 8)
            if err > error_target:
                trunc_lo = bits
            else:
                trunc_hi = bits
                if err >= best_feasible_error:
                    best_feasible_error = err
                    best_trunc = bits
                    mean_error = mean
        coeffs_size = int(best_trunc / 8)

    if coeffs_size <= _RESIDUAL_DROP_BYTES:  # c:811
        coeffs_size = 0
    comp = b""
    if coeffs_size > 0:
        comp = _zstd_pack(coeffs[:coeffs_size])

    # Pure-base comparison (c:819-854).
    if not pure_base_done and not env.pure_base_disabled:
        if not env.consistency_disabled:
            base2 = j2k.encode(scaled, config.base_cr, tile_rows)
            dec2 = j2k.decode(base2, minval, maxval)
            current_cr = config.base_cr
        else:
            base2, dec2 = base, decoded
        _, pure_blob, pure_dec = _search_base_cr(
            scaled, tile_rows, current_cr, img, float(minval), float(maxval),
            float(error_target), 1.0, base2, dec2)
        if len(pure_blob) < len(comp) + len(base) or pure_base_required:
            if len(pure_blob) < len(comp) + len(base):
                logger.info(
                    "Pure base compression (%d) is better than base (%d) + "
                    "residual (%d)", len(pure_blob), len(base), len(comp))
            mean_error = float(np.mean((img - pure_dec).astype(np.float64)))
            comp = b""
            coeffs_size = 0
            base = pure_blob

    if not env.mean_adjust_disabled and abs(mean_error) > 1e-18:
        minval = np.float32(float(minval) + mean_error)
        maxval = np.float32(float(maxval) + mean_error)

    return _assemble(0, minval, maxval, coeffs_size, float(rmin), float(rmax),
                     comp, base)


def encode_chunked(data: np.ndarray, config: CodecConfig) -> bytes:
    """Encode into an "EBCK" container (ebcc_encode_chunking, c:920-1052)."""
    data = np.ascontiguousarray(data, dtype=np.float32).reshape(config.dims)
    dims = tuple(int(d) for d in config.dims)
    chunk_dims = tuple(int(c) for c in config.chunk_dims)
    if all(c == 0 for c in chunk_dims):
        chunk_dims = dims
    if any(c == 0 for c in chunk_dims):
        raise ValueError("dims and chunk_dims must be non-zero")
    _layout(chunk_dims)
    counts = tuple(-(-d // c) for d, c in zip(dims, chunk_dims))
    num_chunks = int(np.prod(counts))
    chunk_size = int(np.prod(chunk_dims))

    from ..core.codec import _gather_chunks
    chunks = _gather_chunks(data, chunk_dims, counts)

    chunk_cfg = CodecConfig(dims=chunk_dims, base_cr=config.base_cr,
                            residual_mode=config.residual_mode,
                            error=config.error)
    out = [_CHUNK_HEADER.pack(MAGIC_CONTAINER, VERSION, 3, 0, *dims,
                              *chunk_dims, num_chunks, chunk_size)]
    env = _EncodeEnv.from_env()
    for i in range(num_chunks):
        blob = encode_frame(chunks[i], chunk_cfg, env)
        out.append(struct.pack("<Q", len(blob)))
        out.append(blob)
    return b"".join(out)


def encode_chunked_compat(data: np.ndarray, config: CodecConfig) -> bytes:
    """Default-tiling + global REL->MAX conversion
    (ebcc_encode_chunking_compat, c:1054-1090)."""
    data = np.ascontiguousarray(data, dtype=np.float32).reshape(config.dims)
    chunk_dims = tuple(int(c) for c in config.chunk_dims)
    if all(c == 0 for c in chunk_dims):
        chunk_dims = (1,
                      1024 if config.dims[1] > _MAX_DIM else config.dims[1],
                      1024 if config.dims[2] > _MAX_DIM else config.dims[2])
    mode, error = config.residual_mode, config.error
    if mode == RESIDUAL_RELATIVE_ERROR:
        if not np.isfinite(data).all():
            raise ValueError("NaN or Inf in legacy encode input")
        error = float(error) * float(data.max() - data.min())
        mode = RESIDUAL_MAX_ERROR
    cfg = CodecConfig(dims=config.dims, base_cr=config.base_cr,
                      residual_mode=mode, error=error, chunk_dims=chunk_dims)
    return encode_chunked(data, cfg)
