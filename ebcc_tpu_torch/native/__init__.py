"""ctypes bindings of the port's host C++ (``ebcc_tpu_torch/csrc/host/``).

The port's counterpart of ``ebcc_tpu/native/__init__.py``, with the same
names and signatures: the CAB coders (entropy backends 2 and 4), the
sparse packer and unpacker of the plane payloads, the Rice coders of the
exchange (``rice_decode``, ``rice_decode_gaps_classed``,
``rice_decode_classed``, ``rice_block_pack``), the legacy SPIHT coder
(``spiht_encode``, ``spiht_decode``) and the whole host codec
(``native_encode``, ``native_encode_chunked``, ``native_decode``) that
``EBCC_ENCODE_BACKEND`` / ``EBCC_DECODE_BACKEND`` = ``native`` route to.

Three libraries, built by :mod:`ebcc_tpu_torch.ops._build` at first use:
``libebcc_host.so`` (the coders, the packer, the unpacker, the Rice and
SPIHT coders; no dependency), ``libebcc_native_codec.so`` (the host codec;
links ``libzstd.so.1``, so only native routing needs it) and the HDF5
filter plugin (filter id 33030, as the JAX package's: a process's
``HDF5_PLUGIN_PATH`` names one package's directory, :func:`plugin_dir`
here).  A library that cannot be built raises ``RuntimeError``; nothing
falls back.  ctypes releases the GIL around each call, so a thread pool
runs the unpacker in parallel.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

import numpy as np

from ..ops import _build

_U8P = ctypes.POINTER(ctypes.c_ubyte)
_I32 = np.ctypeslib.ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(ctypes.c_ubyte, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(ctypes.c_float, flags="C_CONTIGUOUS")
_U32 = np.ctypeslib.ndpointer(ctypes.c_uint32, flags="C_CONTIGUOUS")
_U16 = np.ctypeslib.ndpointer(ctypes.c_uint16, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(ctypes.c_int64, flags="C_CONTIGUOUS")
_COMPRESS_ARGS = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.POINTER(_U8P)]
_DECOMPRESS_ARGS = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    _U8, ctypes.c_size_t]


class _ConfigStruct(ctypes.Structure):
    """ctypes mirror of etpu_config_t (csrc/host/etpu_codec.h)."""

    _fields_ = [
        ("dims", ctypes.c_uint64 * 3),
        ("base_cr", ctypes.c_float),
        ("residual_mode", ctypes.c_int32),
        ("error", ctypes.c_float),
        ("chunk_dims", ctypes.c_uint64 * 3),
        ("zstd_level", ctypes.c_int32),
        ("entropy_backend", ctypes.c_int32),
        ("temporal", ctypes.c_int32),
        ("allow_nan", ctypes.c_int32),
    ]


_host_lib = None
_codec_lib = None
_libc_free = None


def _host():
    """``libebcc_host.so``, built and bound on first use."""
    global _host_lib
    if _host_lib is None:
        _host_lib = bind_host(_build.load_host("ebcc_host"))
    return _host_lib


def bind_host(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the functions of a loaded ``libebcc_host.so`` (either build,
    PGO or plain) and return it."""
    global _libc_free
    for fn in ("etpu_cab_compress", "etpu_cab2_compress"):
        getattr(lib, fn).restype = ctypes.c_size_t
        getattr(lib, fn).argtypes = _COMPRESS_ARGS
    for fn in ("etpu_cab_decompress", "etpu_cab2_decompress"):
        getattr(lib, fn).restype = ctypes.c_size_t
        getattr(lib, fn).argtypes = _DECOMPRESS_ARGS
    lib.etpu_planes_to_sparse.restype = ctypes.c_size_t
    lib.etpu_planes_to_sparse.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _I32, _I32]
    lib.etpu_sparse_to_planes.restype = ctypes.c_int
    lib.etpu_sparse_to_planes.argtypes = [
        _I32, _I32, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8]
    lib.etpu_rice_decode.restype = ctypes.c_size_t
    lib.etpu_rice_decode.argtypes = [_U32, ctypes.c_size_t, ctypes.c_size_t,
                                     _I32]
    lib.etpu_rice_decode_gaps_classed.restype = ctypes.c_size_t
    lib.etpu_rice_decode_gaps_classed.argtypes = [
        _U32, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        _U8, _I32]
    lib.etpu_rice_decode_classed.restype = ctypes.c_size_t
    lib.etpu_rice_decode_classed.argtypes = [
        _U32, ctypes.c_size_t, ctypes.c_size_t, _U8, _U8, _I32]
    lib.etpu_rice_block_pack.restype = ctypes.c_size_t
    lib.etpu_rice_block_pack.argtypes = [
        _I64, _I32, ctypes.c_size_t, ctypes.c_int, _U32, _U16, _U16, _U8,
        _I32]
    lib.etpu_has_spiht.restype = ctypes.c_int
    lib.etpu_has_spiht.argtypes = []
    lib.etpu_spiht_encode.restype = ctypes.c_size_t
    lib.etpu_spiht_encode.argtypes = [
        _F32, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.POINTER(_U8P)]
    lib.etpu_spiht_decode.restype = ctypes.c_int
    lib.etpu_spiht_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, _F32, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_size_t]
    # The coders return buffers from malloc; this library has no etpu_free.
    if _libc_free is None:
        libc = ctypes.CDLL(ctypes.util.find_library("c"))
        libc.free.argtypes = [ctypes.c_void_p]
        libc.free.restype = None
        _libc_free = libc.free
    return lib


def load_host():
    """``libebcc_host.so``, built and bound on first use (``RuntimeError``
    when it cannot be built)."""
    return _host()


def load_codec():
    """``libebcc_native_codec.so``, built and bound on first use."""
    global _codec_lib
    if _codec_lib is not None:
        return _codec_lib
    try:
        lib = _build.load_host("ebcc_native_codec")
    except RuntimeError as e:
        raise RuntimeError(
            "native routing needs libebcc_native_codec.so, which links zstd "
            "(libzstd.so.1); it could not be built: " + str(e)) from e
    lib.etpu_decode.restype = ctypes.c_size_t
    lib.etpu_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.etpu_encode.restype = ctypes.c_size_t
    lib.etpu_encode.argtypes = [_F32, ctypes.POINTER(_ConfigStruct),
                                ctypes.POINTER(_U8P)]
    lib.etpu_encode_chunked.restype = ctypes.c_size_t
    lib.etpu_encode_chunked.argtypes = lib.etpu_encode.argtypes
    lib.etpu_free.argtypes = [ctypes.c_void_p]
    lib.etpu_free.restype = None
    _codec_lib = lib
    return lib


def plugin_dir() -> str:
    """The directory of the port's HDF5 filter plugin (filter id 33030),
    built on first use, for ``HDF5_PLUGIN_PATH`` or ``h5py.h5pl.append``.
    It holds the plugin alone: HDF5 opens every library of a plugin
    directory.  The JAX package's plugin has the same filter id, so a
    process names one of the two directories."""
    return os.path.dirname(_build.build_host(_build.PLUGIN))


def _take(out, n: int, free) -> bytes:
    """Copy ``n`` bytes of a C-allocated buffer, then free it."""
    try:
        return bytes(ctypes.cast(out, ctypes.POINTER(ctypes.c_ubyte * n))
                     .contents)
    finally:
        free(out)


def _make_config(config) -> _ConfigStruct:
    c = _ConfigStruct()
    for i in range(3):
        c.dims[i] = config.dims[i]
        c.chunk_dims[i] = config.chunk_dims[i]
    c.base_cr = config.base_cr
    c.residual_mode = config.residual_mode
    c.error = config.error
    c.zstd_level = config.zstd_level
    c.entropy_backend = {"zstd": 1, "cab": 2, "auto": 3, "cab2": 4}.get(
        getattr(config, "entropy_backend", "zstd"), 1)
    c.temporal = 1 if getattr(config, "temporal", False) else 0
    c.allow_nan = 1 if getattr(config, "allow_nan", False) else 0
    return c


def _encode_with(fn, data: np.ndarray, config, what: str) -> bytes:
    lib = load_codec()
    data = np.ascontiguousarray(data, dtype=np.float32).ravel()
    cfg = _make_config(config)
    out = _U8P()
    n = getattr(lib, fn)(data, ctypes.byref(cfg), ctypes.byref(out))
    if n == 0:
        raise RuntimeError(f"native {what} failed")
    return _take(out, n, lib.etpu_free)


def native_encode(data: np.ndarray, config) -> bytes:
    """Encode through the host codec (single chunk) -> ETPU stream."""
    return _encode_with("etpu_encode", data, config, "encode")


def native_encode_chunked(data: np.ndarray, config) -> bytes:
    """Chunked encode through the host codec -> ETPK container."""
    return _encode_with("etpu_encode_chunked", data, config, "chunked encode")


def native_decode(blob: bytes) -> np.ndarray:
    """Decode an ETPU stream or ETPK container through the host codec ->
    flat float32 values."""
    lib = load_codec()
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.etpu_decode(blob, len(blob), ctypes.byref(out))
    if n == 0:
        raise RuntimeError("native decode failed")
    try:
        return np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.etpu_free(out)


def _cab_compress(fn: str, payload: bytes, kept, d0, hp, wp,
                  levels) -> bytes:
    lib = _host()
    out = _U8P()
    n = getattr(lib, fn)(payload, len(payload), kept, d0, hp, wp, levels,
                         ctypes.byref(out))
    if n == 0:
        raise RuntimeError(f"{fn} failed")
    return _take(out, n, _libc_free)


def _cab_decompress(fn: str, comp: bytes, kept, d0, hp, wp,
                    levels) -> bytes:
    lib = _host()
    size = (kept + 1) * d0 * hp * (wp // 8)
    buf = np.zeros(size, np.uint8)
    if getattr(lib, fn)(comp, len(comp), kept, d0, hp, wp, levels, buf,
                        size) != size:
        raise ValueError(f"corrupt {'CAB2' if 'cab2' in fn else 'CAB'} "
                         "payload")
    return buf.tobytes()


def cab_compress(payload: bytes, kept: int, d0: int, hp: int, wp: int,
                 levels: int) -> bytes:
    """Context-adaptive arithmetic compression of a raw layer payload
    (entropy backend 2; csrc/host/cab_coder.cc)."""
    return _cab_compress("etpu_cab_compress", payload, kept, d0, hp, wp,
                         levels)


def cab_decompress(comp: bytes, kept: int, d0: int, hp: int, wp: int,
                   levels: int) -> bytes:
    return _cab_decompress("etpu_cab_decompress", comp, kept, d0, hp, wp,
                           levels)


def cab2_compress(payload: bytes, kept: int, d0: int, hp: int, wp: int,
                  levels: int) -> bytes:
    """The relaxed-eligibility CAB profile (entropy backend 4): fewer coder
    calls than backend 2 for a slightly larger stream."""
    return _cab_compress("etpu_cab2_compress", payload, kept, d0, hp, wp,
                         levels)


def cab2_decompress(comp: bytes, kept: int, d0: int, hp: int, wp: int,
                    levels: int) -> bytes:
    return _cab_decompress("etpu_cab2_decompress", comp, kept, d0, hp, wp,
                           levels)


def planes_to_sparse(raw: bytes, kept: int, pb: int, d0: int, hp: int,
                     wp: int):
    """Dense plane payload (``kept - 1`` full rows, a last row of ``pb``
    bytes, the sign row) -> (int32 positions, signed int32 magnitudes at
    the cut), positions ascending; byte columns zero in every kept row are
    skipped (csrc/host/sparse_unpack.cc)."""
    lib = _host()
    n = d0 * hp * wp
    idx = np.empty(n, np.int32)
    vals = np.empty(n, np.int32)
    k = lib.etpu_planes_to_sparse(raw, len(raw), kept, pb, d0, hp, wp,
                                  idx, vals)
    if k == ctypes.c_size_t(-1).value:
        raise ValueError("malformed plane payload")
    return idx[:k], vals[:k]


def sparse_to_planes(pos: np.ndarray, vals: np.ndarray, shift: int,
                     msb: int, d0: int, hp: int, wp: int) -> bytes:
    """(positions, signed values at the stored cut) -> the dense plane
    payload at ``stored cut + shift``: ``msb`` magnitude rows MSB first,
    then the sign row of the coefficients still significant; the inverse
    of :func:`planes_to_sparse`."""
    lib = _host()
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.int32)
    payload = np.empty((msb + 1) * (d0 * hp * (wp // 8)), np.uint8)
    if lib.etpu_sparse_to_planes(pos, vals, pos.size, shift, msb, d0, hp, wp,
                                 payload) != 0:
        raise ValueError("sparse_to_planes: bad geometry")
    return payload.tobytes()


def rice_decode(words: np.ndarray, nnz: int) -> np.ndarray:
    """Decode a device-packed Rice value stream (``transfer.rice_pack``)."""
    lib = _host()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    out = np.empty(nnz, np.int32)
    if lib.etpu_rice_decode(words, words.size, nnz, out) != nnz:
        raise ValueError("corrupt rice exchange payload")
    return out


def rice_decode_gaps_classed(words: np.ndarray, nnz: int, hp: int, wp: int,
                             ks: np.ndarray) -> np.ndarray:
    """Decode the previous-position-classed gap stream straight to sorted
    positions (``transfer.rice_pack_pair`` with ``a_cls``)."""
    lib = _host()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    ks = np.ascontiguousarray(ks, dtype=np.uint8)
    out = np.empty(nnz, np.int32)
    if lib.etpu_rice_decode_gaps_classed(words, words.size, nnz, hp, wp, ks,
                                         out) != nnz:
        raise ValueError("corrupt classed gap exchange payload")
    return out


def rice_decode_classed(words: np.ndarray, nnz: int, cls: np.ndarray,
                        ks: np.ndarray) -> np.ndarray:
    """Decode the subband-classed Rice value stream: element i uses Rice
    parameter ks[cls[i]] (``transfer.rice_pack_pair`` with ``b_cls``)."""
    lib = _host()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    cls = np.ascontiguousarray(cls, dtype=np.uint8)
    ks = np.ascontiguousarray(ks, dtype=np.uint8)
    out = np.empty(nnz, np.int32)
    if lib.etpu_rice_decode_classed(words, words.size, nnz, cls, ks,
                                    out) != nnz:
        raise ValueError("corrupt classed rice exchange payload")
    return out


def rice_block_pack(idx: np.ndarray, vals: np.ndarray, block: int = 128):
    """Blocked-Rice packer of the decode-direction upload (the C twin of
    ``transfer.rice_block_pack_host``, same outputs; it releases the GIL)
    -> (words, lens_g, lens_v, k_packed, base_pos, n_blocks)."""
    lib = _host()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.int32)
    n = int(idx.size)
    nb = max(1, -(-n // block))
    words = np.empty((104 * max(n, 1)) // 32 + 4, np.uint32)
    lens_g = np.empty(nb, np.uint16)
    lens_v = np.empty(nb, np.uint16)
    k_packed = np.empty(nb, np.uint8)
    base_pos = np.empty(nb, np.int32)
    used = lib.etpu_rice_block_pack(idx, vals, n, block, words, lens_g,
                                    lens_v, k_packed, base_pos)
    if used == 0:
        raise ValueError("rice_block_pack failed")
    # +3 zero words: the device reads a 3-word window at the last code's
    # offset (the window's first word is clipped to nw - 3).
    words[used:used + 3] = 0
    return words[:used + 3].copy(), lens_g, lens_v, k_packed, base_pos, nb


def spiht_encode(norm: np.ndarray, trunc_bits: int = 0,
                 num_stages: int = 3) -> bytes:
    """Encode a [0,1]-normalized 2-D residual into a legacy SPIHT "IMS"
    stream (reference-format interop; csrc/host/spiht_coder.cc)."""
    lib = _host()
    norm = np.ascontiguousarray(norm, dtype=np.float32)
    if norm.ndim != 2:
        raise ValueError("spiht_encode expects a 2-D frame")
    out = _U8P()
    n = lib.etpu_spiht_encode(norm, norm.shape[0], norm.shape[1],
                              trunc_bits, num_stages, ctypes.byref(out))
    if n == 0:
        raise RuntimeError("SPIHT encode failed (bad dims or input range)")
    return _take(out, n, _libc_free)


def spiht_decode(blob: bytes, height: int, width: int,
                 num_bits: int) -> np.ndarray:
    """Decode a legacy SPIHT "IMS" stream (possibly truncated) back to the
    [0,1]-normalized residual frame."""
    lib = _host()
    out = np.zeros((height, width), np.float32)
    rc = lib.etpu_spiht_decode(blob, len(blob), out, height, width, num_bits)
    if rc != 0:
        raise ValueError(f"corrupt SPIHT stream (code {rc})")
    return out
