"""Streaming storage pipeline: file-to-file compression with the reading of
the source overlapped against the codec (counterpart of
``ebcc_tpu/io/pipeline.py``).

A reader thread prefetches the next slab of chunks (the chunks of one
leading chunk index) from the source (HDF5 dataset, ``np.memmap`` or any
array-like that takes basic slicing) while the codec works on the current
slab, and the chunk records are written to the output container as they
come: peak memory is two slabs whatever the archive's size.  Record order is
``encode_chunked``'s, so the streamed container is byte-identical to an
in-memory encode.

Containers also grow in place (:func:`append_chunked_file`) and are repaired
after an append was killed (:func:`repair_chunked_file`).  Every function
that codes runs on ``device``, the CUDA card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import IO, Optional

import numpy as np

from ..config import CodecConfig, EncodeOptions
from ..core import codec as _codec
from ..core import stream
from ..device import resolve_device
from ..utils.logging import logger


def _slab_chunks(data, config: CodecConfig, chunk_dims, counts,
                 i0: int) -> np.ndarray:
    """Slab i0 (every chunk with leading chunk index i0), edge-padded, in
    chunk-linear order."""
    c0 = chunk_dims[0]
    lo = i0 * c0
    hi = min(lo + c0, config.dims[0])
    slab = np.asarray(data[lo:hi], dtype=np.float32)
    if hi - lo < c0:  # pad the leading dim by edge replication
        pad = np.repeat(slab[-1:], c0 - (hi - lo), axis=0)
        slab = np.concatenate([slab, pad], axis=0)
    return _codec._gather_chunks(slab, chunk_dims, (1, counts[1], counts[2]))


def compress_stream(data, config: CodecConfig, out: IO[bytes],
                    opts: Optional[EncodeOptions] = None,
                    max_batch: int = _codec.DEFAULT_MAX_BATCH,
                    device="cuda") -> int:
    """Compress an array-like (h5py dataset, np.memmap, ndarray) of shape
    ``config.dims`` into ``out`` as an ETPK container, one slab at a time.
    Returns the bytes written.  Each slab's chunks go through the same
    chunk-set encode as :func:`encode_chunked` (the pointwise log check
    against that slab), so the bytes are the same."""
    dev = resolve_device(device)
    opts = opts or EncodeOptions.from_env()
    header = _codec._container_header(config)
    chunk_dims = header.chunk_dims
    counts = _codec._chunk_grid(config.dims, chunk_dims)
    layout = _codec._layout(chunk_dims)
    chunk_cfg = config.per_chunk(chunk_dims)
    written = out.write(header.pack())
    with ThreadPoolExecutor(max_workers=1) as reader:
        fut = reader.submit(_slab_chunks, data, config, chunk_dims, counts, 0)
        for i0 in range(counts[0]):
            chunks = fut.result()
            if i0 + 1 < counts[0]:
                fut = reader.submit(_slab_chunks, data, config, chunk_dims,
                                    counts, i0 + 1)
            streams = _codec._encode_chunk_set(
                chunks.reshape(-1, *layout), chunk_cfg, opts, max_batch, dev)
            for s in streams:
                written += out.write(struct.pack("<Q", len(s)))
                written += out.write(s)
    logger.info("streamed %d chunks, %d bytes", header.num_chunks, written)
    return written


def compress_hdf5(src_path: str, variable: str, dst_path: str,
                  config_kwargs: Optional[dict] = None,
                  opts: Optional[EncodeOptions] = None,
                  device="cuda") -> int:
    """Compress one variable of an HDF5/netCDF4 file into an ETPK file.

    A 3-D dataset is read lazily slab by slab; other ranks are read whole
    with their leading dims flattened.  ``config_kwargs`` feed CodecConfig
    (dims are inferred; chunk dims default to one frame)."""
    import h5py

    with h5py.File(src_path, "r") as f:
        dset = f[variable]
        shape = dset.shape
        if len(shape) < 2:
            raise ValueError("need at least 2-D data")
        dims = (int(np.prod(shape[:-2], dtype=np.int64)) or 1,
                shape[-2], shape[-1])
        kw = dict(config_kwargs or {})
        kw.setdefault("chunk_dims", (1, dims[1], dims[2]))
        config = CodecConfig(dims=dims, **kw)
        src = dset if len(shape) == 3 else dset[...].reshape(dims)
        with open(dst_path, "wb") as out:
            return compress_stream(src, config, out, opts, device=device)


def decompress_stream(inp: IO[bytes],
                      max_batch: int = _codec.DEFAULT_MAX_BATCH,
                      device="cuda") -> np.ndarray:
    """Decode an ETPK container from a readable binary stream."""
    return _codec.decode_chunked(inp.read(), max_batch=max_batch,
                                 device=device)


def _append_precheck(header, data: np.ndarray) -> np.ndarray:
    d0, d1, d2 = header.dims
    c0 = header.chunk_dims[0]
    if data.ndim == 2:
        data = data[None]
    if data.ndim != 3 or data.shape[1:] != (d1, d2):
        raise ValueError(
            f"appended data must be (*, {d1}, {d2}); got {data.shape}")
    if d0 % c0 != 0:
        raise ValueError(
            "container's leading dim is not chunk-aligned (its last chunk "
            "group was edge-padded); cannot append without re-encoding")
    return data


def _encode_appended(header, data, config: CodecConfig, opts, device):
    """-> (the appended frames' chunk streams, the grown header)."""
    data = _append_precheck(header, np.asarray(data, np.float32))
    sub_cfg = dataclasses.replace(
        config, dims=(data.shape[0], *header.dims[1:]),
        chunk_dims=tuple(header.chunk_dims))
    _, new_streams = stream.iter_chunked(
        _codec.encode_chunked(data, sub_cfg, opts, device=device))
    new_header = stream.ChunkedHeader(
        dims=(header.dims[0] + data.shape[0], *header.dims[1:]),
        chunk_dims=tuple(header.chunk_dims),
        num_chunks=header.num_chunks + len(new_streams),
        chunk_size=header.chunk_size)
    return new_streams, new_header


def append_chunked(buf: bytes, data, config: CodecConfig,
                   opts: Optional[EncodeOptions] = None,
                   device="cuda") -> bytes:
    """Append frames along the leading axis of an ETPK container.

    The new frames are encoded as fresh chunk groups with the container's
    chunk dims and their records follow the existing ones; only the
    80-byte header changes.  ``config`` gives the codec knobs (the
    container does not record them); dims and chunk dims come from the
    container, whose leading dim must be a multiple of its leading chunk
    dim (else its last chunk group was edge-padded)."""
    header, chunk_streams = stream.iter_chunked(buf)
    new_streams, new_header = _encode_appended(header, data, config, opts,
                                               device)
    return stream.pack_chunked(new_header,
                               list(chunk_streams) + list(new_streams))


def append_chunked_file(path: str, data, config: CodecConfig,
                        opts: Optional[EncodeOptions] = None,
                        device="cuda") -> int:
    """In-place append to an ETPK file: the new records are written at the
    end and only the 80-byte header is rewritten.  Same contract as
    :func:`append_chunked`.  Returns the bytes appended.

    Crash posture: the header is rewritten LAST, so until that write lands
    the file reads as the old archive plus trailing bytes.  A failed write
    truncates the file back to its old size; a kill between the records
    and the header leaves trailing bytes that every reader rejects, and
    :func:`repair_chunked_file` removes them."""
    # buffering=0: the failure handler discards partial records with
    # os.ftruncate alone; a buffered truncate() flushes first, which
    # re-raises ENOSPC in the disk-full case the handler exists for.
    with open(path, "r+b", buffering=0) as f:
        header = stream.ChunkedHeader.unpack(
            f.read(stream.CHUNKED_HEADER_SIZE))
        new_streams, new_header = _encode_appended(header, data, config,
                                                   opts, device)
        old_size = f.seek(0, 2)
        written = 0

        def write_all(buf):
            mv = memoryview(buf)
            while mv:  # raw FileIO writes can be partial
                mv = mv[f.write(mv):]
            return len(buf)

        try:
            for s in new_streams:
                written += write_all(struct.pack("<Q", len(s)))
                written += write_all(s)
            os.fsync(f.fileno())
        except Exception:
            # The header still holds the old chunk count: dropping the
            # trailing bytes restores the old archive exactly.
            os.ftruncate(f.fileno(), old_size)
            raise
        f.seek(0)
        write_all(new_header.pack())
    return written


def repair_chunked_file(path: str) -> int:
    """Recover an archive whose append was killed mid-write: walk the
    records the header declares and truncate what follows them.  Returns
    the bytes removed (0 for a consistent file)."""
    with open(path, "r+b") as f:
        header = stream.ChunkedHeader.unpack(
            f.read(stream.CHUNKED_HEADER_SIZE))
        size = f.seek(0, 2)
        off = stream.CHUNKED_HEADER_SIZE
        for i in range(header.num_chunks):
            f.seek(off)
            raw = f.read(8)
            if len(raw) < 8:
                raise stream.StreamError(f"missing chunk {i} size")
            (csz,) = struct.unpack("<Q", raw)
            if off + 8 + csz > size:
                raise stream.StreamError(f"truncated chunk {i} payload")
            off += 8 + csz
        removed = size - off
        if removed:
            f.truncate(off)
    return removed
