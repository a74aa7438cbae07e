"""Encode and decode of an ETPK container over the devices of a mesh.

Counterpart of ``ebcc_tpu/parallel/sharded.py``.  The chunk grid is the one
of :func:`ebcc_tpu_torch.encode_chunked`; the chunk batch is split into one
contiguous run per device (:func:`mesh.batch_sharding`), and each run is
coded on its own device by a host thread of its own, through the same
per-chunk path as the unsharded container.  The streams are joined in chunk
order.  Every kernel codes one frame at a time and every per-chunk
reduction is exact or float64, so the container is byte-identical to
``encode_chunked``'s on every mesh (the port's rule, "byte-identical across
batch partitionings"), and the decode is bit-equal to ``decode_chunked``'s.

The one collective the codec needs is the global (min, max) of the compat
RELATIVE->MAX conversion (reference ebcc_codec.c:1078-1087):
:func:`global_range`.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..config import CodecConfig, EncodeOptions
from ..core import codec as _codec
from ..core import stream
from ..utils.logging import set_level_from_env
from . import mesh as mesh_lib


def _device_scope(dev: torch.device):
    """The calling thread's current CUDA device set to ``dev`` for a
    ``with`` block (nothing to set for the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _per_device(fn, parts) -> list:
    """``fn(device, start, stop)`` for each non-empty part, each on a host
    thread of its own inside its device's scope -> results in part
    order."""
    parts = [p for p in parts if p[2] > p[1]]

    def run(part):
        with _device_scope(part[0]):
            return fn(*part)

    if len(parts) <= 1:
        return [run(p) for p in parts]
    with ThreadPoolExecutor(max_workers=len(parts)) as pool:
        return list(pool.map(run, parts))


def global_range(data, mesh: Optional[mesh_lib.Mesh] = None) -> tuple:
    """Global ``(min, max)`` of ``data`` (a numpy array or tensor of this
    process's part) as Python floats: the leading axis split over the
    mesh's devices, each shard's min and max taken on its device and
    reduced on the host, then across the ranks of an initialized process
    group with ``all_reduce`` (MIN and MAX) of a tensor on the CPU for gloo
    and on the card for NCCL.  NaN propagates, as in numpy; an empty part
    gives ``(inf, -inf)``."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    x = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data))
    x = x.reshape(-1, 1) if x.dim() < 2 else x.flatten(1)

    def shard_range(dev, s, e):
        lo, hi = torch.aminmax(x[s:e].to(dev))
        return float(lo), float(hi)

    ranges = np.array(_per_device(shard_range, mesh_lib.batch_sharding(
        mesh, x.shape[0])) + [(np.inf, -np.inf)])
    lo, hi = float(ranges[:, 0].min()), float(ranges[:, 1].max())
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dev = (mesh.flat[0] if dist.get_backend() == "nccl"
               else torch.device("cpu"))
        t_lo = torch.tensor([lo], dtype=torch.float64, device=dev)
        t_hi = torch.tensor([hi], dtype=torch.float64, device=dev)
        dist.all_reduce(t_lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(t_hi, op=dist.ReduceOp.MAX)
        lo, hi = float(t_lo), float(t_hi)
    return lo, hi


def encode_chunked_sharded(data: np.ndarray, config: CodecConfig,
                           opts: Optional[EncodeOptions] = None,
                           mesh: Optional[mesh_lib.Mesh] = None,
                           max_batch: int = _codec.DEFAULT_MAX_BATCH) -> bytes:
    """:func:`ebcc_tpu_torch.encode_chunked` with the chunk batch split over
    ``mesh`` (default: every visible card): each device codes its
    contiguous run of chunks ``max_batch`` at a time.  The container is
    byte-identical to ``encode_chunked``'s on every mesh, in every mode:
    NaN/Inf, ``allow_nan`` and the log transform act per chunk, and a
    lossless batch is coded on the host by each run's thread."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    set_level_from_env()
    opts = opts or EncodeOptions.from_env()
    chunks, header = _codec._container_chunks(data, config)
    chunk_cfg = config.per_chunk(header.chunk_dims)
    runs = _per_device(
        lambda dev, s, e: _codec._encode_chunk_set(
            chunks[s:e], chunk_cfg, opts, max_batch, dev),
        mesh_lib.batch_sharding(mesh, header.num_chunks))
    return stream.pack_chunked(header, [s for run in runs for s in run])


def decode_chunked_sharded(buf: bytes, mesh: Optional[mesh_lib.Mesh] = None,
                           max_batch: int = _codec.DEFAULT_MAX_BATCH
                           ) -> np.ndarray:
    """Decode an ETPK container with its records split over ``mesh``
    (default: every visible card), each device decoding its run
    ``max_batch`` chunks at a time, then scattered into the array: bit-equal
    to :func:`ebcc_tpu_torch.decode_chunked`.  A plain ETPU stream goes to
    :func:`ebcc_tpu_torch.decode` on the mesh's first device."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    if buf[:4] != stream.MAGIC_CHUNKED:
        return _codec.decode(buf, device=mesh.flat[0])
    header, chunk_streams = stream.iter_chunked(buf)
    counts = _codec._container_grid(header)
    batch = _codec._decode_max_batch(header, max_batch)
    runs = _per_device(
        lambda dev, s, e: _codec._decode_chunk_arrays(
            chunk_streams[s:e], batch, dev),
        mesh_lib.batch_sharding(mesh, len(chunk_streams)))
    arr = runs[0] if len(runs) == 1 else np.concatenate(runs, axis=0)
    return _codec._scatter_chunks(arr.reshape(len(chunk_streams),
                                              *header.chunk_dims),
                                  header.dims, header.chunk_dims, counts)
