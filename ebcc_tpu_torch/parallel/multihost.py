"""Several processes writing one ETPK container, over ``torch.distributed``.

Counterpart of ``ebcc_tpu/parallel/multihost.py``.  Chunk ownership is a
pure function of (chunk index, rank): :func:`host_chunk_slice` gives each
process one contiguous run of chunks, which it gathers, codes and writes on
its own.  Chunks are independent (as EBCK's are, reference
ebcc_codec.c:1037-1044), so the container is the byte concatenation of the
processes' record runs under one header (:func:`merge_container_parts`),
byte-identical to a one-process :func:`ebcc_tpu_torch.encode_chunked`; no
process holds the whole archive, and the only collective the codec needs is
the global (min, max) of ``parallel.sharded.global_range``.

:func:`initialize` joins the process group: NCCL for processes on the card,
gloo for the CPU or when asked.  NCCL refuses two ranks on one card, so
ranks that share a card join a gloo group and still code on the card.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import CodecConfig, EncodeOptions
from ..core import codec as _codec
from ..device import resolve_device
from .mesh import process_place


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> bool:
    """Join the default ``torch.distributed`` process group -> whether a
    group is initialized afterwards.

    With ``coordinator_address`` (``host:port``, or a ``tcp://`` URL) the
    group is ``tcp://`` with ``num_processes`` ranks and rank
    ``process_id``; without it, ``env://`` when ``MASTER_ADDR`` and
    ``WORLD_SIZE`` are set (``RANK`` and ``MASTER_PORT`` too, as
    ``torch.distributed`` reads them).  With neither, or when a group is
    already initialized, nothing happens: one process runs alone.
    ``backend`` defaults to NCCL for ``device="cuda"`` (which raises
    without a card) and gloo for ``device="cpu"``.  A failed init raises."""
    dist = torch.distributed
    if dist.is_initialized():
        return True
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kw = dict(init_method=url, world_size=int(num_processes),
                  rank=int(process_id))
    elif os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        kw = dict(init_method="env://")
    else:
        return False
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, **kw)
    return True


def host_chunk_slice(num_chunks: int, process_id: int,
                     process_count: int) -> Tuple[int, int]:
    """The contiguous [start, stop) run of chunk indices owned by a process
    (empty for the last ones when there are more processes than chunks).
    Contiguous runs keep each process's output one byte range of the
    container."""
    per = -(-num_chunks // process_count)
    start = min(process_id * per, num_chunks)
    stop = min(start + per, num_chunks)
    return start, stop


def encode_owned_chunks(data: np.ndarray, config: CodecConfig,
                        opts: Optional[EncodeOptions] = None,
                        process_id: Optional[int] = None,
                        process_count: Optional[int] = None,
                        max_batch: int = _codec.DEFAULT_MAX_BATCH,
                        device="cuda") -> Tuple[List[bytes], Tuple[int, int]]:
    """Code this process's run of chunks on ``device`` (the card unless
    ``device="cpu"``) -> (streams, (start, stop)).

    Rank and world size default to the process group's, 0 and 1 without a
    group.  ``data`` may be the whole array or anything numpy can read as
    it (a lazily read HDF5 or Zarr array)."""
    dev = resolve_device(device)
    opts = opts or EncodeOptions.from_env()
    rank, world = process_place()
    pid = rank if process_id is None else process_id
    pcount = world if process_count is None else process_count
    chunks, header = _codec._container_chunks(data, config)
    start, stop = host_chunk_slice(header.num_chunks, pid, pcount)
    if start >= stop:
        return [], (start, stop)
    streams = _codec._encode_chunk_set(
        chunks[start:stop], config.per_chunk(header.chunk_dims), opts,
        max_batch, dev)
    return streams, (start, stop)


def container_part(streams: List[bytes]) -> bytes:
    """One process's streams as a run of container records
    (``[u64 size][stream]`` each)."""
    return b"".join(struct.pack("<Q", len(s)) + s for s in streams)


def merge_container_parts(config: CodecConfig, parts: List[bytes]) -> bytes:
    """The processes' record runs, in chunk order, under one ETPK header ->
    the container a one-process encode writes."""
    return _codec._container_header(config).pack() + b"".join(parts)
