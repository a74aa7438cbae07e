"""Device meshes for scale-out over CUDA devices and processes.

Counterpart of ``ebcc_tpu/parallel/mesh.py``.  JAX drives every device of a
job from one controller through a ``jax.sharding.Mesh``; PyTorch has no such
object, so the port's mesh is a plain record: this process's devices as a
(hosts, devices) grid, with the process's rank and world size in its
``torch.distributed`` group (0 and 1 without one).

Chunks share no state (the reference's chunk loop, ebcc_codec.c:1007-1019),
so the port runs one independent slice of the chunk batch per device, each
from a host thread of its own (``parallel/sharded.py``), and processes own
contiguous runs of chunks (``parallel/multihost.py``).  Nothing is sharded
SPMD-style, so the JAX module's ``replicated`` and ``pad_batch_to_mesh``
have no counterpart: no batch is padded to the mesh size, and a device
left without chunks runs nothing.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device

BATCH_AXIS = "chunks"
HOST_AXIS = "hosts"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's devices as a (hosts, devices) grid, with its rank and
    world size.  Both axes split the chunk batch, in row-major order."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    rank: int = 0
    world_size: int = 1
    axis_names = (HOST_AXIS, BATCH_AXIS)

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def flat(self) -> List[torch.device]:
        return [d for row in self.devices for d in row]

    @property
    def size(self) -> int:
        return len(self.flat)


def process_place() -> Tuple[int, int]:
    """(rank, world size) in the default process group, (0, 1) without
    one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[Sequence[int]] = None, device="cuda",
              n: Optional[int] = None) -> Mesh:
    """A (hosts, devices) mesh over ``devices`` (default: ``n`` devices of
    kind ``device``; for the card ``cuda:0 .. n-1``, every visible one when
    ``n`` is None; for ``device="cpu"`` ``n`` CPU "devices", 1 by default).
    Raises, as every entry point does, when the card is asked for and none
    is there.  ``shape`` defaults to one row of all the devices."""
    if devices is None:
        kind = resolve_device(device)
        if kind.type == "cuda":
            count = torch.cuda.device_count()
            n = count if n is None else n
            if not 1 <= n <= count:
                raise ValueError(f"{n} CUDA devices asked for, {count} "
                                 "visible")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [kind] * (1 if n is None else n)
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    rows, cols = tuple(shape) if shape is not None else (1, len(devices))
    if rows * cols != len(devices):
        raise ValueError(f"mesh shape {(rows, cols)} does not hold "
                         f"{len(devices)} devices")
    rank, world = process_place()
    grid = tuple(tuple(devices[r * cols:(r + 1) * cols]) for r in range(rows))
    return Mesh(grid, rank, world)


def batch_sharding(mesh: Mesh,
                   num_chunks: int) -> List[Tuple[torch.device, int, int]]:
    """The contiguous split of a batch of ``num_chunks`` chunks over the
    mesh's devices -> one ``(device, start, stop)`` per device, in mesh
    order; run lengths differ by at most one, the longer ones first."""
    per, extra = divmod(num_chunks, mesh.size)
    out, start = [], 0
    for i, dev in enumerate(mesh.flat):
        stop = start + per + (i < extra)
        out.append((dev, start, stop))
        start = stop
    return out
