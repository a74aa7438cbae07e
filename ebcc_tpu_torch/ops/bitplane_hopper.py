"""The coded-size estimate's kernel for Hopper: the plane statistics of
:func:`ops.bitplane.estimated_code_bytes_plain` in one pass over q.

The JAX package leaves the estimate to XLA, which fuses it; in plain
PyTorch it is about a full pass over the batch per plane and per cut (214
CUDA kernels a call at 13 planes, 349 at 22), and the encode core runs it 8
times a batch that takes the residual sweep.  :func:`estimated_code_bytes`
is two CUDA launches instead (``ebcc_tpu_torch/csrc/bitplane.cu``, design
and bound there, built by ``ops/_build.py`` at first use): one counts, per
group of the trailing two axes, each plane's 1-bits and each cut's
significant coefficients as exact integers, the other forms the
``(P + 1, ...)`` table with the plain version's float32 steps in its
order, so the table is bit-equal to the plain version run on the same
card.

``ops.bitplane.estimated_code_bytes`` sends a CPU tensor to the plain
version and any other here, where anything the kernel does not take raises.
The wrapper counts its calls that launch the kernels (:data:`LAUNCHES`);
:func:`cuda_kernels_launched` is the library's own count at its launch site.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import _build, bitplane
from .dwt_hopper import LaunchCounter, ReplayedCall, note_call

LAUNCHES = {"code_size_stats": LaunchCounter()}


def reset_launch_counts():
    for c in LAUNCHES.values():
        c.reset()


def launch_counts() -> dict:
    return {k: c.value for k, c in LAUNCHES.items()}


_SIG_LOCK = threading.Lock()


def _lib():
    lib = _build.load("bitplane")
    with _SIG_LOCK:
        if not getattr(lib, "_ebcc_sigs", False):
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ebcc_code_size_stats.argtypes = [p, i, ll, i, ctypes.c_float,
                                                 i, p, p, p]
            lib.ebcc_code_size_stats.restype = i
            lib.ebcc_code_size_partials.argtypes = [i, ll, i]
            lib.ebcc_code_size_partials.restype = ll
            lib.ebcc_bitplane_kernels_launched.argtypes = []
            lib.ebcc_bitplane_kernels_launched.restype = ll
            lib.ebcc_bitplane_thread_launched.argtypes = []
            lib.ebcc_bitplane_thread_launched.restype = ll
            lib.ebcc_bitplane_add_launched.argtypes = [ll]
            lib.ebcc_bitplane_add_launched.restype = None
            lib._ebcc_sigs = True
    return lib


def cuda_kernels_launched() -> int:
    """CUDA kernels the estimate's library has launched since it was
    loaded, counted at its launch site."""
    return _lib().ebcc_bitplane_kernels_launched()


def thread_kernels_launched() -> int:
    """The library's count of the kernels launched from this thread."""
    return _lib().ebcc_bitplane_thread_launched()


def add_kernels_launched(n: int) -> None:
    """Adds ``n`` kernels that a CUDA graph replay ran to the library's
    count."""
    _lib().ebcc_bitplane_add_launched(n)


def estimated_code_bytes(q, num_planes: int, zstd_efficiency: float = 1.35):
    """``(num_planes + 1, ...)`` float32 estimated coded sizes of the int32
    q over its trailing two axes, bit-equal to
    ``bitplane.estimated_code_bytes_plain`` on the same card.  A
    :class:`~.dwt_hopper.ReplayedCall` is counted and launches nothing."""
    if isinstance(q, ReplayedCall):
        LAUNCHES["code_size_stats"].add()
        return None
    if q.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {q.device}")
    if q.dtype != torch.int32:
        raise TypeError(f"expected torch.int32, got {q.dtype}")
    if q.dim() < 2 or not q.is_contiguous():
        raise ValueError(f"expected a contiguous tensor of 2 or more axes, "
                         f"got {tuple(q.shape)}")
    if not 1 <= num_planes <= 32:
        raise ValueError(f"num_planes {num_planes} outside 1..32")
    lead = tuple(q.shape[:-2])
    groups, n = math.prod(lead), q.shape[-1] * q.shape[-2]
    if n == 0 or not 0 < groups <= 65535:
        raise ValueError(f"{groups} groups of {n} coefficients: the kernel "
                         f"takes 1..65535 nonempty groups")
    lib = _lib()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    with torch.cuda.device(q.device):
        partial = torch.empty(lib.ebcc_code_size_partials(groups, n, sms),
                              dtype=torch.int32, device=q.device)
        sizes = torch.empty((num_planes + 1, groups), dtype=torch.float32,
                            device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ebcc_code_size_stats(
            q.data_ptr(), groups, n, num_planes, zstd_efficiency, sms,
            partial.data_ptr(), sizes.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"code size kernel: CUDA error {err}")
    LAUNCHES["code_size_stats"].add()
    # A replay makes the call again through the estimate's entry point.
    note_call(bitplane, "estimated_code_bytes", q, num_planes,
              zstd_efficiency)
    return sizes.reshape((num_planes + 1,) + lead)
