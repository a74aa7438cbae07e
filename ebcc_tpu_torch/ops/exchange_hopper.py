"""The decode-direction exchange kernel for Hopper: X1, the blocked-Rice
lane decode.

:func:`rice_unpack_qflat` replaces the JAX package's XLA scan
``transfer.rice_block_unpack`` (``ebcc_tpu/core/transfer.py:842``, a
``lax.scan`` of 128 steps over every gap and value lane) and the scatter
that follows it in ``kernels.rice_unpack_qflat``: blocked-Rice lanes in,
the dense int32 coefficient vector ``qflat`` of both layers out.  The
kernel is CUDA C++ for sm_90a in ``ebcc_tpu_torch/csrc/exchange.cu``
(design and bound there), built by ``ops/_build.py`` at first use: one
call clears ``qflat`` (a memset), scans the lane lengths into chunk
offsets (:func:`rice_chunk_offsets_plain` is that scan's plain version) and
gives each 128-element block a warp that decodes the block's gap lane and
value lane from shared memory and stores each value at its position.

A CUDA tensor goes to the kernel, and anything it does not take raises; a
CPU tensor goes to :func:`rice_unpack_qflat_plain` (the 128-step loop of
``core.transfer.rice_block_unpack`` and one scatter), which the kernel is
bit-equal to.  The wrapper counts its calls that launch the kernel
(:data:`LAUNCHES`); :func:`cuda_kernels_launched` is the library's own
count at its launch site.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..core import transfer
from . import _build
from .dwt_hopper import LaunchCounter

LAUNCHES = {"rice_unpack_qflat": LaunchCounter()}


def reset_launch_counts():
    for c in LAUNCHES.values():
        c.reset()


def launch_counts() -> dict:
    return {k: c.value for k, c in LAUNCHES.items()}


_SIG_LOCK = threading.Lock()


def _lib():
    lib = _build.load("exchange")
    with _SIG_LOCK:
        if not getattr(lib, "_ebcc_sigs", False):
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ebcc_rice_unpack_qflat.argtypes = [p, ll, p, p, p, p, p, i,
                                                   ll, p, p, p]
            lib.ebcc_rice_unpack_qflat.restype = i
            lib.ebcc_exchange_kernels_launched.argtypes = []
            lib.ebcc_exchange_kernels_launched.restype = ll
            lib._ebcc_sigs = True
    return lib


def cuda_kernels_launched() -> int:
    """CUDA kernels the exchange library has launched since it was loaded,
    counted at its launch site."""
    return _lib().ebcc_exchange_kernels_launched()


def rice_unpack_qflat_plain(words, lens_g, lens_v, k_packed, base_pos, nnz,
                            *, n_blocks: int, s: int):
    """Plain version of :func:`rice_unpack_qflat`: the 128-step lane loop,
    then one scatter of the valid (position, value) pairs."""
    idx, vals = transfer.rice_block_unpack(
        words, lens_g, lens_v, k_packed, base_pos, int(nnz),
        n_blocks=n_blocks)
    qflat = torch.zeros(2 * s, dtype=torch.int32, device=words.device)
    keep = (idx >= 0) & (idx < 2 * s)
    qflat[idx[keep]] = vals[keep]
    return qflat


def rice_chunk_offsets_plain(lens_g, lens_v):
    """Plain version of X1's offset scan: for each chunk of 32 lanes the
    exclusive start bit of its gap lanes, then of its value lanes within
    the value region, then the total gap bits -> (2 * nc + 1,) int64.  A
    lane's start is its chunk's plus the lengths before it in the chunk
    (the value lanes' plus the total gap bits), which equals
    ``transfer.rice_lane_offsets``."""
    nb = lens_g.shape[0]
    nc = -(-nb // 32)
    lens = torch.zeros((2, nc * 32), dtype=torch.int64, device=lens_g.device)
    lens[0, :nb] = lens_g.to(torch.int64) & 0xFFFF
    lens[1, :nb] = lens_v.to(torch.int64) & 0xFFFF
    chunk = lens.reshape(2, nc, 32).sum(2)
    start = torch.cumsum(chunk, 1) - chunk
    return torch.cat([start.reshape(-1), chunk[0].sum().reshape(1)])


def _check(t, dtype, n, name, dev):
    if t.device != dev or t.dtype != dtype or t.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D {dtype} tensor on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if n is not None and t.shape[0] < n:
        raise ValueError(f"{name}: {t.shape[0]} entries, {n} needed")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def rice_unpack_qflat(words, lens_g, lens_v, k_packed, base_pos, nnz, *,
                      n_blocks: int, s: int):
    """Blocked-Rice lanes -> (2 * s,) int32 ``qflat`` (X1).

    words: (nw,) int32 bits of the uint32 word stream (nw >= 3, zero words
    after the last code); lens_g, lens_v: (>= n_blocks,) int16 bits of the
    u16 block bit lengths; k_packed: (>= n_blocks,) uint8; base_pos: (>=
    n_blocks,) int32; nnz: the pair count, an int or a one-element int32
    tensor (on the card it is read there, with no synchronisation); s: the
    coefficients of one layer.  Lanes past ``nnz`` must have length 0.
    CPU tensors take :func:`rice_unpack_qflat_plain`."""
    dev = words.device
    if dev.type == "cpu":
        return rice_unpack_qflat_plain(words, lens_g, lens_v, k_packed,
                                       base_pos, nnz, n_blocks=n_blocks, s=s)
    if dev.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {dev}")
    nb = int(n_blocks)
    _check(words, torch.int32, 3, "words", dev)
    _check(lens_g, torch.int16, nb, "lens_g", dev)
    _check(lens_v, torch.int16, nb, "lens_v", dev)
    _check(k_packed, torch.uint8, nb, "k_packed", dev)
    _check(base_pos, torch.int32, nb, "base_pos", dev)
    if nb <= 0:
        raise ValueError("n_blocks must be positive")
    nnz_t = torch.as_tensor(nnz, dtype=torch.int32, device=dev).reshape(1)
    lib = _lib()
    chunk_off = torch.empty(2 * (-(-nb // 32)) + 1, dtype=torch.int64,
                            device=dev)
    qflat = torch.empty(2 * s, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ebcc_rice_unpack_qflat(
            words.data_ptr(), words.shape[0], lens_g.data_ptr(),
            lens_v.data_ptr(), k_packed.data_ptr(), base_pos.data_ptr(),
            nnz_t.data_ptr(), nb, 2 * s, chunk_off.data_ptr(),
            qflat.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rice lane decode kernel: CUDA error {err}")
    LAUNCHES["rice_unpack_qflat"].add()
    return qflat
