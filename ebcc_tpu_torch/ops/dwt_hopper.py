"""Fused wavelet kernels for Hopper: the port's counterpart of
``ebcc_tpu/ops/dwt_pallas.py``.

* :func:`dwt2d_quantize` replaces K1, ``dwt2d_quantize_pallas``: forward
  multi-level CDF 9/7 transform per frame, truncated toward zero to int32.
* :func:`dwt2d_transform` is the same kernel with the truncation switched
  off; it runs the residual layer's forward transform, which the reference
  leaves to XLA (``ebcc_tpu/core/kernels.py:348``).
* :func:`idwt2d_dequant` replaces K2, ``idwt2d_dequant_pallas``: per-chunk
  cut dequantization fused into the multi-level inverse transform.

The kernels are CUDA C++ for sm_90a in ``ebcc_tpu_torch/csrc/dwt97.cu``
(design, bound and arithmetic notes there), built by ``ops/_build.py`` at
first use.  A CUDA tensor goes to the kernel, and anything the kernel does
not take raises; a CPU tensor goes to the plain PyTorch version beside each
wrapper (``*_plain``), which the kernels are bit-equal to.  Each wrapper
counts its kernel launches (:data:`LAUNCHES`), so a run can show that the
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, bitplane
from . import dwt as dwt_ops


class LaunchCounter:
    """Thread-safe count of kernel launches (the codec's pipeline launches
    from several worker threads)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self):
        with self._lock:
            self._n += 1

    def reset(self):
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


LAUNCHES = {
    "dwt2d_quantize": LaunchCounter(),
    "dwt2d_transform": LaunchCounter(),
    "idwt2d_dequant": LaunchCounter(),
}


def reset_launch_counts():
    for c in LAUNCHES.values():
        c.reset()


def launch_counts() -> dict:
    return {k: c.value for k, c in LAUNCHES.items()}


_SIG_LOCK = threading.Lock()


def _lib():
    lib = _build.load("dwt97")
    with _SIG_LOCK:
        if not getattr(lib, "_ebcc_sigs", False):
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.ebcc_dwt2d_forward.argtypes = [p, p, p, i, i, i, i, p]
            lib.ebcc_dwt2d_forward.restype = i
            lib.ebcc_idwt2d_dequant.argtypes = [p, p, p, i, i, i, i, i, p]
            lib.ebcc_idwt2d_dequant.restype = i
            lib.ebcc_dwt97_max_rows.argtypes = []
            lib.ebcc_dwt97_max_rows.restype = i
            lib._ebcc_sigs = True
    return lib


def _check_frames(x, dtype, levels: int):
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"expected (B, D0, Hp, Wp), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    b, d0, hp, wp = x.shape
    if levels < 1 or hp % (1 << levels) or wp % (1 << levels):
        raise ValueError(f"dims ({hp},{wp}) not divisible by 2^{levels}")
    lib = _lib()
    max_rows = lib.ebcc_dwt97_max_rows()
    if hp > max_rows:
        raise ValueError(f"padded height {hp} exceeds the column pass's "
                         f"shared-memory tile ({max_rows} rows)")
    if not 0 < b * d0 <= 65535:
        raise ValueError(f"{b * d0} frames outside the launch grid")
    return lib


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _forward(x, levels: int, quantize: bool):
    lib = _check_frames(x, torch.float32, levels)
    b, d0, hp, wp = x.shape
    scratch = torch.empty_like(x)
    q = torch.empty(x.shape, dtype=torch.int32, device=x.device) \
        if quantize else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ebcc_dwt2d_forward(
            x.data_ptr(), scratch.data_ptr(),
            q.data_ptr() if quantize else None,
            b * d0, hp, wp, levels, stream)
    _raise_on(err, "dwt2d forward kernel")
    return q if quantize else scratch


def dwt2d_quantize_plain(x, levels: int):
    return bitplane.quantize_floor(dwt_ops.dwt2d(x, levels))


def dwt2d_quantize(x, levels: int):
    """(B, D0, Hp, Wp) float32 -> int32 coefficients truncated toward zero
    (K1).  CPU tensors take :func:`dwt2d_quantize_plain`."""
    if x.device.type == "cpu":
        return dwt2d_quantize_plain(x, levels)
    q = _forward(x, levels, quantize=True)
    LAUNCHES["dwt2d_quantize"].add()
    return q


def dwt2d_transform_plain(x, levels: int):
    return dwt_ops.dwt2d(x, levels)


def dwt2d_transform(x, levels: int):
    """(B, D0, Hp, Wp) float32 -> float32 forward transform (K1's kernel
    without the truncation).  CPU tensors take :func:`dwt2d_transform_plain`."""
    if x.device.type == "cpu":
        return dwt2d_transform_plain(x, levels)
    y = _forward(x, levels, quantize=False)
    LAUNCHES["dwt2d_transform"].add()
    return y


def _cut_vector(cut, b: int, device):
    cut = torch.as_tensor(cut, dtype=torch.int32, device=device).reshape(-1)
    if cut.numel() == 1 and b != 1:
        cut = cut.expand(b)
    if cut.shape != (b,):
        raise ValueError(f"cut must have one entry per chunk ({b}), got "
                         f"{tuple(cut.shape)}")
    return cut.contiguous()


def idwt2d_dequant_plain(q, cut, levels: int):
    cut = _cut_vector(cut, q.shape[0], q.device)
    rec = bitplane.reconstruct_at_cut(q, cut[:, None, None, None])
    return dwt_ops.idwt2d(rec, levels)


def idwt2d_dequant(q, cut, levels: int):
    """(B, D0, Hp, Wp) int32 + per-chunk cut (B,) (or a scalar) -> spatial
    float32 (K2).  CPU tensors take :func:`idwt2d_dequant_plain`."""
    if q.device.type == "cpu":
        return idwt2d_dequant_plain(q, cut, levels)
    lib = _check_frames(q, torch.int32, levels)
    b, d0, hp, wp = q.shape
    cut = _cut_vector(cut, b, q.device)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ebcc_idwt2d_dequant(
            q.data_ptr(), cut.data_ptr(), out.data_ptr(), b * d0, d0, hp, wp,
            levels, stream)
    _raise_on(err, "idwt2d dequant kernel")
    LAUNCHES["idwt2d_dequant"].add()
    return out
