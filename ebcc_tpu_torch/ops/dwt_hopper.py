"""Fused wavelet kernels for Hopper: the port's counterpart of
``ebcc_tpu/ops/dwt_pallas.py``.

* :func:`dwt2d_quantize` replaces K1, ``dwt2d_quantize_pallas``: forward
  multi-level CDF 9/7 transform per frame, truncated toward zero to int32.
* :func:`dwt2d_transform` is the same kernel with the truncation switched
  off; it runs the residual layer's forward transform, which the reference
  leaves to XLA (``ebcc_tpu/core/kernels.py:348``).
* :func:`idwt2d_dequant` replaces K2, ``idwt2d_dequant_pallas``: per-chunk
  cut dequantization fused into the multi-level inverse transform.
* :func:`curve_stats` replaces K3, ``curve_stats_pallas``: the error
  statistics of every cut of a grid, for the fused coarse cut sweep, with
  every cut lifted from one load of q and t.

The kernels are CUDA C++ for sm_90a in ``ebcc_tpu_torch/csrc/dwt97.cu``
(design, bound and arithmetic notes there), built by ``ops/_build.py`` at
first use.  Each level of a frame runs as one launch over 64x64 tiles that
carry their own 2-sample halo in a fixed 20.5 KB of shared memory, so
frames of any padded height and width are taken; the coarse levels whose
whole block fits in one block's shared memory run together in one more
launch (a 5-level call at 736x1440 is 4 launches, a 3-level call 3).  The
kernels need a work buffer of 5/16 of the frames' samples (K3: that per cut
of a group of up to 8 cuts), which the wrappers allocate.

A CUDA tensor goes to the kernel, and anything the kernel does not take
raises; a CPU tensor goes to the plain PyTorch version beside each wrapper
(``*_plain``), which the kernels are bit-equal to (K3's float64 sum up to
its summation order).  Each wrapper counts its calls that launch the
kernels (:data:`LAUNCHES`), so a run can show that the main path went
through them.

A CUDA graph that captured wrapper calls (``core/graphs.py``) replays
their kernels without calling the wrappers.  Each wrapper notes, on a
thread where :func:`noting_calls` is on, the call it launched, and the
replay makes each noted call again with a :class:`ReplayedCall` in place
of its first tensor: the wrapper then counts the call and launches
nothing, and whatever wraps the wrapper sees the call as it saw it at
capture.  :func:`add_kernels_launched` adds the replayed kernels to the
library's own count.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
import threading

import torch

from ..device import constant
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
    "curve_stats": LaunchCounter(),
}


def reset_launch_counts():
    for c in LAUNCHES.values():
        c.reset()


def launch_counts() -> dict:
    return {k: c.value for k, c in LAUNCHES.items()}


def cuda_kernels_launched() -> int:
    """CUDA kernels the library of the kernels has launched since it was
    loaded, counted at each launch site: the difference over one wrapper
    call is the number of kernels that call launches, with no profiler."""
    return _lib().ebcc_kernels_launched()


def thread_kernels_launched() -> int:
    """The library's count of the kernels launched from this thread."""
    return _lib().ebcc_thread_launched()


def add_kernels_launched(n: int) -> None:
    """Adds ``n`` kernels that a CUDA graph replay ran to the library's
    count."""
    _lib().ebcc_add_launched(n)


class ReplayedCall:
    """The first tensor of a wrapper call that a CUDA graph replay made
    again: its shape, dtype and device.  A wrapper given one counts the
    call and launches nothing."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, t):
        self.shape, self.dtype, self.device = tuple(t.shape), t.dtype, t.device


_NOTES = threading.local()


@contextlib.contextmanager
def noting_calls(log: list):
    """While on, each wrapper call on this thread that launches appends
    ``(module, name, args, kwargs)`` to ``log``: the call to make again,
    with a :class:`ReplayedCall` as ``args[0]``."""
    _NOTES.log = log
    try:
        yield
    finally:
        _NOTES.log = None


def note_call(module, name: str, t, *args, **kw) -> None:
    """Notes a call of ``module.name`` whose first tensor was ``t``, where
    :func:`noting_calls` is on."""
    log = getattr(_NOTES, "log", None)
    if log is not None:
        log.append((module, name, (ReplayedCall(t),) + args, kw))


_SELF = sys.modules[__name__]


_SIG_LOCK = threading.Lock()


def _lib():
    lib = _build.load("dwt97")
    with _SIG_LOCK:
        if not getattr(lib, "_ebcc_sigs", False):
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.ebcc_dwt2d_forward.argtypes = [p, p, p, p, i, i, i, i, p]
            lib.ebcc_dwt2d_forward.restype = i
            lib.ebcc_idwt2d_dequant.argtypes = [p, p, p, p, i, i, i, i, i, p]
            lib.ebcc_idwt2d_dequant.restype = i
            lib.ebcc_curve_stats.argtypes = [p] * 12 + [i] * 8 + [p]
            lib.ebcc_curve_stats.restype = i
            lib.ebcc_dwt97_scratch_floats.argtypes = [i, i, i]
            lib.ebcc_dwt97_scratch_floats.restype = ctypes.c_longlong
            lib.ebcc_curve_scratch_floats.argtypes = [i, i, i, i]
            lib.ebcc_curve_scratch_floats.restype = ctypes.c_longlong
            lib.ebcc_curve_cut_group.argtypes = []
            lib.ebcc_curve_cut_group.restype = i
            lib.ebcc_curve_parts.argtypes = [i, i]
            lib.ebcc_curve_parts.restype = i
            lib.ebcc_kernels_launched.argtypes = []
            lib.ebcc_kernels_launched.restype = ctypes.c_longlong
            lib.ebcc_thread_launched.argtypes = []
            lib.ebcc_thread_launched.restype = ctypes.c_longlong
            lib.ebcc_add_launched.argtypes = [ctypes.c_longlong]
            lib.ebcc_add_launched.restype = None
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
    if not 0 < b * d0 <= 65535:
        raise ValueError(f"{b * d0} frames outside the launch grid")
    return _lib()


def _scratch(lib, x):
    """The kernels' work buffer: the compact planes of the intermediate
    levels (5/16 of the frames' samples)."""
    b, d0, hp, wp = x.shape
    n = lib.ebcc_dwt97_scratch_floats(b * d0, hp, wp)
    return torch.empty(n, dtype=torch.float32, device=x.device)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _forward(x, levels: int, quantize: bool):
    lib = _check_frames(x, torch.float32, levels)
    b, d0, hp, wp = x.shape
    scratch = _scratch(lib, x)
    out = torch.empty(x.shape, dtype=torch.int32 if quantize
                      else torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ebcc_dwt2d_forward(
            x.data_ptr(), scratch.data_ptr(),
            None if quantize else out.data_ptr(),
            out.data_ptr() if quantize else None,
            b * d0, hp, wp, levels, stream)
    _raise_on(err, "dwt2d forward kernel")
    return out


def dwt2d_quantize_plain(x, levels: int):
    return bitplane.quantize_floor(dwt_ops.dwt2d(x, levels))


def dwt2d_quantize(x, levels: int):
    """(B, D0, Hp, Wp) float32 -> int32 coefficients truncated toward zero
    (K1).  CPU tensors take :func:`dwt2d_quantize_plain`."""
    if isinstance(x, ReplayedCall):
        LAUNCHES["dwt2d_quantize"].add()
        return None
    if x.device.type == "cpu":
        return dwt2d_quantize_plain(x, levels)
    q = _forward(x, levels, quantize=True)
    LAUNCHES["dwt2d_quantize"].add()
    note_call(_SELF, "dwt2d_quantize", x, levels)
    return q


def dwt2d_transform_plain(x, levels: int):
    return dwt_ops.dwt2d(x, levels)


def dwt2d_transform(x, levels: int):
    """(B, D0, Hp, Wp) float32 -> float32 forward transform (K1's kernel
    without the truncation).  CPU tensors take :func:`dwt2d_transform_plain`."""
    if isinstance(x, ReplayedCall):
        LAUNCHES["dwt2d_transform"].add()
        return None
    if x.device.type == "cpu":
        return dwt2d_transform_plain(x, levels)
    y = _forward(x, levels, quantize=False)
    LAUNCHES["dwt2d_transform"].add()
    note_call(_SELF, "dwt2d_transform", x, levels)
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
    if isinstance(q, ReplayedCall):
        LAUNCHES["idwt2d_dequant"].add()
        return None
    if q.device.type == "cpu":
        return idwt2d_dequant_plain(q, cut, levels)
    lib = _check_frames(q, torch.int32, levels)
    b, d0, hp, wp = q.shape
    cut = _cut_vector(cut, b, q.device)
    scratch = _scratch(lib, q)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ebcc_idwt2d_dequant(
            q.data_ptr(), cut.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            b * d0, d0, hp, wp, levels, stream)
    _raise_on(err, "idwt2d dequant kernel")
    LAUNCHES["idwt2d_dequant"].add()
    note_call(_SELF, "idwt2d_dequant", q, None, levels)
    return out


def _b4(v):
    return v[:, None, None, None]


def curve_stats_plain(q, t, scale, off, target, *, levels: int, cut_grid,
                      valid_hw):
    """Plain version of :func:`curve_stats`: dequant -> inverse transform
    -> masked reductions, one cut at a time."""
    h, w = valid_hw
    tv = t[..., :h, :w]
    rows = []
    for cut in cut_grid:
        rec = idwt2d_dequant_plain(q, int(cut), levels)[..., :h, :w]
        err = tv - (rec * _b4(scale) + _b4(off))
        rows.append(torch.stack([
            err.to(torch.float64).sum(dim=(2, 3)),
            err.amax(dim=(2, 3)).to(torch.float64),
            err.amin(dim=(2, 3)).to(torch.float64),
            (err.abs() > _b4(target)).sum(dim=(2, 3)).to(torch.float64),
        ], dim=-1))
    return torch.stack(rows)


def _chunk_vector(v, b: int, device):
    v = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if v.shape != (b,):
        raise ValueError(f"expected one value per chunk ({b}), got "
                         f"{tuple(v.shape)}")
    return v.contiguous()


def curve_cut_group() -> int:
    """Cuts per group of K3's launches (a constant of the CUDA source)."""
    return _lib().ebcc_curve_cut_group()


def curve_stats(q, t, scale, off, target, *, levels: int, cut_grid,
                valid_hw):
    """Error-vs-cut statistics curve (K3).

    q: (B, D0, Hp, Wp) int32 coefficients; t: (B, D0, Hp, Wp) float32
    target frames (the pad region is masked out); scale, off, target:
    per-chunk (B,) float32.  For each cut of ``cut_grid`` (any order,
    repeats taken) the error is ``t - (idwt(dequant(q, cut)) * scale +
    off)`` over the valid ``valid_hw`` region.  Returns (n_cuts, B, D0, 4)
    float64 rows [sum, max, min, count(|err| > target)]: max, min and count
    exact, the sum accumulated in float64 in a fixed order, so a cut's row
    depends neither on the batch nor on the other cuts of the grid.  CPU
    tensors take :func:`curve_stats_plain`.

    The kernel runs the cuts in groups of :func:`curve_cut_group` (8): per
    group, levels ``levels-1 .. 1`` of all its cuts in one launch per level,
    then one level-0 launch whose block per (64x64 tile, frame) copies q's
    window and loads t once and lifts every cut of the group from them,
    reducing each cut's error into per-tile partials; one last launch sums
    the partials in a fixed order.  A base call (5 levels, 8 cuts) at
    (4, 1, 736, 1440) is 5 launches, a residual call (3 levels) 4.  Scratch:
    ``min(n_cuts, 8) * 5/16`` of the frames' samples in float32 (42 MB for
    8 cuts at (4, 1, 736, 1440)), plus 20 bytes per (cut, frame, tile)
    partial.  Bound: its float32 operations, one instruction each (no FMA
    contraction), about 0.034 ms for that base call on an H100.  What holds
    it back: the lifting itself, ~17 us per cut at level 0 (as much as a
    K2 level-0 launch), the tiles' halos and overlapping segments lifting
    1.7-1.9x the samples the outputs need (``csrc/dwt97.cu``, ``PERF.md``).
    """
    if isinstance(q, ReplayedCall):
        LAUNCHES["curve_stats"].add()
        return None
    if q.device.type == "cpu":
        return curve_stats_plain(q, t, scale, off, target, levels=levels,
                                 cut_grid=cut_grid, valid_hw=valid_hw)
    lib = _check_frames(q, torch.int32, levels)
    if (t.device != q.device or t.dtype != torch.float32
            or t.shape != q.shape or not t.is_contiguous()):
        raise ValueError("t must be a contiguous float32 tensor shaped and "
                         "placed like q")
    b, d0, hp, wp = q.shape
    vh, vw = (int(v) for v in valid_hw)
    if not (0 < vh <= hp and 0 < vw <= wp):
        raise ValueError(f"valid region {valid_hw} outside ({hp}, {wp})")
    cuts = constant([int(c) for c in cut_grid], torch.int32, q.device)
    n_cuts, n_frames = cuts.numel(), b * d0
    if n_cuts == 0:
        raise ValueError("empty cut grid")
    scale, off, target = (_chunk_vector(v, b, q.device)
                          for v in (scale, off, target))
    dev = q.device
    scratch = torch.empty(
        lib.ebcc_curve_scratch_floats(n_cuts, n_frames, hp, wp),
        dtype=torch.float32, device=dev)
    n_parts = n_cuts * n_frames * lib.ebcc_curve_parts(vh, vw)
    part_sum = torch.empty(n_parts, dtype=torch.float64, device=dev)
    part_mx = torch.empty(n_parts, dtype=torch.float32, device=dev)
    part_mn = torch.empty(n_parts, dtype=torch.float32, device=dev)
    part_bad = torch.empty(n_parts, dtype=torch.int32, device=dev)
    out = torch.empty((n_cuts, n_frames, 4), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ebcc_curve_stats(
            q.data_ptr(), t.data_ptr(), cuts.data_ptr(), scale.data_ptr(),
            off.data_ptr(), target.data_ptr(), scratch.data_ptr(),
            part_sum.data_ptr(), part_mx.data_ptr(), part_mn.data_ptr(),
            part_bad.data_ptr(), out.data_ptr(), n_cuts, n_frames, d0, hp, wp,
            levels, vh, vw, stream)
    _raise_on(err, "curve stats kernel")
    LAUNCHES["curve_stats"].add()
    note_call(_SELF, "curve_stats", q, None, None, None, None, levels=levels,
              cut_grid=cut_grid, valid_hw=valid_hw)
    return out.reshape(n_cuts, b, d0, 4)
