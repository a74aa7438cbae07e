"""Batched multi-level CDF 9/7 wavelet transform (lifting), plain PyTorch.

Counterpart of ``ebcc_tpu/ops/dwt.py``: the same lifting steps, boundary
rule (edge replication of the opposite-parity array, i.e. whole-point
symmetric extension) and in-place Mallat layout.  Every lifting update is
written as the reference orders it, ``o + coef * (e + e_next)``; PyTorch
runs each elementwise op as its own kernel, so every operation is rounded on
its own.  This is the plain version the hand-written CUDA kernels in
``ebcc_tpu_torch/csrc/dwt97.cu`` are held against.
"""

from __future__ import annotations

import torch

from ..device import constant

# Canonical CDF 9/7 lifting coefficients (Daubechies & Sweldens 1998).
ALPHA = -1.586134342
BETA = -0.05298011854
GAMMA = 0.8829110762
DELTA = 0.44355068522
XI = 1.149604398


def _next(a):
    """a[i+1] along the last axis with end replication."""
    return torch.cat([a[..., 1:], a[..., -1:]], dim=-1)


def _prev(a):
    """a[i-1] along the last axis with front replication."""
    return torch.cat([a[..., :1], a[..., :-1]], dim=-1)


def _predict(odd, even, coef):
    """odd_i += coef * (even_i + even_{i+1})."""
    return odd + coef * (even + _next(even))


def _update(even, odd, coef):
    """even_i += coef * (odd_{i-1} + odd_i)."""
    return even + coef * (_prev(odd) + odd)


def dwt1d(x):
    """Forward 9/7 lifting along the last axis (even length) -> [low | high]."""
    even = x[..., 0::2]
    odd = x[..., 1::2]
    odd = _predict(odd, even, ALPHA)
    even = _update(even, odd, BETA)
    odd = _predict(odd, even, GAMMA)
    even = _update(even, odd, DELTA)
    return torch.cat([even * XI, odd * (1.0 / XI)], dim=-1)


def idwt1d(y):
    """Inverse of :func:`dwt1d` along the last axis."""
    n = y.shape[-1]
    even = y[..., : n // 2] * (1.0 / XI)
    odd = y[..., n // 2:] * XI
    even = _update(even, odd, -DELTA)
    odd = _predict(odd, even, -GAMMA)
    even = _update(even, odd, -BETA)
    odd = _predict(odd, even, -ALPHA)
    return torch.stack([even, odd], dim=-1).reshape(y.shape)


def _check_dims(h: int, w: int, levels: int):
    if h % (1 << levels) or w % (1 << levels):
        raise ValueError(f"dims ({h},{w}) not divisible by 2^{levels}")


def dwt2d(x, levels: int):
    """Multi-level 2-D forward DWT of ``(..., H, W)`` float32, in-place
    Mallat layout: per level a row pass then a column pass on the top-left
    ``(H >> l, W >> l)`` block."""
    h, w = x.shape[-2], x.shape[-1]
    _check_dims(h, w, levels)
    x = x.clone()
    for lvl in range(levels):
        hl, wl = h >> lvl, w >> lvl
        blk = dwt1d(x[..., :hl, :wl])                              # rows
        blk = dwt1d(blk.transpose(-1, -2)).transpose(-1, -2)       # columns
        x[..., :hl, :wl] = blk
    return x


def idwt2d(y, levels: int):
    """Multi-level 2-D inverse DWT (inverse of :func:`dwt2d`): coarsest
    level first, column pass then row pass."""
    h, w = y.shape[-2], y.shape[-1]
    _check_dims(h, w, levels)
    y = y.clone()
    for lvl in range(levels - 1, -1, -1):
        hl, wl = h >> lvl, w >> lvl
        blk = idwt1d(y[..., :hl, :wl].transpose(-1, -2)).transpose(-1, -2)
        y[..., :hl, :wl] = idwt1d(blk)
    return y


def _pad_index(n: int, p: int, symmetric: bool, device):
    """The gather index of one padded axis, made on the host and uploaded
    once per device (a stream that captures a CUDA graph takes no upload)."""
    tail = [2 * n - 1 - i for i in range(n, n + p)] if symmetric \
        else [n - 1] * p
    return constant(list(range(n)) + tail, torch.int64, device)


def pad_to_multiple(x, multiple: int):
    """Pad trailing H, W up to a multiple -> (padded, (orig_h, orig_w)).

    Same rule as the reference (``ebcc_tpu/ops/dwt.py:153``): numpy
    'symmetric' (edge-inclusive mirror) when both pads are shorter than the
    axis, else 'edge' replication."""
    h, w = x.shape[-2], x.shape[-1]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return x, (h, w)
    symmetric = ph < h and pw < w
    x = x.index_select(-2, _pad_index(h, ph, symmetric, x.device))
    x = x.index_select(-1, _pad_index(w, pw, symmetric, x.device))
    return x, (h, w)


def unpad(x, orig_hw):
    h, w = orig_hw
    return x[..., :h, :w]


def subband_shapes(h: int, w: int, levels: int):
    """[(name, (row0, col0, rows, cols)), ...] coarse-to-fine: the deepest
    LL first, then (HL, LH, HH) per level from deepest to finest."""
    out = []
    hl, wl = h >> levels, w >> levels
    out.append((f"LL{levels}", (0, 0, hl, wl)))
    for lvl in range(levels, 0, -1):
        hh, ww = h >> lvl, w >> lvl
        out.append((f"HL{lvl}", (0, ww, hh, ww)))
        out.append((f"LH{lvl}", (hh, 0, hh, ww)))
        out.append((f"HH{lvl}", (hh, ww, hh, ww)))
    return out
