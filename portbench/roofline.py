"""Peaks of the card and the operations and bytes of the port's wavelet
kernels, frozen from ``chip_smoke.py`` (``bound``, ``lifting_ops``,
``frame_ops``).

Peaks are the published ones of one NVIDIA H100 SXM at its full 700 W
(NVIDIA's data sheet): 3.35 TB/s of HBM, and 67 TFLOP/s of float32 outside
the tensor cores, which counts a fused multiply-add as two operations.  The
kernels contract nothing into an FMA (``-ffp-contract`` style separate
rounding), so their peak is one operation per lane per clock: half of it.
A card set below 700 W runs below these peaks; the run prints the limit.

A kernel call's least time is the larger of its bytes over the HBM peak and
its operations over the float32 peak.  Bytes: each input byte read once and
each output byte written once: a float32 or int32 value in and one out, 8 B
per coefficient, for K1 (``dwt2d_quantize``, ``dwt2d_transform``) and K2
(``idwt2d_dequant``) alike.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
BYTES_PER_COEFF = 8

# Per-sample operations beyond the lifting: K1's truncation (1), none for
# the float variant, K2's dequantization (~7: shift, compare, midpoint,
# sign, convert).
EXTRA_OPS = {"dwt2d_quantize": 1, "dwt2d_transform": 0, "idwt2d_dequant": 7}


def lifting_ops(hp: int, wp: int, levels: int) -> int:
    """float32 operations of a multi-level 9/7 transform of one frame: per
    level two 1-D passes over the (hp>>l, wp>>l) block, 7 per sample each
    (4 lifting updates of 3 operations on half the samples, 1 scaling)."""
    return sum(2 * 7 * (hp >> lvl) * (wp >> lvl) for lvl in range(levels))


def call_bound_s(kind: str, shape, levels: int) -> float:
    """Least seconds of one wrapper call of ``kind`` on a (B, D0, Hp, Wp)
    array at ``levels``."""
    b, d0, hp, wp = shape
    frames = b * d0
    n_bytes = BYTES_PER_COEFF * frames * hp * wp
    n_ops = frames * (lifting_ops(hp, wp, levels) + EXTRA_OPS[kind] * hp * wp)
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
