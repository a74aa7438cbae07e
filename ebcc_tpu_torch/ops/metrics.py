"""Batched error metrics, plain PyTorch (counterpart of
``ebcc_tpu/ops/metrics.py``).

Means are accumulated in float64 and rounded once to float32.  The mean is
folded into stored stream bytes, and a float32 reduction's summation order
depends on how PyTorch splits the reduction, which depends on the batch
size.  Summing in float64 makes a chunk's mean independent of the batch it
rides in (up to a double-rounding tie), which the port's byte-identity
contract across batch partitionings needs.  Max, min and counts are exact.
"""

from __future__ import annotations

import torch


def _axes(x):
    """All axes except the leading batch axis."""
    return tuple(range(1, x.ndim))


def _bshape(x):
    return (-1,) + (1,) * (x.ndim - 1)


def minmax(x):
    """Per-batch (min, max)."""
    return x.amin(dim=_axes(x)), x.amax(dim=_axes(x))


def max_abs_error(x, recon):
    """Per-batch max |x - recon|."""
    return (x - recon).abs().amax(dim=_axes(x))


def batch_mean(v):
    """Per-batch mean of a float32 tensor, float64 accumulation."""
    return v.to(torch.float64).mean(dim=_axes(v)).to(torch.float32)


def centered_max_abs_error(x, recon):
    """(max |err - mean(err)|, mean(err)): the max error after the mean is
    folded into the stored min/max."""
    err = x - recon
    m = batch_mean(err)
    return (err - m.reshape(_bshape(x))).abs().amax(dim=_axes(x)), m


def error_quantile(x, recon, error_target):
    """Fraction of points with |err| <= the per-batch target."""
    err = (x - recon).abs()
    tgt = torch.as_tensor(error_target, device=x.device).reshape(_bshape(x))
    n = 1
    for d in x.shape[1:]:
        n *= d
    bad = (err > tgt).sum(dim=_axes(x))
    return 1.0 - bad.to(torch.float32) / n
