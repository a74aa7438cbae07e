"""Traffic: the slabs a cell's requests carry, made from ``--seed``.

The field is the port bench's synthetic ERA5-shaped generator
(``ebcc_tpu_torch/bench.py`` ``smooth_field`` / ``load_frames``), frozen
here and seeded from the run's seed instead of 0, and drawn with one
``torch.Generator`` on the run's device in a few large calls: per frame a
smooth base (260 + 25 sin(pi y/h) cos(2 pi x/w)) plus 0.3 per frame index
within the slab, a 24 x 46 normal grid (amplitude 1) interpolated
bilinearly, and 0.02 white noise.  Every seed gives the same number of
slabs of the same shape, and the first ``k`` slabs of a pool are the pool
of ``k`` from that seed.

A configuration may state a per-frame profile (its ``field``: a mean and a
standard deviation per frame of the slab).  Frame ``i`` is then that
texture standardised by its own mean and standard deviation, in float64,
and set to ``mean_i + std_i * z_i``, as ``scripts/ab_reference.py`` lays
its texture on a level's mean and spread.  The draws are the same, so the
same seed gives the same texture under every profile.

The encoder's work and the compression ratio depend on the content
(whether a chunk needs the residual layer), so a mix's pool is large
enough that its mean over the pool moves little from seed to seed.
"""

from __future__ import annotations

import json
import math
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
COARSE = (24, 46)
DRIFT_PER_FRAME = 0.3
NOISE = 0.02


def load_json(kind: str, name: str) -> dict:
    """``configs/<name>.json`` or ``mixes/<name>.json`` of this folder."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def _bilinear(coarse, h: int, w: int):
    """(n, 24, 46) grids -> (n, h, w), as ``bench.smooth_field``."""
    dev = coarse.device
    yi = torch.linspace(0, COARSE[0] - 1, h, dtype=torch.float64, device=dev)
    xi = torch.linspace(0, COARSE[1] - 1, w, dtype=torch.float64, device=dev)
    y0 = yi.to(torch.int64).clamp(0, COARSE[0] - 2)
    x0 = xi.to(torch.int64).clamp(0, COARSE[1] - 2)
    fy = (yi - y0).to(torch.float32)[:, None]
    fx = (xi - x0).to(torch.float32)[None, :]
    c00 = coarse[:, y0][:, :, x0]
    c01 = coarse[:, y0][:, :, x0 + 1]
    c10 = coarse[:, y0 + 1][:, :, x0]
    c11 = coarse[:, y0 + 1][:, :, x0 + 1]
    return (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
            + c10 * fy * (1 - fx) + c11 * fy * fx)


def base_field(h: int, w: int, device):
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return 260 + 25 * torch.sin(yy / h * math.pi) * torch.cos(
        xx / w * 2 * math.pi)


def profiled(slab, means, stds) -> torch.Tensor:
    """(frames, h, w) -> each frame standardised in float64 and set to its
    stated mean and standard deviation."""
    x = slab.to(torch.float64)
    mu = x.mean(dim=(1, 2), keepdim=True)
    sd = x.std(dim=(1, 2), keepdim=True, correction=0)
    mean = torch.tensor(means, dtype=torch.float64, device=slab.device)
    std = torch.tensor(stds, dtype=torch.float64, device=slab.device)
    return mean[:, None, None] + std[:, None, None] * (x - mu) / sd


def make_slabs(seed: int, n_slabs: int, frames: int, h: int, w: int,
               device, field=None) -> torch.Tensor:
    """(n_slabs, frames, h, w) float32 on ``device``, from ``seed``;
    ``field`` is ``None`` or a configuration's profile, ``(means, stds)``
    with one entry per frame."""
    g = _generator(seed, device)
    base = base_field(h, w, device)
    drift = DRIFT_PER_FRAME * torch.arange(frames, dtype=torch.float32,
                                           device=device)[:, None, None]
    out = torch.empty((n_slabs, frames, h, w), dtype=torch.float32,
                      device=device)
    for s in range(n_slabs):
        coarse = torch.randn((frames, *COARSE), generator=g, device=device)
        noise = torch.randn((frames, h, w), generator=g, device=device)
        slab = base + drift + _bilinear(coarse, h, w) + NOISE * noise
        out[s] = slab if field is None else profiled(slab, *field)
    return out
