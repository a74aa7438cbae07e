"""What decides ``correct``: the numbers compared and their limits.

Both limits are stated by the configuration or the format, not chosen here:

* ``err_over_bound``: the largest error of a decoded array against the
  slab the request carried, as a share of the configuration's guaranteed
  bound in that chunk (MAX_ERROR: ``error``; RELATIVE_ERROR: ``error``
  times the chunk's max - min).  docs/FORMAT.md: the bound holds for every
  pairing of conforming encoder and decoder.  Limit 1.
* ``gap_over_range``: the largest gap between the program's decoded array
  and the reference's decode of the same container, per chunk, as a share
  of the chunk's stored ``maxval - minval``.  docs/FORMAT.md lets
  conforming decoders differ by ``4e-6 * (maxval - minval)`` per intra
  chunk.  Limit 4e-6.
"""

from __future__ import annotations

import torch

MAX_ERROR, RELATIVE_ERROR = "MAX_ERROR", "RELATIVE_ERROR"
DECODER_EPS_REL = 4e-6
LIMITS = {"err_over_bound": 1.0, "gap_over_range": DECODER_EPS_REL}


def chunks_of(arr, cdims):
    """(d0, d1, d2) array -> (N, c0, c1, c2) chunks in chunk-linear order,
    edge chunks padded by repeating the edge (a repeat changes no max)."""
    idx = []
    for d, c in zip(arr.shape, cdims):
        n = -(-d // c)
        i = torch.arange(n, device=arr.device)[:, None] * c + torch.arange(
            c, device=arr.device)[None, :]
        idx.append(i.clamp(max=d - 1))
    g = arr[idx[0][:, None, None, :, None, None],
            idx[1][None, :, None, None, :, None],
            idx[2][None, None, :, None, None, :]]
    return g.reshape(-1, *cdims)


def chunk_bounds(slab_chunks, mode: str, error: float):
    """The configuration's bound per chunk of the original slab."""
    n = slab_chunks.shape[0]
    flat = slab_chunks.reshape(n, -1)
    if mode == MAX_ERROR:
        return torch.full((n,), float(error), dtype=torch.float64,
                          device=flat.device)
    if mode == RELATIVE_ERROR:
        rng = (flat.amax(1) - flat.amin(1)).to(torch.float64)
        return error * rng
    raise ValueError(f"no bound for mode {mode}")


def err_over_bound(decoded, slab, cdims, mode: str, error: float) -> float:
    """max over chunks of max |decoded - slab| / bound."""
    if tuple(decoded.shape) != tuple(slab.shape):
        return float("inf")
    d = chunks_of(decoded, cdims)
    s = chunks_of(slab, cdims)
    err = (d - s).abs().reshape(d.shape[0], -1).amax(1).to(torch.float64)
    return float((err / chunk_bounds(s, mode, error)).max())


def gap_over_range(a, b, ranges, cdims) -> float:
    """max over chunks of max |a - b| / (maxval - minval); ``ranges`` are
    the chunks' (minval, maxval) from their stream headers."""
    if tuple(a.shape) != tuple(b.shape):
        return float("inf")
    ca, cb = chunks_of(a, cdims), chunks_of(b, cdims)
    gap = (ca - cb).abs().reshape(ca.shape[0], -1).amax(1).to(torch.float64)
    worst = 0.0
    for g, (lo, hi) in zip(gap.tolist(), ranges):
        rel = g / (hi - lo) if hi > lo else (0.0 if g == 0 else float("inf"))
        worst = max(worst, rel)
    return worst
