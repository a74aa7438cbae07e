"""What decides ``correct``: the numbers compared and their limits.

A configuration's guarantee is a :class:`Bound`, which the harness derives
from its codec settings as docs/FORMAT.md states it (``harness.bound_of``),
not chosen here:

* ``err_over_bound``: the largest error of a decoded array against the
  slab the request carried, as a share of the guaranteed bound in that
  chunk (``max_abs``: ``value``; ``chunk_relative``: ``value`` times the
  chunk's max - min).  docs/FORMAT.md: the bound holds for every pairing
  of conforming encoder and decoder.  Limit 1.
* ``gap_over_range``: the largest gap between the program's decoded array
  and the reference's decode of the same container, per chunk, as a share
  of the chunk's stored ``maxval - minval``.  docs/FORMAT.md lets
  conforming decoders differ by ``decoder_eps_rel`` of that range: 4e-6
  per intra chunk, 2 * T * 4e-6 per temporal chunk of T frames.  Compared
  in read cells.
"""

from __future__ import annotations

import dataclasses

import torch

DECODER_EPS_REL = 4e-6
LIMITS = {"err_over_bound": 1.0, "gap_over_range": DECODER_EPS_REL}


@dataclasses.dataclass(frozen=True)
class Bound:
    """A configuration's guarantee: ``kind`` (``max_abs`` or
    ``chunk_relative``), its ``value`` and the decoders' permitted gap
    ``decoder_eps_rel``."""
    kind: str
    value: float
    decoder_eps_rel: float = DECODER_EPS_REL

    @property
    def limits(self) -> dict:
        return {**LIMITS, "gap_over_range": self.decoder_eps_rel}


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


def chunk_bounds(slab_chunks, bound: Bound):
    """The configuration's bound per chunk of the original slab."""
    n = slab_chunks.shape[0]
    flat = slab_chunks.reshape(n, -1)
    if bound.kind == "max_abs":
        return torch.full((n,), float(bound.value), dtype=torch.float64,
                          device=flat.device)
    if bound.kind == "chunk_relative":
        rng = (flat.amax(1) - flat.amin(1)).to(torch.float64)
        return bound.value * rng
    raise ValueError(f"no pointwise bound of kind {bound.kind}")


def err_over_bound(decoded, slab, cdims, bound: Bound) -> float:
    """max over chunks of max |decoded - slab| / bound."""
    if tuple(decoded.shape) != tuple(slab.shape):
        return float("inf")
    d = chunks_of(decoded, cdims)
    s = chunks_of(slab, cdims)
    err = (d - s).abs().reshape(d.shape[0], -1).amax(1).to(torch.float64)
    return float((err / chunk_bounds(s, bound)).max())


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
