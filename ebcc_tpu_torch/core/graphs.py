"""The encode core replayed as CUDA graphs.

In eager PyTorch the encode core (``kernels._encode_chain``) is ~1,800 to
2,000 launches a batch, each dispatched from Python at ~18 us of host time,
about twice the card's own work.  :func:`run` captures the core's segments
once per key into CUDA graphs and replays them for every later batch of
the key, so a batch leaves the host as a handful of graph launches.  The
same kernels run in the same order on the same values, so the outputs are
bit-equal to the eager core's.

**Segments.**  The core has two host branches on values computed on the
card (``skip_residual.all()``, ``refinable.any()``), which cut it into
segments: the head, the residual sweep or its trivial form, the base-scale
bisection where a chunk can take it, and the outputs.  The host still
reads both flags between segments.  A graph is keyed by the path of
segments that leads to it and reads the outputs of the graphs before it on
that path, so each path has its own graphs (at most nine a key), and no
graph writes into another's buffers.  The graphs of a key capture into one
memory pool, where a capture may reuse the blocks of earlier captures'
intermediates.  That is safe because a graph's outputs are read only by the
graphs after it on its path, which were captured after it, while those
outputs were alive: no graph that runs between the write of an output and
its reads can reuse its block.

**Lifecycle of a key** (``kernels.graph_key``: the device, the batch's
shape and dtype, and everything the core bakes in).  The first batch runs
eagerly, which builds the kernels, uploads the core's constants and loads
lazy modules.  A segment that has run eagerly once is captured the next
time its path is met and replayed from then on; a segment never met runs
eagerly, with the rest of its batch.  The batch is copied into the key's
static input first, and the outputs are cloned out of the pool before the
key's lock is released, so threads that encode the same shape at once
never share a graph's buffers.  At most :data:`MAX_KEYS` keys are kept; the
least recently used goes, with its graphs and pool.  A capture that fails
raises.

**Counts.**  A replayed batch moves every launch counter as an eager one
does: each wrapper call the capture noted is made again with a
``dwt_hopper.ReplayedCall`` (counted by the wrapper, seen by whatever wraps
it, launching nothing), and the kernels each library launched from the
capturing thread are added to the library's own count.  With spans on,
``core: graph captures`` and ``core: graph replays`` (``timing.count``) add
one for each segment run that way.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

from ..ops import bitplane_hopper, dwt_hopper
from ..utils import timing

MAX_KEYS = 8
# The libraries whose kernels the core launches.
_LIBRARIES = (dwt_hopper, bitplane_hopper)

_CHAINS: collections.OrderedDict = collections.OrderedDict()
_CHAINS_LOCK = threading.Lock()
# One capture at a time: the capture stream's mode checks this thread only.
_CAPTURE_LOCK = threading.Lock()


class _Segment:
    """One captured segment: its graph, its outputs (static tensors of the
    key's pool), the wrapper calls and library kernels its capture made."""

    def __init__(self, graph, outputs, calls, kernels):
        self.graph, self.outputs = graph, outputs
        self.calls, self.kernels = calls, kernels

    def replay(self):
        self.graph.replay()
        for module, name, args, kw in self.calls:
            getattr(module, name)(*args, **kw)
        for lib, n in zip(_LIBRARIES, self.kernels):
            if n:
                lib.add_kernels_launched(n)


class _Chain:
    """The graphs of one key."""

    def __init__(self, device):
        self.device = device
        self.lock = threading.Lock()
        self.x = None            # the static input
        self.pool = self.stream = None
        self.seen = set()        # paths whose segment has run eagerly
        self.segments = {}       # path -> _Segment

    def capture(self, fn, st) -> _Segment:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        graph, calls = torch.cuda.CUDAGraph(), []
        with _CAPTURE_LOCK:
            before = [lib.thread_kernels_launched() for lib in _LIBRARIES]
            with dwt_hopper.noting_calls(calls), torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                outputs = fn(st)
            kernels = [lib.thread_kernels_launched() - n
                       for lib, n in zip(_LIBRARIES, before)]
        return _Segment(graph, outputs, calls, kernels)


class _Batch:
    """One batch through a chain: each segment replays, is captured or
    runs eagerly, and once one runs eagerly the rest of the batch does."""

    def __init__(self, chain, eager: bool):
        self.chain, self.eager, self.path = chain, eager, ()

    def segment(self, name, fn, st) -> dict:
        self.path += (name,)
        ch = self.chain
        seg = None if self.eager else ch.segments.get(self.path)
        if seg is not None:
            seg.replay()
            timing.count("core: graph replays", 1)
            return seg.outputs
        if self.eager or self.path not in ch.seen:
            self.eager = True
            ch.seen.add(self.path)
            return fn(st)
        seg = ch.segments[self.path] = ch.capture(fn, st)
        seg.graph.replay()
        timing.count("core: graph captures", 1)
        return seg.outputs


def _chain(key, device) -> _Chain:
    with _CHAINS_LOCK:
        ch = _CHAINS.get(key)
        if ch is None:
            ch = _CHAINS[key] = _Chain(device)
            while len(_CHAINS) > MAX_KEYS:
                _CHAINS.popitem(last=False)
        else:
            _CHAINS.move_to_end(key)
        return ch


def _on(device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def run(key, x, chain_fn) -> dict:
    """``chain_fn(st, seg)`` -> the outputs: the core as ``seg(name, fn,
    st)`` calls, ``st`` starting as ``{"x": x}``; run through the graphs of
    ``key``.  Returns tensors that no later batch writes."""
    ch = _chain(key, x.device)
    with ch.lock, _on(x.device):
        if not ch.seen:
            return chain_fn({"x": x}, _Batch(ch, eager=True).segment)
        if ch.x is None:
            ch.x = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        ch.x.copy_(x)
        out = chain_fn({"x": ch.x}, _Batch(ch, eager=False).segment)
        return {k: v.clone() for k, v in out.items()}


def clear() -> None:
    """Drops every key, with its graphs and pool."""
    with _CHAINS_LOCK:
        _CHAINS.clear()
