"""The traced stretch: ``torch.profiler`` over a few requests, and what the
per-layer metrics read from it.

The device's busy time is the union of its operations' intervals (kernels,
copies, fills) inside the stretch, frozen from
``scripts/torch_attribute_roundtrip.py``; the idle share is the rest of the
stretch's wall.  Each idle gap is named by the innermost of the program's
stage spans (``ebcc_tpu_torch.utils.timing.stage``, which the harness mirrors
into profiler ranges for the stretch) open at its middle.  Kernel calls of
the wavelet wrappers are recorded with their shapes, so a roofline pairs
each kernel family's bytes with its device time over the same calls.
Everything stays in memory; nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field

import torch

STAGE_PREFIX = "stage: "
WINDOW_RANGE = "portbench: traced stretch"
NOT_KERNELS = ("Memcpy", "Memset")
# Kernel names of each wavelet family (``csrc/dwt97.cu``).
FAMILIES = {"k1": ("fwd_tile", "fwd_coarse"),
            "k2": ("inv_tile", "inv_coarse")}
WRAPPERS = {"dwt2d_quantize": "k1", "dwt2d_transform": "k1",
            "idwt2d_dequant": "k2"}


@dataclass
class Trace:
    window_s: float             # the stretch's range on the profiler's clock
    frames: int
    busy_s: float
    device_ops: list            # [(name, start_us, end_us)]
    stage_idle_s: dict          # host stage -> idle device seconds
    calls: dict = field(default_factory=dict)   # family -> [(kind, shape, levels)]

    def kernels(self):
        return [e for e in self.device_ops
                if not e[0].startswith(NOT_KERNELS)]

    def family_device_s(self, family: str) -> float:
        names = FAMILIES[family]
        return sum(e - s for n, s, e in self.kernels()
                   if any(k in n for k in names)) / 1e6

    def top_ops(self, n=10):
        by = {}
        for name, s, e in self.device_ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n=10):
        return sorted(([k, v] for k, v in self.stage_idle_s.items()),
                      key=lambda kv: -kv[1])[:n]


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo, hi):
    """The sub-intervals of [lo, hi] that no interval covers."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


def name_gaps(gaps, stages) -> dict:
    """Idle seconds per name of the innermost stage span open at each
    gap's middle ("between stages" where none is)."""
    out = {}
    for s, e in gaps:
        mid = (s + e) / 2
        best = None
        for name, a, b in stages:
            if a <= mid <= b and (best is None or a > best[1]):
                best = (name, a)
        key = best[0] if best else "between stages"
        out[key] = out.get(key, 0.0) + (e - s) / 1e6
    return out


@contextlib.contextmanager
def instrument(codec_module, dwt_module, calls: dict):
    """For the traced stretch only: mirror the program's stage spans into
    profiler ranges, and record each wavelet wrapper call's shape."""
    orig_stage = codec_module.stage

    @contextlib.contextmanager
    def stage(name):
        with torch.profiler.record_function(STAGE_PREFIX + name), \
                orig_stage(name):
            yield

    def recorded(kind, fn):
        @functools.wraps(fn)
        def wrapper(x, *args, **kw):
            levels = args[-1] if args else kw["levels"]
            calls.setdefault(WRAPPERS[kind], []).append(
                (kind, tuple(x.shape), int(levels)))
            return fn(x, *args, **kw)
        return wrapper

    originals = {k: getattr(dwt_module, k) for k in WRAPPERS}
    codec_module.stage = stage
    for k, fn in originals.items():
        setattr(dwt_module, k, recorded(k, fn))
    try:
        yield
    finally:
        codec_module.stage = orig_stage
        for k, fn in originals.items():
            setattr(dwt_module, k, fn)


def profile_stretch(run_requests, frames: int, codec_module, dwt_module,
                    device) -> Trace:
    """Profile ``run_requests()`` (a few whole requests, ``frames`` frames
    in all) on ``device``."""
    from torch.profiler import ProfilerActivity, profile
    calls: dict = {}
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    with profile(activities=activities) as prof:
        with instrument(codec_module, dwt_module, calls):
            with torch.profiler.record_function(WINDOW_RANGE):
                run_requests()
                sync()
    device_ops, stages, window = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        ours = ev.name == WINDOW_RANGE or ev.name.startswith(STAGE_PREFIX)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # Profiler ranges are mirrored onto the device's timeline as
            # annotations; they are not device work.
            if not ours:
                device_ops.append((ev.name, s, e))
        elif ev.name == WINDOW_RANGE:
            window = (s, e)
        elif ev.name.startswith(STAGE_PREFIX):
            stages.append((ev.name[len(STAGE_PREFIX):], s, e))
    if window is None:
        raise RuntimeError("the profiler lost the traced stretch's range")
    lo, hi = window
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device_ops
              if e > lo and s < hi]
    spans = [(s, e) for _, s, e in inside]
    return Trace(window_s=(hi - lo) / 1e6, frames=frames,
                 busy_s=union_length(spans) / 1e6,
                 device_ops=inside,
                 stage_idle_s=name_gaps(idle_gaps(spans, lo, hi), stages),
                 calls=calls)
