"""Profiling hooks.

The port's counterpart of ``ebcc_tpu/utils/profiling.py``: :func:`trace`
wraps codec work in ``torch.profiler`` (CPU activity, and the card's when
there is one) and writes a Chrome trace, which ``chrome://tracing`` or
Perfetto open; :func:`annotate` names a region inside it, and in NVTX on
the card.  Parity with the reference's ``ENABLE_PERF`` build option, which
scopes ``perf stat`` to codec work (CMakeLists.txt:21, ebcc_codec.c:8-10).

A session also records the program's stage spans (``utils.timing``) from
every thread, and appends them to the Chrome trace as complete events
(category ``ebcc_span``) on the trace's own clock, each with its thread,
span id, parent id and self time: an idle gap of the card lines up with the
host span that was running at that moment, on whichever thread.  The
offset between ``time.perf_counter_ns`` and the trace's clock comes from
the session's own ``annotate`` range, whose open and close the trace
stamps and ``perf_counter_ns`` brackets.

The trace goes to ``profile_dir``, else to ``EBCC_PROFILE_DIR``; with
neither, :func:`trace` does nothing.  The codec does not call these hooks
itself.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time

import torch

from . import timing
from .logging import logger

PROFILE_DIR = os.environ.get("EBCC_PROFILE_DIR")
SPAN_CATEGORY = "ebcc_span"
_SEQ = itertools.count()


@contextlib.contextmanager
def trace(name: str = "ebcc_tpu_torch", profile_dir: str | None = None):
    """Profile the ``with`` block and write its Chrome trace, with the
    program's spans, to ``<dir>/<name>.<pid>.<n>.pt.trace.json`` (a no-op
    when no directory is configured)."""
    target = profile_dir or PROFILE_DIR
    if not target:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    now = time.perf_counter_ns
    with torch.profiler.profile(activities=activities) as prof:
        with timing.recording() as spans:
            open_ns = [now()]
            with annotate(name):
                open_ns.append(now())
                yield
                close_ns = [now()]
            close_ns.append(now())
    path = os.path.join(target,
                        f"{name}.{os.getpid()}.{next(_SEQ)}.pt.trace.json")
    prof.export_chrome_trace(path)
    add_spans(path, name, open_ns, close_ns, spans)


def clock_offset(ts_us: float, end_us: float, open_ns, close_ns) -> float:
    """Microseconds of the trace's clock minus those of
    ``perf_counter_ns``, from a range that opened at ``ts_us`` and closed
    at ``end_us`` on the trace's clock, between the two ``perf_counter_ns``
    readings of ``open_ns`` and of ``close_ns``.  Each end bounds the
    offset to an interval; the middle of their overlap, else of the
    narrower one."""
    a = (ts_us - open_ns[1] / 1e3, ts_us - open_ns[0] / 1e3)
    b = (end_us - close_ns[1] / 1e3, end_us - close_ns[0] / 1e3)
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    if lo > hi:
        lo, hi = min(a, b, key=lambda iv: iv[1] - iv[0])
    return (lo + hi) / 2


def add_spans(path: str, anchor: str, open_ns, close_ns, spans) -> None:
    """Append ``spans`` (records of ``timing.recording``) to the Chrome
    trace at ``path``, placed on its clock by the host range named
    ``anchor``, which opened and closed between the ``perf_counter_ns``
    readings of ``open_ns`` and of ``close_ns``."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    ranges = [e for e in events if e.get("name") == anchor
              and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not ranges:
        logger.warning("profiling: no range %r in %s; the program's spans "
                       "are left out", anchor, path)
        return
    r = ranges[0]
    offset = clock_offset(r["ts"], r["ts"] + r["dur"], open_ns, close_ns)
    pid = os.getpid()
    for name, sid, parent, tid, t0, t1, self_s in spans:
        events.append({
            "ph": "X", "cat": SPAN_CATEGORY, "name": name, "pid": pid,
            "tid": tid, "ts": t0 / 1e3 + offset, "dur": (t1 - t0) / 1e3,
            "args": {"span": sid, "parent": parent,
                     "self_us": self_s * 1e6}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def annotate(name: str):
    """A named region: a ``record_function`` range in an active trace and,
    when the card is in use, an NVTX range."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
