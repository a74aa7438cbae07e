"""Opt-in stage spans (observability parity: the reference traces its
search loops per-trial via log_trace, ebcc_codec.c:554-803; here the stages
worth tracing are device dispatch / link transfers / host entropy work).

Enable with ``EBCC_TIMING=1``: stages log at WARNING with millisecond wall
times AND accumulate into :data:`STATS` (constant stage name -> [count,
thread seconds, self seconds]) so harnesses can publish a breakdown without
log scraping.  ``EBCC_TIMING=2`` accumulates silently (no per-stage log
lines).  Disabled, a stage costs one flag test.

Spans form a tree.  The open span is kept per thread in a ``contextvars``
variable, and the pipelines hand the submitting context to their workers
(:func:`submit`), so a worker's spans have the request's span as their
parent.  A span's self time is its wall time minus that of its children on
the same thread; a child on another thread runs in parallel and is not
subtracted.  Thread seconds overlap when stages run on concurrent threads,
so their totals attribute work, not end-to-end latency.

The same table holds counters (:func:`count`): an amount the program adds
up where its work happens, such as the significant pairs of each encode
batch by the exchange path that carried them.  A counter entry has two
items, [additions, sum of the amounts added], and no seconds; it is kept
while spans are on and costs one flag test otherwise, as a span does.
:func:`snapshot` reports the spans alone.

:func:`recording` keeps every span that closes while it is open, from every
thread, with its thread, parent and ``perf_counter_ns`` bounds;
``utils.profiling.trace`` uses it to put the spans into its Chrome trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time

from .logging import logger

_MODE = os.environ.get("EBCC_TIMING", "")
ENABLED = _MODE in ("1", "2")
_LOUD = _MODE == "1"

STATS: dict = {}
_LOCK = threading.Lock()
_CURRENT = contextvars.ContextVar("ebcc_tpu_torch_span", default=None)
_IDS = itertools.count(1)
_RECORDS = None     # list of closed spans while a recording is open


class Span:
    """One open stage: its name, id, parent span, thread, start
    (``perf_counter_ns``) and the wall seconds of its same-thread
    children."""
    __slots__ = ("name", "id", "parent", "thread", "t0", "child_s")

    def __init__(self, name: str, parent):
        self.name = name
        self.id = next(_IDS)
        self.parent = parent
        self.thread = threading.get_native_id()
        self.child_s = 0.0
        self.t0 = time.perf_counter_ns()


def reset_stats() -> None:
    with _LOCK:
        STATS.clear()


def snapshot() -> dict:
    """Span name -> {"count": n, "total_s": thread s, "self_s": self s},
    sorted by descending total; counters are left out."""
    with _LOCK:
        items = sorted(((k, v) for k, v in STATS.items() if len(v) == 3),
                       key=lambda kv: -kv[1][1])
        return {k: {"count": v[0], "total_s": round(v[1], 4),
                    "self_s": round(v[2], 4)}
                for k, v in items}


def current():
    """The innermost span open in this thread's context, or None."""
    return _CURRENT.get()


def submit(pool, fn, *args):
    """``pool.submit(fn, *args)``, run in a copy of the caller's context
    while spans are on, so that the worker's spans nest under the caller's
    open span."""
    if not ENABLED:
        return pool.submit(fn, *args)
    return pool.submit(contextvars.copy_context().run, fn, *args)


@contextlib.contextmanager
def recording():
    """Spans on for the ``with`` block; yields the list that every span
    closing meanwhile, on any thread, is appended to as ``(name, id,
    parent id, thread id, start ns, end ns, self seconds)``."""
    global ENABLED, _RECORDS
    records: list = []
    with _LOCK:
        was = ENABLED, _RECORDS
        ENABLED, _RECORDS = True, records
    try:
        yield records
    finally:
        with _LOCK:
            ENABLED, _RECORDS = was


def count(name: str, amount: int) -> None:
    """Add ``amount`` to the counter ``name`` (a constant) while spans are
    on: ``STATS[name]`` = [additions, sum]."""
    if not ENABLED:
        return
    with _LOCK:
        e = STATS.setdefault(name, [0, 0])
        e[0] += 1
        e[1] += int(amount)


@contextlib.contextmanager
def stage(name: str):
    if not ENABLED:
        yield
        return
    parent = _CURRENT.get()
    span = Span(name, parent)
    token = _CURRENT.set(span)
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        _CURRENT.reset(token)
        wall = (t1 - span.t0) / 1e9
        self_s = wall - span.child_s
        if parent is not None and parent.thread == span.thread:
            parent.child_s += wall
        with _LOCK:
            e = STATS.setdefault(name, [0, 0.0, 0.0])
            e[0] += 1
            e[1] += wall
            e[2] += self_s
            if _RECORDS is not None:
                _RECORDS.append((name, span.id,
                                 parent.id if parent is not None else None,
                                 span.thread, span.t0, t1, self_s))
        if _LOUD:
            logger.warning("[timing] %-28s %7.1f ms", name, wall * 1e3)
