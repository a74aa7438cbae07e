"""Opt-in stage timing (observability parity: the reference traces its
search loops per-trial via log_trace, ebcc_codec.c:554-803; here the stages
worth tracing are device dispatch / link transfers / host entropy work).

Enable with ``EBCC_TIMING=1``: stages log at WARNING with millisecond wall
times AND accumulate into :data:`STATS` (normalized name -> [count,
total_seconds]) so harnesses can publish a breakdown without log
scraping.  ``EBCC_TIMING=2`` accumulates silently (no per-stage log
lines).  Zero overhead when disabled.

Stage wall times overlap when stages run on concurrent threads (the
pipelined encode/decode paths), so the totals attribute work, not
end-to-end latency.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
import time

from .logging import logger

_MODE = os.environ.get("EBCC_TIMING", "")
ENABLED = _MODE in ("1", "2")
_LOUD = _MODE == "1"

STATS: dict = {}
_LOCK = threading.Lock()
_DIGITS = re.compile(r"\d+")


def reset_stats() -> None:
    with _LOCK:
        STATS.clear()


def snapshot() -> dict:
    """name -> {"count": n, "total_s": s}, sorted by descending total."""
    with _LOCK:
        items = sorted(STATS.items(), key=lambda kv: -kv[1][1])
        return {k: {"count": v[0], "total_s": round(v[1], 4)}
                for k, v in items}


@contextlib.contextmanager
def stage(name: str):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        key = _DIGITS.sub("N", name)
        with _LOCK:
            e = STATS.setdefault(key, [0, 0.0])
            e[0] += 1
            e[1] += dt
        if _LOUD:
            logger.warning("[timing] %-28s %7.1f ms", name, dt * 1e3)
