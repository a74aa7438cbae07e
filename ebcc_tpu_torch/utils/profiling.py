"""Profiling hooks.

The port's counterpart of ``ebcc_tpu/utils/profiling.py``: :func:`trace`
wraps codec work in ``torch.profiler`` (CPU activity, and the card's when
there is one) and writes a Chrome trace, which ``chrome://tracing`` or
Perfetto open; :func:`annotate` names a region inside it, and in NVTX on
the card.  Parity with the reference's ``ENABLE_PERF`` build option, which
scopes ``perf stat`` to codec work (CMakeLists.txt:21, ebcc_codec.c:8-10).

The trace goes to ``profile_dir``, else to ``EBCC_PROFILE_DIR``; with
neither, :func:`trace` does nothing.  The codec does not call these hooks
itself.
"""

from __future__ import annotations

import contextlib
import itertools
import os

import torch

PROFILE_DIR = os.environ.get("EBCC_PROFILE_DIR")
_SEQ = itertools.count()


@contextlib.contextmanager
def trace(name: str = "ebcc_tpu_torch", profile_dir: str | None = None):
    """Profile the ``with`` block and write its Chrome trace to
    ``<dir>/<name>.<pid>.<n>.pt.trace.json`` (a no-op when no directory is
    configured)."""
    target = profile_dir or PROFILE_DIR
    if not target:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with annotate(name):
            yield
    prof.export_chrome_trace(os.path.join(
        target, f"{name}.{os.getpid()}.{next(_SEQ)}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region: a ``record_function`` range in an active trace and,
    when the card is in use, an NVTX range."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
