"""Automatic backend routing for host-destined codec calls.

The port's copy of ``ebcc_tpu/core/routing.py``.  The numpy entry points
(``encode``/``decode``/``encode_chunked``/``decode_chunked``/
``decode_chunked_region``) run through the device (batched programs and
the sparse exchange) or entirely on the host through the port's C++ codec
(``native.load_codec``).  Which wins is a property of the machine: a
host-destined call through the device moves the raw frames across the
host<->device link both ways, so once that link is slow against the host's
cores the host codec wins; over a healthy PCIe link the device does.

Policy (first call per process, then cached):
  1. ``EBCC_ENCODE_BACKEND`` / ``EBCC_DECODE_BACKEND`` = ``native`` (or
     ``host``) or ``device`` (or ``jax``, ``tpu``, ``accel``) decide; unset
     or ``auto`` = decide here.
  2. Without a host codec that builds (on a machine without zstd) the
     device path is the only one.
  3. Otherwise compare modeled per-point costs:
       device ~ bytes_up/link_up + bytes_down/link_down
       native ~ 1 / (per-core rate x cores)
     with the link's rate from ``EBCC_LINK_MBPS`` (one number, both
     directions) or a one-time 4 MB probe of the call's device.  The
     native per-core rates are the reference's conservative model, so the
     device path wins whenever it is close.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from ..utils.logging import logger

# Bytes per grid point moved by the device path for host-destined calls:
# float32 frames up (4 B/pt); the exchange legs (~0.1-0.3 B/pt at typical
# bounds, see core.transfer) padded to 1 B/pt for per-leg latency the
# byte model cannot see.
_ENC_UP_BPP, _ENC_DOWN_BPP = 4.0, 1.0
_DEC_UP_BPP, _DEC_DOWN_BPP = 1.0, 4.0

# Conservative native throughput model (pts/s per core).
_NATIVE_ENC_PPS = 2.5e6
_NATIVE_DEC_PPS = 15e6

_PROBE_BYTES = 4 << 20

_cache: dict = {}
# Concurrent first calls (the pipelined paths fan out worker threads) must
# not run duplicate probes or builds; the lock also makes the fill atomic.
_cache_lock = threading.Lock()


def _native_available() -> bool:
    with _cache_lock:
        if "native_ok" not in _cache:
            from .. import native

            try:
                native.load_codec()
                _cache["native_ok"] = True
            except (RuntimeError, OSError):
                _cache["native_ok"] = False
        return _cache["native_ok"]


def link_mbps(device="cuda") -> tuple:
    """(up, down) host<->``device`` bandwidth in MB/s; (0, 0) = no usable
    device.  ``EBCC_LINK_MBPS`` (one number, both directions) skips the
    probe.  The probe is two rounds of a 4 MB incompressible upload, a
    fetch of its last 8 bytes (which waits for the upload) and a fetch of
    the whole buffer; the second round is timed.  Cached per device."""
    key = ("link", str(device))
    with _cache_lock:
        if key in _cache:
            return _cache[key]
        env = os.environ.get("EBCC_LINK_MBPS")
        if env:
            v = float(env)
            _cache[key] = (v, v)
            return _cache[key]
        dev = torch.device(device)
        try:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("no CUDA device")
            # A distinct random payload per round: a transport that
            # compresses or dedupes would otherwise inflate the estimate.
            rng = np.random.default_rng(0)

            def probe_once():
                x = torch.from_numpy(rng.integers(0, 256, _PROBE_BYTES,
                                                  np.uint8))
                t0 = time.perf_counter()
                a = x.to(dev)
                a[-8:].cpu()
                t1 = time.perf_counter()
                a.cpu()
                t2 = time.perf_counter()
                return t1 - t0, t2 - t1

            probe_once()  # warm-up: context, allocator
            tu, td = probe_once()
            up = _PROBE_BYTES / max(tu, 1e-9) / 1e6
            down = _PROBE_BYTES / max(td, 1e-9) / 1e6
        except (RuntimeError, ValueError):
            up = down = 0.0
        _cache[key] = (up, down)
    logger.info("link probe (%s): %.1f MB/s up, %.1f MB/s down", device, up,
                down)
    return _cache[key]


def explicit(kind: str):
    """The explicit env override for ``kind`` ("encode"/"decode"), or None."""
    v = os.environ.get(f"EBCC_{kind.upper()}_BACKEND", "").lower()
    if v in ("native", "host"):
        return "native"
    if v in ("device", "jax", "tpu", "accel"):
        return "device"
    return None


def backend_choice(kind: str, device="cuda") -> str:
    """-> "native" or "device" for host-destined ``kind`` calls on
    ``device``."""
    e = explicit(kind)
    if e is not None:
        return e
    if not _native_available():
        return "device"
    up, down = link_mbps(device)
    if up <= 0 or down <= 0:
        return "native"  # no reachable device at all
    cores = os.cpu_count() or 1
    if kind == "encode":
        dev_spp = (_ENC_UP_BPP / (up * 1e6)) + (_ENC_DOWN_BPP / (down * 1e6))
        nat_spp = 1.0 / (_NATIVE_ENC_PPS * cores)
    else:
        dev_spp = (_DEC_UP_BPP / (up * 1e6)) + (_DEC_DOWN_BPP / (down * 1e6))
        nat_spp = 1.0 / (_NATIVE_DEC_PPS * cores)
    choice = "native" if nat_spp < dev_spp else "device"
    key = f"logged_{kind}"
    with _cache_lock:
        first = key not in _cache
        _cache[key] = True
    if first:
        logger.info("auto-routing host %s path -> %s (link %.0f/%.0f MB/s)",
                    kind, choice, up, down)
    return choice


def reset_cache() -> None:
    """Drop cached probe and availability results (tests)."""
    with _cache_lock:
        _cache.clear()
