"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU.  There
is deliberately no "CUDA when present, else CPU" rule: a request for the card
on a machine without one raises, so a run never silently measures or ships
the CPU path.
"""

from __future__ import annotations

import threading

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or torch.device) -> torch.device; raises RuntimeError
    when a CUDA device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ebcc_tpu_torch: a CUDA device was requested but none is "
                "available; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


_CONSTANTS: dict = {}
_CONSTANTS_LOCK = threading.Lock()


def constant(values, dtype, device) -> torch.Tensor:
    """A tensor of host ``values`` on ``device``, uploaded once per
    (values, dtype, device) and shared by every caller, who must not write
    it.  A fresh upload per call would synchronise the host with the stream,
    and a stream that captures a CUDA graph takes none (a missing constant
    raises there)."""
    key = (tuple(values), dtype, str(device))
    with _CONSTANTS_LOCK:
        t = _CONSTANTS.get(key)
        if t is None:
            t = _CONSTANTS[key] = torch.tensor(key[0], dtype=dtype,
                                               device=device)
        return t
