"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU.  There
is deliberately no "CUDA when present, else CPU" rule: a request for the card
on a machine without one raises, so a run never silently measures or ships
the CPU path.
"""

from __future__ import annotations

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
