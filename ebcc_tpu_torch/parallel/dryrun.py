"""A dry run of the scale-out paths on tiny shapes.

The port's counterpart of ``__graft_entry__.py`` ``dryrun_multichip``: over
a mesh of ``n_devices`` devices it runs, once each, the production
(intra) encode, the temporal encode, the global-range collective and the
sparse decode, and checks what comes back.
"""

from __future__ import annotations

import numpy as np

from ..config import CodecConfig, RESIDUAL_MAX_ERROR
from .mesh import make_mesh
from .sharded import decode_chunked_sharded, encode_chunked_sharded, \
    global_range

ERROR = 0.5


def dryrun_multidevice(n_devices: int, device="cuda") -> dict:
    """Run each scale-out step over ``n_devices`` devices of kind
    ``device`` (the card unless ``device="cpu"``), two 64x64 chunks per
    device -> container bytes and max errors.  Raises when a decode breaks
    the bound or the global range is wrong."""
    mesh = make_mesh(device=device, n=n_devices)
    b = 2 * n_devices
    rng = np.random.default_rng(0)
    out = {}
    for name, t in (("intra", 1), ("temporal", 3)):
        x = (rng.normal(size=(b * t, 64, 64)) * 10 + 270).astype(np.float32)
        config = CodecConfig(dims=x.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR, error=ERROR,
                             chunk_dims=(t, 64, 64), temporal=t > 1)
        blob = encode_chunked_sharded(x, config, mesh=mesh)
        err = float(np.abs(decode_chunked_sharded(blob, mesh) - x).max())
        if not err <= ERROR:
            raise AssertionError(f"{name} dry run: max error {err}")
        out[name] = {"bytes": len(blob), "max_error": err}
    rng_got = global_range(x, mesh)
    if rng_got != (float(x.min()), float(x.max())):
        raise AssertionError(f"global range {rng_got}")
    out["global_range"] = rng_got
    return out
