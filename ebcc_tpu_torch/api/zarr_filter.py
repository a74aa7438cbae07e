"""numcodecs Codec for Zarr integration.

The port's counterpart of ``ebcc_tpu/api/zarr_filter.py``: the same
``codec_id`` (``"ebcc_tpu_filter"``), the same config and the same bytes (an
ETPU stream per Zarr chunk), so an array written through either package
opens with the other.  When both packages are imported, both register the
id with numcodecs, and whichever registers last serves it.

API parity: reference ``ebcc/zarr_filter.py`` — ``EBCCZarrFilter(Codec)``,
constructed from the uint32 ``arglist`` (cd_values) vocabulary, encode and
decode of raveled float32 buffers, numcodecs registration (zf.py:19-88).
Here the codec runs on the CUDA card, or on the CPU with
``device="cpu"`` (a runtime choice, so not part of the config).

``numcodecs`` is optional and imported with this module (not with
``ebcc_tpu_torch.api``).  When it is absent, a minimal stand-in base class
keeps the codec usable directly (``encode``/``decode``/``get_config``);
only automatic Zarr integration needs the real package.
"""

from __future__ import annotations

import numpy as np

try:
    import numcodecs
    from numcodecs.abc import Codec as _Codec
    _HAVE_NUMCODECS = True
except ImportError:  # pragma: no cover - numcodecs optional
    _HAVE_NUMCODECS = False

    class _Codec:  # minimal protocol stand-in
        codec_id: str = ""

        def get_config(self):
            raise NotImplementedError

        @classmethod
        def from_config(cls, config):
            return cls(**{k: v for k, v in config.items() if k != "id"})


from ..core import codec as _codec
from .filter_wrapper import populate_config


class EBCCZarrFilter(_Codec):
    """Parity: EBCCZarrFilter (zarr_filter.py:19-88)."""

    codec_id = "ebcc_tpu_filter"

    def __init__(self, arglist, device="cuda"):
        self.arglist = np.array(arglist, dtype=np.uint32)
        self.device = device

    def encode(self, buf):
        if not isinstance(buf, np.ndarray) or buf.dtype != np.float32:
            raise TypeError("input buffer must be a float32 numpy array")
        buf = np.ascontiguousarray(buf).ravel()
        config = populate_config(self.arglist, buf.nbytes)
        return _codec.encode(buf.reshape(config.dims), config,
                             device=self.device)

    def decode(self, buf, out=None):
        decoded = _codec.decode(bytes(buf), device=self.device).ravel()
        if out is not None:
            out_view = out.view(np.float32).ravel()
            out_view[:] = decoded
            return out
        return decoded

    def get_config(self):
        return {"id": self.codec_id,
                "arglist": self.arglist.astype(int).tolist()}

    @classmethod
    def from_config(cls, config):
        return cls(config["arglist"])


if _HAVE_NUMCODECS:  # registration parity (zarr_filter.py:88)
    numcodecs.register_codec(EBCCZarrFilter)
