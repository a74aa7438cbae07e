"""JPEG2000 base-layer wrappers over Pillow/OpenJPEG (the PyTorch port's
copy of ``ebcc_tpu/compat/j2k.py``).

Role parity: j2k_encode_internal / j2k_decode_internal
(reference src/ebcc_codec.c:105-180, 1092-1136).  The reference drives
OpenJPEG directly: raw J2K codestream, one 16-bit unsigned grayscale
component, irreversible CDF 9/7, single quality layer with
``tcp_rates[0] = base_cr / 2`` (halved because the uint16 image is half the
bytes of the float32 source), and one tile per frame when several frames
are flattened into one image.  Pillow's JPEG2000 plugin exposes exactly
those knobs over the same library, so streams are mutually decodable.
"""

from __future__ import annotations

import io

import numpy as np


class J2KUnavailable(RuntimeError):
    pass


def _pil():
    try:
        from PIL import Image, features
    except ImportError as e:  # pragma: no cover - PIL is in the image
        raise J2KUnavailable("Pillow is required for legacy EBCC interop") from e
    if not features.check("jpg_2000"):  # pragma: no cover
        raise J2KUnavailable("Pillow lacks OpenJPEG (JPEG2000) support")
    return Image


def encode(scaled: np.ndarray, base_cr: float, tile_rows: int) -> bytes:
    """uint16 image (flattened frames stacked on rows) -> J2K codestream.

    ``base_cr`` carries the reference's API semantics: the actual opj rate
    is ``base_cr / 2`` (ebcc_codec.c:116).  ``tile_rows`` is the per-frame
    height; multiple frames become one J2K tile each (ebcc_codec.c:121-125).
    """
    Image = _pil()
    if scaled.dtype != np.uint16 or scaled.ndim != 2:
        raise ValueError("J2K base layer expects a 2-D uint16 image")
    h, w = scaled.shape
    img = Image.fromarray(scaled)  # mode I;16
    opts = dict(format="JPEG2000", no_jp2=True, quality_mode="rates",
                quality_layers=[float(base_cr) / 2.0], irreversible=True)
    if tile_rows and h // tile_rows > 1:
        opts["tile_size"] = (w, tile_rows)  # (cp_tdx, cp_tdy)
    buf = io.BytesIO()
    img.save(buf, **opts)
    return buf.getvalue()


def decode(blob: bytes, minval: float, maxval: float) -> np.ndarray:
    """J2K codestream -> float32 frame rescaled into [minval, maxval]
    (parity: ebcc_codec.c:1129-1131)."""
    Image = _pil()
    img = Image.open(io.BytesIO(blob))
    arr = np.asarray(img)
    if arr.ndim != 2:
        raise ValueError("legacy base layer must be single-component")
    # Same f32 expression shape as the reference rescale (c:1130) so the two
    # implementations agree to the ulp on identical codestreams.
    return ((arr.astype(np.float32) / np.float32(65535))
            * (np.float32(maxval) - np.float32(minval)) + np.float32(minval))
