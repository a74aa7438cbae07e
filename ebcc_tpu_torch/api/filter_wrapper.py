"""``EBCC_Filter``-compatible configuration mapping + cd_values codec.

The port's copy of ``ebcc_tpu/api/filter_wrapper.py`` over its own
``config.py``: the same mappings, the same ``cd_values`` and the same
``CodecConfig`` fields, so a spec or a config written by either package
means the same to the other.

API parity: reference ``ebcc/filter_wrapper.py`` — a ``Mapping`` whose items
splat directly into ``h5py.File.create_dataset(**filter)`` (fw.py:49-56), the
float<->uint32 bit punning used because HDF5 filters only carry uints
(fw.py:8-14), and the integer ``cd_values`` layout consumed by
``populate_config`` (reference ``src/h5z_ebcc.c:38-93``):

    cd_values = [height, width, float_bits(base_cr), residual_mode,
                 float_bits(error)?]

The same cd_values vocabulary is reused by the Zarr codec and the CLI, so
configurations are portable between the reference's filter id 308 and the
ETPU filter id (``FILTER_ID`` below).
"""

from __future__ import annotations

import struct
from collections.abc import Mapping
from typing import Optional, Tuple

from .. import config as cfg
from ..config import CodecConfig

# The ETPU bitstream's own HDF5 filter id, shared with ebcc_tpu.  The
# reference's id 308 carries EBCC (J2K/SPIHT) payloads which are a different
# format; advertising a distinct id keeps files self-describing.
FILTER_ID = 33030


def float_to_uint32(f: float) -> int:
    """Parity: filter_wrapper.py:12-14."""
    return struct.unpack("I", struct.pack("f", float(f)))[0]


def uint32_to_float(u: int) -> float:
    return struct.unpack("f", struct.pack("I", int(u) & 0xFFFFFFFF))[0]


def double_to_uint32(f: float) -> Tuple[int, int]:
    """Parity: filter_wrapper.py:8-10."""
    return struct.unpack("II", struct.pack("d", float(f)))


_MODE_BY_NAME = {
    "none": cfg.RESIDUAL_NONE,
    "max_error_target": cfg.RESIDUAL_MAX_ERROR,
    "relative_error_target": cfg.RESIDUAL_RELATIVE_ERROR,
    # TPU-build extensions (the reference enum stops at relative):
    # |x̂-x| <= err*|x| pointwise (strictly positive data only), and
    # bit-exact lossless (no error value).
    "pointwise_relative_error_target": cfg.RESIDUAL_POINTWISE_RELATIVE_ERROR,
    "lossless": cfg.RESIDUAL_LOSSLESS,
}

# Modes that carry no error value in cd_values.
_NO_ERROR_MODES = (cfg.RESIDUAL_NONE, cfg.RESIDUAL_LOSSLESS)

# cd_values[5] flags word (TPU-build extension; absent = 0 keeps the
# reference's 4/5-value layouts valid).
FLAGS_TEMPORAL = 0x1
FLAGS_ALLOW_NAN = 0x2


class EBCC_Filter(Mapping):
    """Drop-in equivalent of the reference's ``EBCC_Filter`` Mapping
    (filter_wrapper.py:16-68)."""

    FILTER_ID = FILTER_ID

    def __init__(self, base_cr: float, height: int, width: int,
                 residual_opt: Optional[Tuple[str, float]],
                 data_dim: int = 2, temporal_chunk: int = 0,
                 allow_nan: bool = False):
        """``temporal_chunk`` (TPU-build extension, no reference
        counterpart): >1 makes each HDF5 chunk span that many leading-dim
        frames coded with closed-loop temporal prediction (requires an
        error-bounded ``residual_opt``; see config.CodecConfig.temporal).

        ``allow_nan`` (TPU-build extension): accept NaN samples — they are
        masked out of the encode and restored on decode; the error bound
        applies to the valid samples (see config.CodecConfig.allow_nan).
        The reference filter hard-exits on NaN input."""
        assert height > 0 and width > 0
        base_cr = float(base_cr)
        self.base_cr = base_cr
        self.height = int(height)
        self.width = int(width)
        self.residual_opt = residual_opt or ("none", 0)
        self.data_dim = int(data_dim)
        self.temporal_chunk = int(temporal_chunk)
        self.allow_nan = bool(allow_nan)

        opts = [self.height, self.width, float_to_uint32(base_cr)]
        name, val = self.residual_opt
        if name not in _MODE_BY_NAME:
            raise ValueError(
                f"Unknown residual_type {name!r}, has to be one of "
                + ", ".join(repr(k) for k in _MODE_BY_NAME))
        mode = _MODE_BY_NAME[name]
        opts.append(mode)
        if mode not in _NO_ERROR_MODES:
            opts.append(float_to_uint32(float(val)))
        flags = 0
        if self.temporal_chunk > 1:
            if mode in _NO_ERROR_MODES:
                raise ValueError(
                    "temporal_chunk requires an error-bounded residual_opt")
            if self.data_dim < 3:
                raise ValueError("temporal_chunk requires data_dim >= 3")
            flags |= FLAGS_TEMPORAL
        if self.allow_nan:
            flags |= FLAGS_ALLOW_NAN
        if flags:
            opts.append(flags)  # flags word after the mode/error values
        self.hdf_filter_opts = tuple(opts)
        lead = self.temporal_chunk if self.temporal_chunk > 1 else 1
        self.chunks = (*[1] * (self.data_dim - 3), lead,
                       self.height, self.width)[-self.data_dim:]

    @property
    def _kwargs(self):
        return {
            "dtype": "float32",
            "chunks": self.chunks,
            "compression": self.FILTER_ID,
            "compression_opts": self.hdf_filter_opts,
        }

    def __hash__(self):
        return hash((self.FILTER_ID, self.hdf_filter_opts))

    def __len__(self):
        return len(self._kwargs)

    def __iter__(self):
        return iter(self._kwargs)

    def __getitem__(self, item):
        return self._kwargs[item]


def populate_config(cd_values, buf_size_bytes: int) -> CodecConfig:
    """cd_values -> CodecConfig, inferring the leading dim from the buffer
    size.  Parity: ``populate_config`` (h5z_ebcc.c:38-93) including exact
    divisibility and [MIN, MAX] tile validation."""
    cd_values = [int(v) for v in cd_values]
    if len(cd_values) < 4:
        raise ValueError(
            f"EBCC filter requires at least 4 configuration values, got "
            f"{len(cd_values)}")
    height, width = cd_values[0], cd_values[1]
    lo, hi = cfg.MIN_INTERNAL_IMAGE_DIM, cfg.MAX_INTERNAL_IMAGE_DIM
    if not (lo <= height <= hi and lo <= width <= hi):
        raise ValueError(
            f"Tile size {height} x {width} is invalid, each dimension must "
            f"be between {lo} and {hi}")
    tile_size = height * width
    n_values = buf_size_bytes // 4
    if n_values < tile_size:
        raise ValueError(
            f"Buffer size {n_values} is smaller than the tile size "
            f"{height} x {width} = {tile_size}")
    if n_values % tile_size != 0:
        raise ValueError(
            f"Buffer size {n_values} is not divisible by the tile size "
            f"{height} x {width} = {tile_size}")
    n_frames = n_values // tile_size

    base_cr = uint32_to_float(cd_values[2])
    mode = cd_values[3]
    error = 0.0
    nxt = 4
    if mode in (cfg.RESIDUAL_MAX_ERROR, cfg.RESIDUAL_RELATIVE_ERROR,
                cfg.RESIDUAL_POINTWISE_RELATIVE_ERROR):
        if len(cd_values) < 5:
            raise ValueError("error-bounded mode requires 5 cd_values")
        error = uint32_to_float(cd_values[4])
        nxt = 5
    elif mode not in _NO_ERROR_MODES:
        raise ValueError(f"invalid residual mode {mode}")
    flags = cd_values[nxt] if len(cd_values) > nxt else 0
    temporal = (bool(flags & FLAGS_TEMPORAL) and n_frames > 1
                and mode not in _NO_ERROR_MODES)

    return CodecConfig(dims=(n_frames, height, width), base_cr=base_cr,
                       residual_mode=mode, error=error, temporal=temporal,
                       allow_nan=bool(flags & FLAGS_ALLOW_NAN))
