"""Codec configuration (the PyTorch port's own copy of ``ebcc_tpu/config.py``;
the two must stay field-for-field equal, see ``ebcc_tpu_torch.convert``).

Parity: mirrors the reference ``codec_config_t`` (reference
``src/ebcc_codec.h:26-39``: dims[3], base_cr, residual mode, error,
chunk_dims[3]; ``residual_cr`` is vestigial there and intentionally omitted
here) plus the env-var overrides the reference reads per encode call
(``src/ebcc_codec.c:630-650``, README.md:81-84):

  * ``EBCC_INIT_BASE_ERROR_QUANTILE`` — base-layer error quantile (default
    1e-6; ``0`` forces quantile target 1.0, i.e. pure-base).
  * ``EBCC_DISABLE_PURE_BASE_COMPRESSION_FALLBACK`` — disable the
    pure-base-vs-base+residual size comparison.
  * ``EBCC_DISABLE_MEAN_ADJUSTMENT`` — disable folding the mean error into
    the stored min/max.
  * ``EBCC_DISABLE_PURE_BASE_COMPRESSION_FALLBACK_CONSISTENCY`` — accepted
    for CLI/env parity; a no-op here (the TPU build's scan-based search has
    no re-encode step whose determinism would need pinning, cf. reference
    ebcc_codec.c:828-835).
  * ``EBCC_LOG_LEVEL`` — 0..5 (TRACE..FATAL), see ``ebcc_tpu_torch.utils.logging``.

TPU-build extensions (not in the reference): wavelet depths per layer,
entropy backend level, and the internal bitplane counts.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

NDIMS = 3
MIN_INTERNAL_IMAGE_DIM = 32  # parity: EBCC_MIN_INTERNAL_IMAGE_DIM (ebcc_codec.h:16)
MAX_INTERNAL_IMAGE_DIM = 2047  # parity: EBCC_MAX_INTERNAL_IMAGE_DIM (ebcc_codec.h:17)

RESIDUAL_NONE = 0
RESIDUAL_MAX_ERROR = 1
RESIDUAL_RELATIVE_ERROR = 2
# Beyond reference (its enum stops at 2, ebcc_codec.h:23-27): POINTWISE
# relative bound |x̂ - x| <= error * |x| on every sample — the bound
# magnitude-spanning fields (humidity, ozone, precipitation) need, where
# a range-relative bound lets small values drown.  Requires strictly
# positive data; implemented as a log-domain MAX_ERROR encode with target
# log1p(error) minus the float32 log/exp margin (stream flag bit6,
# docs/FORMAT.md), so the existing scans guarantee the bound exactly and
# temporal/allow_nan compose unchanged.
RESIDUAL_POINTWISE_RELATIVE_ERROR = 3
# Beyond reference: bit-exact float32 round trip (archives keep some
# variables exact).  Order-preserving float->uint32 map, per-frame 2-D
# Lorenzo prediction, zstd — ~2.9x on ERA5 at level 9, NaN/Inf round-trip
# bit-exactly (no finite check applies).  Stream flag bit7
# (FLAG_LOSSLESS); host/native coders (no device compute to accelerate —
# the transform is memory-bound and the payload is the data).
RESIDUAL_LOSSLESS = 4

_RESIDUAL_NAMES = {RESIDUAL_NONE: "NONE", RESIDUAL_MAX_ERROR: "MAX_ERROR",
                   RESIDUAL_RELATIVE_ERROR: "RELATIVE_ERROR",
                   RESIDUAL_POINTWISE_RELATIVE_ERROR:
                       "POINTWISE_RELATIVE_ERROR",
                   RESIDUAL_LOSSLESS: "LOSSLESS"}

# Static bitplane counts. Base coefficients live on a [0, 65535] scale
# (parity with the reference's uint16 quantization, ebcc_codec.c:686-689).
# The scaled 9/7 lifting has DC gain sqrt(2) per 1-D pass => gain 2 per 2-D
# level => |coeff| <= 65535 * 2^5 < 2^22 at 5 levels.  Residual
# coefficients live on a [0, 255] scale (parity with MAXELEM,
# spiht_re.h:12) => |coeff| <= 255 * 2^3 < 2^12 at 3 levels.  The encoder
# also verifies no coefficient overflows the static plane count at runtime.
# The residual layer additionally sweeps fractional quantization scales
# (RES_SCALE_STEPS) for sub-octave rate granularity; the largest step times
# the 255 * 2^3 coefficient bound stays under 2^13.
BASE_NUM_PLANES = 22
RES_NUM_PLANES = 13
RES_SCALE_STEPS = (1.0, 1.33, 1.78, 2.37)
# Post-selection scale refinement (bound utilization): after the discrete
# (scale, cut) sweep picks its operating point, the encoder coarsens the
# selected scale by these sub-grid ratios at the SAME cut and adopts the
# coarsest candidate still feasible.  The discrete grid's ~1.33x step
# granularity otherwise strands the shipped max_error near 75% of the
# target (the reference's truncation search lands ~83%, ebcc_codec.c:
# 765-807); each ratio costs one requantize + one inverse-DWT feasibility
# eval.  Ordered coarsest-first; 1.33 extends BELOW the grid when the
# 1.0-scale candidate won (the only case it can fire — see kernels.py).
RES_REFINE_RATIOS = (1.33, 1.21, 1.10)
# Same move for chunks that ship WITHOUT a residual layer (base meets the
# bound, or pure-base is forced): their granularity gap is the base cut's
# full octave (2x), so a short bisection on the coarsening g in [1, 2)
# replaces the ladder (5 iterations resolve g to ~3%).  The adopted g
# folds into the STORED maxval (decoders compute the dequant scale as
# (maxval - minval)/65535), so the stream format is untouched.
BASE_REFINE_ITERS = 5
# Temporal delta layers ride the residual transform but need a deeper
# plane budget: the delta range can be arbitrarily large relative to the
# error target (nothing bounds it the way the base layer bounds the
# residual), so the encoder picks a per-chunk ADAPTIVE quantization scale
# (up to ~800x the [0,255] grid) and the coefficients grow accordingly.
# Streams record delta geometry against the header's base_nplanes field,
# so this MUST stay equal to BASE_NUM_PLANES (self-describing streams).
DELTA_NUM_PLANES = BASE_NUM_PLANES


@dataclasses.dataclass
class CodecConfig:
    """User-facing codec configuration (one instance per dataset)."""

    dims: Tuple[int, int, int]
    base_cr: float = 30.0
    residual_mode: int = RESIDUAL_NONE  # RESIDUAL_* constant
    error: float = 0.0
    chunk_dims: Tuple[int, int, int] = (0, 0, 0)

    # TPU-build knobs.
    base_levels: int = 5
    residual_levels: int = 3
    zstd_level: int = 9
    # Entropy backend: "zstd" (default, fast), "cab" (native
    # context-adaptive arithmetic coder; requires the built native
    # library), or "auto" (compress each layer both ways, keep the
    # smaller — max compression).
    entropy_backend: str = "zstd"
    # Temporal (closed-loop predictive) coding: when a chunk carries more
    # than one frame along dims[0], frame 0 is intra-coded and every later
    # frame is coded as an error-bounded DELTA against the previous frame's
    # reconstruction (prediction from the RECONSTRUCTION, so quantization
    # error never accumulates; the per-frame bound stays exact).  Big CR
    # win on smoothly-varying stacks (time series, pressure levels).  Only
    # meaningful with an error-bounded residual mode; no reference
    # counterpart (its chunks are always intra-coded).
    temporal: bool = False
    # Masked-data support (beyond reference, which hard-exits on NaN,
    # check_nan_inf ebcc_codec.c:598-605): accept NaN samples — each chunk
    # is encoded with NaNs replaced by a per-frame fill value (mean of the
    # valid samples) and carries an entropy-coded bitmap of the invalid
    # positions; decode restores NaN there.  The error bound applies to
    # the VALID samples.  Inf still raises (it is junk, not a mask).
    allow_nan: bool = False

    def __post_init__(self):
        self.dims = tuple(int(d) for d in self.dims)
        self.chunk_dims = tuple(int(d) for d in self.chunk_dims)
        if len(self.dims) != NDIMS or len(self.chunk_dims) != NDIMS:
            raise ValueError(f"dims/chunk_dims must have {NDIMS} entries")
        if self.residual_mode not in _RESIDUAL_NAMES:
            raise ValueError(f"invalid residual mode {self.residual_mode}")
        if self.entropy_backend not in ("zstd", "cab", "cab2", "auto"):
            raise ValueError(f"invalid entropy backend {self.entropy_backend}")
        # Padded widths must stay byte-aligned for the bitplane packers
        # (flat pos>>3 byte math); 3 dyadic levels guarantee wp % 8 == 0.
        if not 3 <= self.base_levels <= 8 or not 3 <= self.residual_levels <= 8:
            raise ValueError("base_levels/residual_levels must be in [3, 8]")
        if self.temporal and self.residual_mode in (RESIDUAL_NONE,
                                                    RESIDUAL_LOSSLESS):
            raise ValueError(
                "temporal coding requires an error-bounded residual mode")
        if (self.residual_mode == RESIDUAL_POINTWISE_RELATIVE_ERROR
                and not 0.0 < self.error < 1.0):
            raise ValueError(
                "pointwise-relative mode needs an error fraction in (0, 1)")

    def per_chunk(self, chunk_dims: Tuple[int, int, int]) -> "CodecConfig":
        """The config for encoding ONE chunk of this dataset: same codec
        knobs, ``dims`` = the chunk shape, no further chunking.  All chunked
        encode paths must build their per-chunk config here so a new codec
        field can never be silently dropped on one path (a real round-1 bug:
        ``entropy_backend`` fell back to zstd on the sharded/multihost/
        pipeline routes)."""
        return dataclasses.replace(
            self, dims=tuple(chunk_dims), chunk_dims=(0, 0, 0))

    @property
    def residual_mode_name(self) -> str:
        return _RESIDUAL_NAMES[self.residual_mode]

    def describe(self) -> str:
        """Parity with ``print_config`` (ebcc_codec.c:414-429)."""
        lines = [
            f"dimensions:\t{self.dims}",
            f"chunk dimensions:\t{self.chunk_dims}",
            f"base_cr:\t{self.base_cr}",
            f"residual type:\t{self.residual_mode_name}",
        ]
        if self.residual_mode == RESIDUAL_MAX_ERROR:
            lines.append(f"max error:\t{self.error}")
        elif self.residual_mode == RESIDUAL_RELATIVE_ERROR:
            lines.append(f"relative error:\t{self.error}")
        return "\n".join(lines)


@dataclasses.dataclass
class EncodeOptions:
    """Per-call options resolved from environment (reference reads these per
    ``ebcc_encode`` call, ebcc_codec.c:630-650)."""

    base_error_quantile: float = 1e-6
    disable_pure_base_fallback: bool = False
    disable_mean_adjustment: bool = False

    @classmethod
    def from_env(cls) -> "EncodeOptions":
        opts = cls()
        q = os.environ.get("EBCC_INIT_BASE_ERROR_QUANTILE")
        if q is not None:
            try:
                opts.base_error_quantile = float(q)
            except ValueError:
                pass
        if os.environ.get("EBCC_DISABLE_PURE_BASE_COMPRESSION_FALLBACK"):
            opts.disable_pure_base_fallback = True
        if os.environ.get("EBCC_DISABLE_MEAN_ADJUSTMENT"):
            opts.disable_mean_adjustment = True
        return opts

    @property
    def base_quantile_target(self) -> float:
        # quantile 0 => target 1.0 => pure base (reference ebcc_codec.c:650, 738)
        return 1.0 - self.base_error_quantile
