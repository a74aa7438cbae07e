"""Host orchestration and public entry points of the PyTorch port.

Counterpart of ``ebcc_tpu/core/codec.py`` for the error-bounded intra
path (MAX_ERROR, RELATIVE_ERROR, POINTWISE_RELATIVE_ERROR, each with
``allow_nan``): ``encode``/``decode`` (host arrays in and out) and the
device-resident ``encode_frames_device``/``decode_frames_device``/
``roundtrip_frames_device`` (torch tensors out).  Streams are the ETPU
format of ``docs/FORMAT.md``: the two packages read each other's streams.

Device rule: ``encode``, ``decode`` and ``decode_frames_device`` run on the
CUDA card unless the caller passes ``device="cpu"``, and raise when asked
for a card that is not there.  The other ``*_frames_device`` functions run on
the device of the tensor they are given, or on ``device`` (the card by
default) for a numpy array.  Nothing falls back to the CPU.

Input gate, as in the reference: numpy inputs with NaN raise, or with
``allow_nan`` have their NaNs filled and a mask section appended to the
stream; Inf always raises.  Tensors are not masked (allow_nan is a
host-input feature); the port refuses a non-finite tensor rather than ship
a garbage stream.

Modes and features the port does not cover yet raise ``NotImplementedError``
naming the ROADMAP item that adds them.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as cfg
from ..config import CodecConfig, EncodeOptions
from ..device import resolve_device
from ..utils.logging import TRACE, logger, set_level_from_env, trace
from ..utils.timing import stage
from . import entropy, kernels, stream

# Residual payloads at or below this many compressed bytes are dropped
# (reference drop rule, ebcc_tpu/core/codec.py:43).
RESIDUAL_DROP_BYTES = 16


def _padded_hw(h: int, w: int, levels_max: int) -> Tuple[int, int]:
    mult = 1 << levels_max
    return (-(-h // mult)) * mult, (-(-w // mult)) * mult


def _layout(dims: Sequence[int]) -> Tuple[int, int, int]:
    """Map logical (d0, d1, d2) onto (n_frames, height, width): d0 is the
    frame axis when d1 is a valid frame height, else leading dims merge."""
    d0, d1, d2 = dims
    if not (cfg.MIN_INTERNAL_IMAGE_DIM <= d2 <= cfg.MAX_INTERNAL_IMAGE_DIM):
        raise ValueError(
            f"width {d2} outside [{cfg.MIN_INTERNAL_IMAGE_DIM}, "
            f"{cfg.MAX_INTERNAL_IMAGE_DIM}]")
    if cfg.MIN_INTERNAL_IMAGE_DIM <= d1 <= cfg.MAX_INTERNAL_IMAGE_DIM:
        return d0, d1, d2
    flat = d0 * d1
    if not (cfg.MIN_INTERNAL_IMAGE_DIM <= flat <= cfg.MAX_INTERNAL_IMAGE_DIM):
        raise ValueError(
            f"invalid dims {tuple(dims)}: product(dims[0:2]) and dims[2] must "
            f"be within [{cfg.MIN_INTERNAL_IMAGE_DIM}, "
            f"{cfg.MAX_INTERNAL_IMAGE_DIM}]")
    return 1, flat, d2


def _max_safe_batch(chunk_numel: int) -> int:
    """Largest batch whose sparse index space (2 layers x B x chunk
    coefficients) stays within int32."""
    return max(1, (2 ** 31 - 1) // (2 * max(1, chunk_numel)))


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not yet ported to ebcc_tpu_torch (ROADMAP Queue 1: "
        f"{item})")


def _check_supported(config: CodecConfig, opts: EncodeOptions,
                     n_frames: int) -> int:
    """Raise for what the port does not cover yet; returns the backend id."""
    mode = config.residual_mode
    if mode == cfg.RESIDUAL_NONE:
        raise _not_ported("rate mode (RESIDUAL_NONE)", "rate mode")
    if mode == cfg.RESIDUAL_LOSSLESS:
        raise _not_ported("lossless mode", "lossless mode")
    if config.temporal and n_frames > 1:
        raise _not_ported("temporal mode", "temporal mode")
    if opts.u16_upload:
        raise _not_ported("the u16 upload", "link-saving exchange code")
    return entropy.backend_id(config)


def _check_routing(kind: str):
    """The reference routes host-destined calls to its native C++ codec on
    ``EBCC_ENCODE_BACKEND`` / ``EBCC_DECODE_BACKEND`` = native (or host);
    the port has no copy of that codec yet."""
    v = os.environ.get(f"EBCC_{kind.upper()}_BACKEND", "").lower()
    if v in ("native", "host"):
        raise _not_ported(f"native {kind} routing",
                          "CAB coder and native packer/unpacker")


def _check_frames_input(x):
    if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim != 4:
        raise TypeError("expected a (B, n_frames, h, w) torch tensor or "
                        "numpy array")


def _mask_fill_check(x_batch, allow_nan: bool):
    """Input gate shared by every entry point -> (finite batch, masks)
    (reference ``_mask_fill_check``, codec.py:1036-1069).

    Without ``allow_nan`` NaN or Inf raises.  With it, a numpy batch's NaN
    samples are replaced by their frame's valid-sample mean (the chunk's
    valid mean for an all-NaN frame, then 1.0), and the (B, d0, h, w)
    invalid bitmap is returned for the streams' mask sections; Inf always
    raises.  A tensor is never masked.  ``masks`` is None when nothing was
    masked."""
    if isinstance(x_batch, torch.Tensor):
        if not bool(torch.isfinite(x_batch).all()):
            raise ValueError("NaN or Inf found in data (allow_nan masks "
                             "numpy inputs only)")
        return x_batch, None
    if not allow_nan:
        if not np.isfinite(x_batch).all():
            raise ValueError("NaN or Inf found in data")
        return x_batch, None
    m = np.isnan(x_batch)
    if not m.any():
        if not np.isfinite(x_batch).all():
            raise ValueError("Inf found in data")
        return x_batch, None
    if np.isinf(x_batch).any():
        raise ValueError("Inf found in data")
    cnt = (~m).sum(axis=(2, 3))
    s = np.where(m, 0.0, x_batch).sum(axis=(2, 3), dtype=np.float64)
    fill = np.divide(s, np.maximum(cnt, 1))
    ccnt = cnt.sum(axis=1)
    cfill = np.where(ccnt > 0, s.sum(axis=1) / np.maximum(ccnt, 1), 1.0)
    fill = np.where(cnt > 0, fill, cfill[:, None]).astype(np.float32)
    return np.where(m, fill[:, :, None, None], x_batch), m


def _append_mask_sections(streams: List[bytes], masks,
                          zstd_level: int) -> List[bytes]:
    """Append a mask section (and set FLAG_MASKED) to each stream whose
    chunk carries invalid samples (reference codec.py:1072-1093)."""
    if masks is None:
        return streams
    out = []
    for s, mi in zip(streams, masks):
        if not mi.any():
            out.append(s)
            continue
        packed = np.packbits(mi.reshape(-1)).tobytes()
        ent_id = entropy.default_backend()
        z = entropy.compress(packed, ent_id, zstd_level)
        if len(z) >= len(packed):
            z, ent_id = packed, entropy.BACKEND_STORE
        out.append(stream.append_mask_section(s, ent_id, z))
    return out


def _apply_nan_masks_host(out: np.ndarray, nan_masks) -> np.ndarray:
    """Restore NaN at masked positions (host arrays, in place)."""
    if nan_masks is None:
        return out
    n, d0, h, w = out.shape
    for i, p in enumerate(nan_masks):
        if p is None:
            continue
        m = np.unpackbits(np.frombuffer(p, np.uint8),
                          count=d0 * h * w).astype(bool)
        out[i][m.reshape(d0, h, w)] = np.nan
    return out


def _apply_nan_masks_device(out, nan_masks):
    """Restore NaN at masked positions of a batch on its device: upload the
    packed bitmaps (zero for unmasked chunks), unpack the bits there and
    apply one ``torch.where``."""
    if nan_masks is None:
        return out
    n, d0, h, w = out.shape
    sz = d0 * h * w
    need = (sz + 7) // 8
    packed = np.zeros((n, need), np.uint8)
    for i, p in enumerate(nan_masks):
        if p is not None:
            packed[i] = np.frombuffer(p, np.uint8, count=need)
    pk = torch.from_numpy(packed).to(out.device)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=out.device)
    bits = (pk[:, :, None] >> shifts) & 1
    m = bits.reshape(n, -1)[:, :sz].reshape(out.shape).to(torch.bool)
    return torch.where(m, float("nan"), out)


# Float32 safety margin of the log-domain bound (reference codec.py:1275-
# 1283): ~1 ulp of |log x| (<= 89 for a finite positive float32) on encode
# and ~1 ulp of exp on decode, doubled.  A fixed constant, so every encode
# route derives the same internal target.
_LOG_MARGIN = 1.3e-7 * (89.0 + 2.0)


def _log_transform_check(x_batch, config: CodecConfig):
    """Pointwise-relative preprocessing -> (log-domain batch, internal
    MAX_ERROR config); a no-op for every other mode (reference
    codec.py:1286-1317).  Bounding the log reconstruction by
    ``log1p(error) - _LOG_MARGIN`` bounds ``|x̂/x - 1|`` by ``error``.
    Needs strictly positive data: numpy batches are checked and logged on
    the host as the reference does, tensors on their device."""
    if config.residual_mode != cfg.RESIDUAL_POINTWISE_RELATIVE_ERROR:
        return x_batch, config
    if not bool((x_batch > 0).all()):
        raise ValueError(
            "pointwise-relative mode requires strictly positive data")
    y = (np.log(x_batch, dtype=np.float32) if isinstance(x_batch, np.ndarray)
         else torch.log(x_batch))
    target = float(np.log1p(config.error)) - _LOG_MARGIN
    if target <= 0:
        raise ValueError(
            f"error {config.error} too small to guarantee in float32 at "
            "this magnitude range")
    internal = dataclasses.replace(
        config, residual_mode=cfg.RESIDUAL_MAX_ERROR, error=target)
    return y, internal


def _set_log_flags(streams: List[bytes], config: CodecConfig) -> List[bytes]:
    """Mark the streams of a log-domain encode (decoders apply exp)."""
    if config.residual_mode != cfg.RESIDUAL_POINTWISE_RELATIVE_ERROR:
        return streams
    return [stream.set_flag(s, stream.FLAG_LOG_DOMAIN) for s in streams]


def _prepare_input(x, config: CodecConfig, opts: EncodeOptions, device):
    """Every encode entry point's gate: the modes the port covers, the
    NaN/Inf gate and mask fill, the log transform, and the upload of a
    numpy batch to ``device``.  -> (float32 tensor, internal config,
    masks, backend id)."""
    _check_frames_input(x)
    backend = _check_supported(config, opts, x.shape[1])
    x, masks = _mask_fill_check(x, config.allow_nan)
    x, internal = _log_transform_check(x, config)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
            resolve_device(device))
    return x.to(torch.float32), internal, masks, backend


def _finish_streams(streams: List[bytes], config: CodecConfig,
                    masks) -> List[bytes]:
    """Log-domain flag and mask sections, added to assembled streams."""
    streams = _set_log_flags(streams, config)
    return _append_mask_sections(streams, masks, config.zstd_level)


# ---------------------------------------------------------------------------
# Host-side stream assembly
# ---------------------------------------------------------------------------

def build_layer_payload_sparse(pos, vals, shape, stored_cut: int, cut: int,
                               num_planes: int):
    """One layer's raw payload for one chunk from its sparse exchange pair
    (reference numpy path, ebcc_tpu/core/codec.py:121-164; same bytes as
    the native packer): the bitplane stack of the magnitudes at ``cut``,
    MSB first, then the sign plane of coefficients significant at the cut.

    pos: int32 flat positions within the chunk's (D0, Hp, Wp) space;
    vals: signed kept-values at ``stored_cut``.
    Returns (payload_bytes, top, kept).
    """
    d0v, hpv, wpv = shape
    if wpv % 8 != 0:
        raise ValueError(f"padded width {wpv} not a multiple of 8")
    shift = cut - stored_cut
    if vals.size == 0:
        return b"", min(num_planes - cut, 255), 0
    v32 = np.ascontiguousarray(vals, dtype=np.int32)
    mags = np.abs(v32) >> shift
    mx = int(mags.max())
    if mx == 0:
        return b"", min(num_planes - cut, 255), 0
    msb = mx.bit_length()
    top = num_planes - cut - msb
    plane_bytes = d0v * hpv * (wpv // 8)
    payload = np.zeros((msb + 1) * plane_bytes, np.uint8)
    byte = (pos >> 3).astype(np.int64)
    mask = (1 << (7 - (pos & 7))).astype(np.uint8)
    for s in range(msb):
        sel = ((mags >> s) & 1).astype(bool)
        row = msb - 1 - s
        np.bitwise_or.at(payload, row * plane_bytes + byte[sel], mask[sel])
    sel = (v32 < 0) & (mags > 0)
    np.bitwise_or.at(payload, msb * plane_bytes + byte[sel], mask[sel])
    return payload.tobytes(), top, msb


def _entropy_encode(payload: bytes, backend: int, level: int):
    """-> (compressed, backend_id_used)."""
    if not payload:
        return b"", backend
    return entropy.compress(payload, backend, level), backend


class _SparseBatch:
    """Host view of a batch's sparse coefficient exchange: sorted flat
    indices into the (layer, chunk, D0, Hp, Wp) space + signed values."""

    def __init__(self, idx: np.ndarray, vals: np.ndarray, b: int, d0: int,
                 hp: int, wp: int):
        self.idx = idx
        self.vals = vals
        self.b = b
        self.sc = d0 * hp * wp
        self.shape = (d0, hp, wp)
        bounds = np.arange(2 * b + 1, dtype=np.int64) * self.sc
        self.splits = np.searchsorted(idx, bounds)

    def pair(self, layer: int, i: int):
        """(chunk-local int32 positions, signed values) of one chunk/layer."""
        j = layer * self.b + i
        lo, hi = self.splits[j], self.splits[j + 1]
        return ((self.idx[lo:hi] - j * self.sc).astype(np.int32),
                self.vals[lo:hi])


class _ChunkResult:
    """Host view of one chunk's device outputs (numpy scalars/arrays)."""

    def __init__(self, out, i):
        self._i = i
        for k, v in out.items():
            if k == "sparse" or np.ndim(v) == 0:
                setattr(self, k, v)
            elif k.endswith("_sizes") or k.endswith("_quantiles"):
                setattr(self, k, v[:, i])
            else:
                setattr(self, k, v[i])

    def base_pair(self):
        return self.sparse.pair(0, self._i)

    def res_pair(self):
        return self.sparse.pair(1, self._i)


def _assemble_error_mode_stream(res: _ChunkResult, config: CodecConfig,
                                opts: EncodeOptions, n_frames, h, w,
                                backend: int) -> bytes:
    """Per-chunk candidate selection + serialization (reference
    ebcc_tpu/core/codec.py:234-399): skip-residual, pure-base-required,
    pure-base-vs-base+residual size comparison, residual drop rule, mean
    adjustment folded into the stored min/max."""
    level = config.zstd_level
    minval = float(res.minval)
    maxval = float(res.maxval)

    if bool(res.const):
        header = stream.FrameHeader(
            flags=stream.FLAG_CONST, entropy=entropy.BACKEND_ZSTD,
            n_frames=n_frames, height=h, width=w,
            minval=minval, maxval=maxval, rmin=0.0, rmax=0.0,
            base_levels=config.base_levels, res_levels=config.residual_levels,
            base_nplanes=cfg.BASE_NUM_PLANES, base_cut=0, base_top=0,
            res_nplanes=cfg.RES_NUM_PLANES, res_cut=0, res_top=0,
            base_comp_size=0, res_comp_size=0)
        return stream.pack_frame_stream(header, b"", b"")

    if bool(res.overflow):
        raise RuntimeError(
            "internal coefficient overflow: bitplane count too small for "
            "this data (please report)")

    base_cut = int(res.base_cut)
    pure_cut = int(res.pure_cut)
    res_cut = int(res.res_cut)
    skip_residual = bool(res.skip_residual)
    res_feasible = bool(res.res_feasible)
    pure_feasible = bool(res.pure_feasible)
    store_cut = int(res.store_cut)
    shape = res.sparse.shape

    # Candidate A: base @ base_cut (+ residual @ res_cut unless skipped).
    base_pos, base_vals = res.base_pair()
    base_payload, base_top, _ = build_layer_payload_sparse(
        base_pos, base_vals, shape, store_cut, base_cut, cfg.BASE_NUM_PLANES)
    base_comp, base_be = _entropy_encode(base_payload, backend, level)

    use_residual = (not skip_residual) and res_feasible
    res_comp = b""
    res_top = 0
    res_be = 0
    if use_residual:
        res_payload, res_top, _ = build_layer_payload_sparse(
            *res.res_pair(), shape, res_cut, res_cut, cfg.RES_NUM_PLANES)
        res_comp, res_be = _entropy_encode(res_payload, backend, level)
        if len(res_comp) <= RESIDUAL_DROP_BYTES:
            # Drop only if the base layer alone still meets the bound in
            # some shippable form (the adjustment gate below picks it).
            base_ok = (float(res.base_maxerr_centered) <= float(res.target_abs)
                       or float(res.base_maxerr) <= float(res.target_abs))
            if base_ok:
                res_comp = b""
                use_residual = False

    # Candidate B: pure base @ pure_cut.
    choose_pure = False
    pure_comp = None
    pure_top = 0
    if (not skip_residual) and (not res_feasible):
        if not pure_feasible:
            logger.warning(
                "Could not reach error target %g in any configuration; "
                "shipping best effort (finest cut).", float(res.target_abs))
        choose_pure = True
    elif use_residual and pure_feasible and not opts.disable_pure_base_fallback:
        pure_payload, pure_top, _ = build_layer_payload_sparse(
            base_pos, base_vals, shape, store_cut, pure_cut,
            cfg.BASE_NUM_PLANES)
        pure_comp, pure_be = _entropy_encode(pure_payload, backend, level)
        if len(pure_comp) < len(base_comp) + len(res_comp):
            logger.info(
                "Pure base compression (%d) is better than base (%d) + "
                "residual (%d)", len(pure_comp), len(base_comp), len(res_comp))
            choose_pure = True

    if choose_pure:
        if pure_comp is None:
            pure_payload, pure_top, _ = build_layer_payload_sparse(
                base_pos, base_vals, shape, store_cut, pure_cut,
                cfg.BASE_NUM_PLANES)
            pure_comp, pure_be = _entropy_encode(pure_payload, backend,
                                                 level)
        base_comp, base_cut, base_top = pure_comp, pure_cut, pure_top
        base_be = pure_be
        use_residual = False
        res_comp = b""
        mean = float(res.pure_mean)
    elif use_residual:
        mean = float(res.res_mean)
    else:
        mean = float(res.base_mean)

    flags = stream.FLAG_HAS_RESIDUAL if use_residual else 0
    # The skip/dropped-residual path was verified uncentered: shift by the
    # mean only when the centered error is verified too.
    adjust_ok = True
    if not choose_pure and not use_residual:
        adjust_ok = (float(res.base_maxerr_centered)
                     <= float(res.target_abs))
    if not opts.disable_mean_adjustment and abs(mean) > 1e-18 and adjust_ok:
        minval += mean
        maxval += mean
        flags |= stream.FLAG_MEAN_ADJUSTED
        logger.info("Mean of compression error: %e; adjusting min/max", mean)

    if logger.isEnabledFor(TRACE):
        trace("chunk %d: quantile curve (coarse cuts %d..0 step -3): %s",
              res._i, cfg.BASE_NUM_PLANES - 1,
              np.array2string(1.0 - res.base_quantiles, precision=2))
        trace("chunk %d: base_cut=%d pure_cut=%d res_cut=%d skip=%s "
              "res_feasible=%s pure=%s", res._i, base_cut, pure_cut,
              res_cut, skip_residual, res_feasible, choose_pure)
    raw_bytes = n_frames * h * w * 4
    logger.info(
        "chunk %d: base_size=%d res_size=%d compression ratio: %.2f",
        res._i, len(base_comp), len(res_comp),
        raw_bytes / (stream.FRAME_HEADER_SIZE + len(base_comp)
                     + len(res_comp)))

    header = stream.FrameHeader(
        flags=flags, entropy=base_be,
        n_frames=n_frames, height=h, width=w,
        minval=minval, maxval=maxval,
        rmin=float(res.rmin) if use_residual else 0.0,
        rmax=float(res.rmax) if use_residual else 0.0,
        base_levels=config.base_levels, res_levels=config.residual_levels,
        base_nplanes=cfg.BASE_NUM_PLANES, base_cut=base_cut,
        base_top=base_top,
        res_nplanes=cfg.RES_NUM_PLANES, res_cut=res_cut if use_residual else 0,
        res_top=res_top,
        base_comp_size=len(base_comp), res_comp_size=len(res_comp),
        res_entropy=res_be if use_residual else 0)
    return stream.pack_frame_stream(header, base_comp, res_comp)


def _assemble_batch(out_np, config, opts, n_frames, h, w, backend,
                    n_chunks: int) -> List[bytes]:
    """Host-side stream assembly for a fetched batch, with the entropy
    coding spread over a thread pool (zstandard releases the GIL)."""
    fn = lambda i: _assemble_error_mode_stream(
        _ChunkResult(out_np, i), config, opts, n_frames, h, w, backend)
    with stage("assemble+zstd"):
        if n_chunks <= 1:
            return [fn(i) for i in range(n_chunks)]
        with ThreadPoolExecutor(max_workers=min(4, n_chunks)) as pool:
            return list(pool.map(fn, range(n_chunks)))


# ---------------------------------------------------------------------------
# Device encode and the exchange
# ---------------------------------------------------------------------------

def _fetch_small(small: dict) -> dict:
    """One device-to-host copy of every small encode output: bit-pack them
    into one int32 vector on the device, split and bitcast on the host."""
    keys = sorted(small)
    parts = []
    for k in keys:
        v = small[k].reshape(-1)
        parts.append(v.view(torch.int32) if v.dtype == torch.float32
                     else v.to(torch.int32))
    flat = torch.cat(parts).cpu().numpy()
    outd = {}
    off = 0
    for k in keys:
        v = small[k]
        n = v.numel()
        raw = flat[off:off + n]
        off += n
        if v.dtype == torch.bool:
            arr = raw != 0
        elif v.dtype == torch.float32:
            arr = raw.view(np.float32)
        else:
            arr = raw
        outd[k] = arr.reshape(tuple(v.shape)) if v.dim() else arr[0]
    return outd


def _fetch_encode_outputs(out: dict, b: int, d0: int, hp: int,
                          wp: int) -> dict:
    """Device encode outputs -> host: the small outputs in one copy, then
    the sparse exchange (``torch.nonzero`` over the flat kept-values of both
    layers keeps the sorted (layer, chunk) order), one copy of the int32
    indices and one of the values."""
    vals_comb = out["vals_comb"]
    with stage("enc: small fetch (+compute)"):
        small = _fetch_small({k: v for k, v in out.items()
                              if k != "vals_comb"})
    with stage("enc: sparse fetch"):
        idx = torch.nonzero(vals_comb).reshape(-1)
        vals = vals_comb[idx].cpu().numpy()
        idx = idx.to(torch.int32).cpu().numpy()
    small["sparse"] = _SparseBatch(idx, vals, b, d0, hp, wp)
    return small


def _encode_to_host(xb, config: CodecConfig, opts: EncodeOptions) -> dict:
    """Device encode of one (B, n_frames, h, w) batch, fetched to host."""
    b, n_frames, h, w = xb.shape
    hp, wp = _padded_hw(h, w, max(config.base_levels, config.residual_levels))
    if b > _max_safe_batch(n_frames * hp * wp):
        raise ValueError(
            f"batch of {b} chunks x {n_frames * hp * wp} coefficients "
            "exceeds the int32 sparse-index space; lower max_batch")
    with stage("enc: device"):
        out = kernels.encode_batch(
            xb, config.error, opts.base_quantile_target,
            base_levels=config.base_levels, res_levels=config.residual_levels,
            relative_mode=config.residual_mode == cfg.RESIDUAL_RELATIVE_ERROR,
            use_centered=not opts.disable_mean_adjustment)
    return _fetch_encode_outputs(out, b, n_frames, hp, wp)


def _encode_chunk_batch(x_batch, config: CodecConfig, opts: EncodeOptions,
                        backend: int) -> List[bytes]:
    """Encode a (B, n_frames, h, w) float32 tensor of equally-shaped chunks,
    already through :func:`_prepare_input`, -> per-chunk stream bytes."""
    b, n_frames, h, w = x_batch.shape
    out_np = _encode_to_host(x_batch, config, opts)
    return _assemble_batch(out_np, config, opts, n_frames, h, w, backend, b)


def encode(data: np.ndarray, config: CodecConfig,
           opts: Optional[EncodeOptions] = None, device="cuda") -> bytes:
    """Encode one logical array (= one chunk) -> ETPU stream bytes, on
    ``device`` (the CUDA card unless ``device="cpu"``)."""
    resolve_device(device)
    _check_routing("encode")
    set_level_from_env()
    opts = opts or EncodeOptions.from_env()
    data = np.asarray(data, dtype=np.float32).reshape(config.dims)
    n_frames, h, w = _layout(config.dims)
    logger.info("%s", config.describe())
    x, internal, masks, backend = _prepare_input(
        data.reshape(1, n_frames, h, w), config, opts, device)
    return _finish_streams(
        _encode_chunk_batch(x, internal, opts, backend), config, masks)[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _parse_streams(streams):
    """-> (headers, (base, res) payloads, mask bitmaps): each masked
    stream's packed invalid bitmap, None for the others, or None for the
    whole batch when no stream is masked."""
    headers = []
    payloads = []
    mask_payloads = []
    for s in streams:
        hd, basep, resp = stream.split_frame_stream(s)
        # Sanity caps before any allocation sized from header fields.
        if (hd.height > 4 * cfg.MAX_INTERNAL_IMAGE_DIM
                or hd.width > 4 * cfg.MAX_INTERNAL_IMAGE_DIM
                or hd.n_frames > 1 << 20
                or hd.base_levels > 10 or hd.res_levels > 10
                or hd.base_nplanes > 32 or hd.res_nplanes > 32
                or hd.base_cut > hd.base_nplanes
                or hd.res_cut > hd.res_nplanes):
            raise stream.StreamError("implausible ETPU header dimensions")
        if hd.temporal:
            raise _not_ported("decoding temporal streams", "temporal mode")
        if hd.lossless:
            raise _not_ported("decoding lossless streams", "lossless mode")
        if hd.flags & stream.FLAG_BASE_PARTIAL:
            raise _not_ported("decoding rate-mode streams", "rate mode")
        headers.append(hd)
        payloads.append((basep, resp))
        if hd.masked:
            ent_id, mp = stream.split_mask_section(s, hd)
            if ent_id not in (entropy.BACKEND_STORE, entropy.BACKEND_ZSTD):
                raise stream.StreamError("invalid mask section backend")
            need = (hd.n_frames * hd.height * hd.width + 7) // 8
            raw = entropy.decompress(mp, ent_id, need)
            if len(raw) != need:
                raise stream.StreamError("mask section size mismatch")
            mask_payloads.append(raw)
        else:
            mask_payloads.append(None)
    h0 = headers[0]
    key = (h0.n_frames, h0.height, h0.width, h0.base_levels, h0.res_levels,
           h0.base_nplanes, h0.res_nplanes)
    for hd in headers[1:]:
        k = (hd.n_frames, hd.height, hd.width, hd.base_levels, hd.res_levels,
             hd.base_nplanes, hd.res_nplanes)
        if k != key:
            raise stream.StreamError("inconsistent chunk stream shapes")
    if all(m is None for m in mask_payloads):
        mask_payloads = None
    return headers, payloads, mask_payloads


def _decode_streams_device(streams: List[bytes], device):
    """Decode ETPU streams sharing one shape into a ``(N, d0, h, w)`` tensor
    on ``device``, plus host-side (const_mask, const value per chunk, NaN
    mask bitmaps).  NaNs are not restored here.

    The host entropy-decodes the payloads and extracts the sorted (index,
    signed kept-value) pairs; both go up in one copy each, and one scatter
    plus the inverse transforms rebuild the batch on the device.
    Log-domain chunks (pointwise-relative mode) get their ``exp`` as the
    last arithmetic step, after both layers are summed, as the encoder
    verified (reference ``_finish``, codec.py:1853-1865)."""
    headers, payloads, nan_masks = _parse_streams(streams)
    h0 = headers[0]
    n = len(headers)
    d0, h, w = h0.n_frames, h0.height, h0.width
    hp, wp = _padded_hw(h, w, max(h0.base_levels, h0.res_levels))
    sc = d0 * hp * wp
    if n > _max_safe_batch(sc):
        raise stream.StreamError(
            "decode batch exceeds int32 sparse-index space; use a smaller "
            "max_batch")

    minval = np.array([hd.minval for hd in headers], np.float32)
    maxval = np.array([hd.maxval for hd in headers], np.float32)
    rmin = np.array([hd.rmin if hd.has_residual else 0.0 for hd in headers],
                    np.float32)
    rmax = np.array([hd.rmax if hd.has_residual else 0.0 for hd in headers],
                    np.float32)
    base_cut = np.array([hd.base_cut for hd in headers], np.int32)
    res_cut = np.array([hd.res_cut if hd.has_residual else 0
                        for hd in headers], np.int32)
    const_mask = np.array([hd.const_field for hd in headers], bool)
    any_residual = any(hd.has_residual for hd in headers)
    plane_bytes = d0 * hp * (wp // 8)
    # Log-domain chunks store log values: the host const fill takes their
    # exp (reference codec.py:1682-1692).
    log_flags = np.array([hd.log_domain for hd in headers], bool)
    const_val = minval.copy()
    if log_flags.any():
        with np.errstate(over="ignore"):
            const_val = np.where(log_flags, np.exp(const_val),
                                 const_val).astype(np.float32)

    def _decompress_layer(hd, payload, which):
        """One chunk layer -> (raw bytes, kept); (None, 0) when empty."""
        if which == "base":
            num_planes, cut, top = hd.base_nplanes, hd.base_cut, hd.base_top
            backend = hd.entropy
        else:
            num_planes, cut, top = hd.res_nplanes, hd.res_cut, hd.res_top
            backend = hd.res_entropy_effective
        kept = num_planes - cut - top
        if kept <= 0 or not payload:
            return None, 0
        max_size = (kept + 1) * plane_bytes
        raw = entropy.decompress(payload, backend, max_size)
        if len(raw) != max_size:
            raise stream.StreamError(
                f"decompressed payload size {len(raw)} != expected "
                f"{max_size}")
        return raw, kept

    def _decompress_one(i):
        hd = headers[i]
        if hd.const_field:
            return (None, 0), (None, 0)
        basep, resp = payloads[i]
        base = _decompress_layer(hd, basep, "base")
        res = (_decompress_layer(hd, resp, "res") if hd.has_residual
               else (None, 0))
        return base, res

    with stage("dec: entropy decode"):
        if n <= 1:
            raws = [_decompress_one(i) for i in range(n)]
        else:
            with ThreadPoolExecutor(max_workers=min(4, n)) as pool:
                raws = list(pool.map(_decompress_one, range(n)))

    def _layer_values(which: int):
        """Planes -> signed kept-values of one layer across the batch:
        bottom-aligned plane stack, one unpackbits + shift-accumulate per
        plane row, one masked sign apply.  (n, sc) int32, or None."""
        kmax = max((r[which][1] for r in raws), default=0)
        if kmax == 0:
            return None
        planes = np.zeros((n, kmax, plane_bytes), np.uint8)
        signs = np.zeros((n, plane_bytes), np.uint8)
        for i, r in enumerate(raws):
            raw, kept = r[which]
            if raw is None:
                continue
            pl = np.frombuffer(raw, np.uint8)
            planes[i, kmax - kept:] = pl[:kept * plane_bytes].reshape(
                kept, plane_bytes)
            signs[i] = pl[kept * plane_bytes:]
        mag = np.zeros((n, plane_bytes * 8), np.int32)
        for k in range(kmax):
            mag = (mag << 1) | np.unpackbits(planes[:, k], axis=-1)
        sb = np.unpackbits(signs, axis=-1).astype(bool)
        return np.where(sb, -mag, mag)

    with stage("dec: unpack planes"):
        parts_idx, parts_val = [], []
        for layer in (0, 1):
            v = _layer_values(layer)
            if v is None:
                continue
            flat = v.reshape(-1)
            pos = np.flatnonzero(flat)
            parts_idx.append(pos.astype(np.int64) + layer * n * sc)
            parts_val.append(flat[pos])
        idx = (np.concatenate(parts_idx) if parts_idx
               else np.zeros(0, np.int64))
        vals = (np.concatenate(parts_val) if idx.size
                else np.zeros(0, np.int32))

    with stage("dec: upload sparse + decode"):
        as16 = bool(np.abs(vals).max() < (1 << 15)) if vals.size else True
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            device)
        idx_dev = to_dev(idx.astype(np.int32)).to(torch.int64)
        vals_dev = to_dev(vals.astype(np.int16 if as16 else np.int32))
        out = kernels.decode_batch_sparse(
            idx_dev, vals_dev, to_dev(base_cut), to_dev(res_cut),
            to_dev(minval), to_dev(maxval), to_dev(rmin), to_dev(rmax),
            base_levels=h0.base_levels, res_levels=h0.res_levels,
            out_hw=(h, w), has_residual=any_residual,
            grid_shape=(n, d0, hp, wp))
        if log_flags.any():
            fl = to_dev(log_flags[:, None, None, None])
            out = torch.where(fl, torch.exp(out), out)
    return out, const_mask, const_val, nan_masks


def _decode_streams(streams: List[bytes], device) -> np.ndarray:
    """Host-resident decode: :func:`_decode_streams_device` + fetch."""
    out, const_mask, const_val, nan_masks = _decode_streams_device(
        streams, device)
    out = out.cpu().numpy()
    if const_mask.any():
        out[const_mask] = const_val[const_mask, None, None, None]
    return _apply_nan_masks_host(out, nan_masks)


def _decode_device_batch(streams: List[bytes], device):
    """Device-resident decode of one batch, NaNs restored on the device."""
    out, _, _, nan_masks = _decode_streams_device(streams, device)
    return _apply_nan_masks_device(out, nan_masks)


def decode(buf: bytes, device="cuda") -> np.ndarray:
    """Decode one ETPU stream -> (n_frames, h, w) float32, on ``device``
    (the CUDA card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    _check_routing("decode")
    if buf[:4] == stream.MAGIC_CHUNKED:
        raise _not_ported("ETPK chunked containers",
                          "ETPK containers and region decode")
    if buf[:4] in (b"EBCC", b"EBCK"):
        raise _not_ported("reference-format (EBCC/EBCK) streams",
                          "surfaces")
    return _decode_streams([buf], dev)[0]


# ---------------------------------------------------------------------------
# Device-resident entry points
# ---------------------------------------------------------------------------

def encode_frames_device(x, config: CodecConfig,
                         opts: Optional[EncodeOptions] = None,
                         max_batch: Optional[int] = None,
                         device="cuda") -> List[bytes]:
    """Device-resident encode of a ``(B, n_frames, h, w)`` float32 tensor
    on its own device (or of a numpy array, uploaded to ``device``, the
    card unless ``device="cpu"``) -> one ETPU stream per batch entry.
    ``allow_nan`` masking applies to numpy inputs.

    ``max_batch`` splits the batch into sub-batches pipelined as in the
    reference: worker threads keep the device encode and fetch of later
    sub-batches in flight while earlier ones are entropy-coded."""
    opts = opts or EncodeOptions.from_env()
    x, internal, masks, backend = _prepare_input(x, config, opts, device)
    b, n_frames, h, w = x.shape
    if max_batch is None or b <= max_batch:
        return _finish_streams(
            _encode_chunk_batch(x, internal, opts, backend), config, masks)
    slices = [x[s:s + max_batch] for s in range(0, b, max_batch)]
    run = lambda sl: _encode_to_host(sl, internal, opts)
    depth = min(int(os.environ.get("EBCC_PIPELINE_DEPTH", "6")),
                max(1, len(slices) - 1))
    with ThreadPoolExecutor(max_workers=depth) as fetcher, \
            ThreadPoolExecutor(max_workers=2) as assembler:
        futs = [fetcher.submit(run, s) for s in slices[:depth]]
        asm = []
        for i, sl in enumerate(slices):
            out_np = futs[i].result()
            if i + depth < len(slices):
                futs.append(fetcher.submit(run, slices[i + depth]))
            asm.append(assembler.submit(
                _assemble_batch, out_np, internal, opts, n_frames, h, w,
                backend, sl.shape[0]))
        per_slice = [f.result() for f in asm]
    return _finish_streams([s for ss in per_slice for s in ss], config,
                           masks)


def decode_frames_device(streams: List[bytes],
                         max_batch: Optional[int] = None, device="cuda"):
    """Device-resident decode -> ``(B, n_frames, h, w)`` tensor on
    ``device`` (the CUDA card unless ``device="cpu"``), NaNs of masked
    streams restored there.  ``max_batch`` overlaps host parsing of
    sub-batch k+1 with the device work of k."""
    dev = resolve_device(device)
    if max_batch is None or len(streams) <= max_batch:
        return _decode_device_batch(streams, dev)
    batches = [streams[s:s + max_batch]
               for s in range(0, len(streams), max_batch)]
    depth = min(2, len(batches))
    outs = []
    with ThreadPoolExecutor(max_workers=depth) as worker:
        futs = [worker.submit(_decode_device_batch, bt, dev)
                for bt in batches[:depth]]
        for i in range(len(batches)):
            outs.append(futs[i].result())
            if i + depth < len(batches):
                futs.append(worker.submit(_decode_device_batch,
                                          batches[i + depth], dev))
    return torch.cat(outs, dim=0)


def roundtrip_frames_device(x, config: CodecConfig,
                            opts: Optional[EncodeOptions] = None,
                            max_batch: Optional[int] = None, device="cuda"):
    """Device-resident encode then decode of the same frames, pipelined as
    in the reference: sub-batch k's host assembly and decode run on worker
    threads while later sub-batches encode.  Streams are byte-identical to
    :func:`encode_frames_device`'s; the decoded batch stays on ``x``'s
    device (on ``device`` for a numpy ``x``).  Returns ``(streams,
    decoded)``."""
    opts = opts or EncodeOptions.from_env()
    x, internal, masks, backend = _prepare_input(x, config, opts, device)
    b, n_frames, h, w = x.shape
    if max_batch is None or b <= max_batch:
        streams = _finish_streams(
            _encode_chunk_batch(x, internal, opts, backend), config, masks)
        return streams, _decode_device_batch(streams, x.device)

    starts = list(range(0, b, max_batch))
    slices = [x[s:s + max_batch] for s in starts]
    run = lambda sl: _encode_to_host(sl, internal, opts)

    def post_batch(i, out_np, count):
        """Assemble slice i's streams, then start its device decode."""
        streams = _assemble_batch(out_np, internal, opts, n_frames, h, w,
                                  backend, count)
        s0 = starts[i]
        streams = _finish_streams(
            streams, config,
            None if masks is None else masks[s0:s0 + count])
        return streams, _decode_device_batch(streams, x.device)

    depth = min(int(os.environ.get("EBCC_PIPELINE_DEPTH", "6")),
                max(1, len(slices) - 1))
    posters = int(os.environ.get("EBCC_PIPELINE_POSTERS", "2"))
    with ThreadPoolExecutor(max_workers=depth) as fetcher, \
            ThreadPoolExecutor(max_workers=max(1, posters)) as poster:
        futs = [fetcher.submit(run, s) for s in slices[:depth]]
        post_futs = []
        for i, sl in enumerate(slices):
            out_np = futs[i].result()
            if i + depth < len(slices):
                futs.append(fetcher.submit(run, slices[i + depth]))
            post_futs.append(poster.submit(post_batch, i, out_np,
                                           sl.shape[0]))
        results = [f.result() for f in post_futs]
    streams_out = [s for streams, _ in results for s in streams]
    return streams_out, torch.cat([d for _, d in results], dim=0)
