"""Host orchestration and public entry points of the PyTorch port.

Counterpart of ``ebcc_tpu/core/codec.py`` for every residual mode: rate
mode (RESIDUAL_NONE, the config's default), the error-bounded modes
(MAX_ERROR, RELATIVE_ERROR, POINTWISE_RELATIVE_ERROR, each with
``allow_nan``, intra or ``temporal``) and the bit-exact lossless mode.
Entry points: ``encode``/``decode`` (host arrays in and out), the
device-resident ``encode_frames_device``/``decode_frames_device``/
``roundtrip_frames_device`` (torch tensors out), and the ETPK container
paths ``encode_chunked``/``encode_chunked_compat``/``decode_chunked``/
``decode_chunked_region`` (host arrays; the chunk grid on the host, one
device batch of chunks at a time).  Streams and containers are the ETPU and
ETPK formats of ``docs/FORMAT.md``: the two packages read each other's.

Lossless mode has no device work, as in the reference: its coder runs on
the host (a tensor comes to the host once) and the device-resident
decode uploads the decoded batch.

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

Entropy coding and plane packing run on the host, in the port's own C++
(``csrc/host/``, :mod:`ebcc_tpu_torch.native`): the CAB coders
(``entropy_backend`` "cab", "cab2", "auto") beside zstd, the sparse packer
of every encode (``EBCC_NO_NATIVE_PACK=1`` selects its numpy twin) and the
plane unpacker of every decode (``EBCC_NO_NATIVE_UNPACK=1``, likewise).

The host<->device exchange (:mod:`.transfer`) has one form on each side
of ``transfer.COMPACT_CAP_LIMIT``, in both directions.  Up to the cap,
encode outputs come back as Rice-coded (position gap, value) pairs
compacted on the device, and a decode uploads blocked-Rice lanes that the
X1 kernel decodes on the card.  Above it, or without the port's host
library, an encode fetches int32 positions and values through
``torch.nonzero`` and a decode uploads them for one scatter (the index
form; a decode without the library packs its Rice lanes in numpy).  Every
leg counts its bytes in ``transfer.LINK_STATS``.

Native routing: ``EBCC_ENCODE_BACKEND`` / ``EBCC_DECODE_BACKEND`` =
``native`` (or ``host``) sends ``encode``, ``encode_chunked`` (and so
``encode_chunked_compat``), ``decode``, ``decode_chunked`` and
``decode_chunked_region`` to the port's copy of the host C++ codec, which
links ``libzstd.so.1`` and raises ``RuntimeError`` when it cannot be
built.
Unset or ``auto`` chooses from a link probe (:mod:`.routing`), and stays on
the device path where the host codec cannot be built.

Reference-format streams (EBCC/EBCK) are decoded on the host by
:mod:`ebcc_tpu_torch.compat`, as the JAX package's ``decode`` does.
"""

from __future__ import annotations

import collections
import collections.abc
import dataclasses
import itertools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as cfg
from .. import native
from ..config import CodecConfig, EncodeOptions
from ..device import resolve_device
from ..utils.logging import TRACE, logger, set_level_from_env, trace
from ..utils import timing
from ..utils.timing import stage
from . import entropy, kernels, routing, stream, transfer

# Residual payloads at or below this many compressed bytes are dropped
# (reference drop rule, ebcc_tpu/core/codec.py:43).
RESIDUAL_DROP_BYTES = 16
# Chunks per device batch of the container paths (reference codec.py:48).
DEFAULT_MAX_BATCH = 32

# The pipelines' submit-ahead depths and second-stage worker counts: encode
# fetch workers (at most one per slice after the first) with the
# assemblers that entropy-code the fetched slices, the device decode's
# batches in flight, the roundtrip's fetch workers with the posters that
# assemble and decode each slice, and the chunk decode's batches in flight.
_ENCODE_DEPTH = 6
_ASSEMBLERS = 2
_DEVICE_DECODE_DEPTH = 2
_POSTERS = 2
_CHUNK_DECODE_DEPTH = 1


# ---------------------------------------------------------------------------
# Host thread pools.  Every pool lives for one call: a shared pool could
# deadlock, since an assembler worker maps its chunks onto a pool of its own.
# ---------------------------------------------------------------------------

def _host_pool_map(fn, items, workers: Optional[int] = None) -> list:
    """``fn`` over ``items`` on a pool of at most ``workers`` threads (one
    per core by default) and one per item; on the caller's thread where
    that is one.  The host codec, zstd and the native packers release the
    GIL."""
    items = list(items)
    workers = min(workers or os.cpu_count() or 1, len(items))
    if workers <= 1:
        return [fn(it) for it in items]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))


def _enc_wait():
    return stage("enc: wait worker")


def _dec_wait():
    return stage("dec: wait worker")


def _submit_ahead(fn, items, depth: Optional[int], wait, workers=None):
    """Yield ``fn(item)`` for each of ``items`` in order, each call run on a
    per-call pool of ``workers`` threads (``depth`` by default) through
    ``timing.submit``, so that the workers' spans keep the caller's span as
    parent; ``wait()`` opens the caller's wait span (``_enc_wait`` or
    ``_dec_wait``).

    With a ``depth``, at most that many calls are in flight: after each
    result is waited for, in a wait span of its own, the next item is
    submitted.  With ``depth=None`` every item is submitted as it comes
    (``items`` may be a generator, such as another stage of this helper,
    whose results then go on as they arrive), and the results are waited
    for together in one wait span.  A sequence of one item runs on the
    caller's thread and opens no wait span.  An exception in a call reaches
    the caller when its result is waited for."""
    if isinstance(items, collections.abc.Sequence) and len(items) == 1:
        yield fn(items[0])
        return
    it = iter(items)
    with ThreadPoolExecutor(max_workers=workers or depth) as pool:
        if depth is None:
            futs = [timing.submit(pool, fn, item) for item in it]
            with wait():
                results = [f.result() for f in futs]
            yield from results
            return
        futs = collections.deque(timing.submit(pool, fn, item)
                                 for item in itertools.islice(it, depth))
        while futs:
            with wait():
                out = futs.popleft().result()
            futs.extend(timing.submit(pool, fn, item)
                        for item in itertools.islice(it, 1))
            yield out


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


def _temporal_active(config: CodecConfig, n_frames: int) -> bool:
    """Temporal coding applies when asked for and the chunk has more than
    one frame (reference codec.py:1328-1334); a one-frame chunk is coded
    intra."""
    return (config.temporal and n_frames > 1
            and config.residual_mode != cfg.RESIDUAL_NONE)


def _native_routed(kind: str, device, opts=None) -> bool:
    """Whether a host-destined ``kind`` ("encode" / "decode") call on
    ``device`` goes to the port's host codec (reference
    ``_native_encoder`` / ``_native_decoder``, codec.py:1498-1531,
    :2212-2240): ``EBCC_ENCODE_BACKEND`` / ``EBCC_DECODE_BACKEND`` =
    ``native`` or ``host`` routes it, ``device`` (``jax``, ``tpu``,
    ``accel``) keeps it on the device, and unset or ``auto`` takes
    ``routing.backend_choice``.  An automatic encode with options other
    than the environment's stays on the device (the host codec reads its
    options from the environment).  An explicit route whose library
    cannot be built raises ``RuntimeError`` here, before any work."""
    if routing.explicit(kind) is None:
        if (opts is not None and kind == "encode"
                and opts != EncodeOptions.from_env()):
            return False
    if routing.backend_choice(kind, device) != "native":
        return False
    native.load_codec()
    return True


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
    pk = _put(packed, out.device)
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
    NaN/Inf gate and mask fill, and the log transform.  A numpy batch stays
    on the host (:func:`_pipeline_encode_slices` uploads it one slice at a
    time); a tensor is cast to float32 on its own device.  -> (float32
    batch, internal config, masks, backend id, device)."""
    _check_frames_input(x)
    backend = entropy.backend_id(config)
    x, masks = _mask_fill_check(x, config.allow_nan)
    x, internal = _log_transform_check(x, config)
    if isinstance(x, np.ndarray):
        return (np.ascontiguousarray(x, dtype=np.float32), internal, masks,
                backend, resolve_device(device))
    return x.to(torch.float32), internal, masks, backend, x.device


def _on_device(xb, device):
    """A numpy batch slice uploaded to ``device`` (its bytes counted); a
    tensor as it is."""
    if isinstance(xb, np.ndarray):
        return transfer.upload(xb, device)
    return xb


def _finish_streams(streams: List[bytes], config: CodecConfig,
                    masks) -> List[bytes]:
    """Log-domain flag and mask sections, added to assembled streams."""
    streams = _set_log_flags(streams, config)
    return _append_mask_sections(streams, masks, config.zstd_level)


# ---------------------------------------------------------------------------
# Lossless mode (host coder, reference codec.py:1142-1272)
# ---------------------------------------------------------------------------

def _f32_to_ordered_u32(x: np.ndarray) -> np.ndarray:
    """Order-preserving bijection float32 bits -> uint32 (negative floats
    map below positives; every bit pattern, NaN and Inf included,
    round-trips)."""
    b = x.reshape(-1).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _ordered_u32_to_f32(u: np.ndarray) -> np.ndarray:
    b = np.where(u & 0x80000000, u & 0x7FFFFFFF, ~u).astype(np.uint32)
    return b.view(np.float32)


def _lorenzo_fwd(u: np.ndarray) -> np.ndarray:
    """Per-frame 2-D Lorenzo predictor residuals of (d0, h, w) uint32: a
    wrapping difference along the rows, then along the columns."""
    v = u.copy()
    v[:, 1:] = u[:, 1:] - u[:, :-1]
    d = v.copy()
    d[:, :, 1:] = v[:, :, 1:] - v[:, :, :-1]
    return d


def _wrapping_cumsum(a: np.ndarray, axis: int) -> np.ndarray:
    return (np.cumsum(a.astype(np.uint64), axis=axis)
            & 0xFFFFFFFF).astype(np.uint32)


def _lorenzo_inv(d: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_lorenzo_fwd`: wrapping cumulative sums along the
    columns, then the rows."""
    return _wrapping_cumsum(_wrapping_cumsum(d, -1), -2)


def _lossless_encode_frames(x_batch: np.ndarray,
                            config: CodecConfig) -> List[bytes]:
    """Bit-exact coder: per chunk, the float bits mapped to order-preserving
    uint32, a per-frame 2-D Lorenzo prediction (predictor id 2) or, for
    multi-frame chunks, a frame-axis wrapping difference first (id 3),
    whichever compresses smaller; the id goes in the header's base_levels
    field.  NaN and Inf pass through bit-exactly."""
    x_batch = np.ascontiguousarray(x_batch, dtype=np.float32)
    b, d0, h, w = x_batch.shape

    def one(i):
        u = _f32_to_ordered_u32(x_batch[i]).reshape(d0, h, w)
        ent_id = entropy.default_backend()
        cands = [(_lorenzo_fwd(u).tobytes(), 2)]
        if d0 > 1:
            w_ = u.copy()
            w_[1:] = u[1:] - u[:-1]          # uint32 wraparound
            cands.append((_lorenzo_fwd(w_).tobytes(), 3))
        best = None
        for raw, tdiff in cands:
            payload, eid = entropy.compress(raw, ent_id,
                                            config.zstd_level), ent_id
            if len(payload) >= len(raw):
                payload, eid = raw, entropy.BACKEND_STORE
            if best is None or len(payload) < len(best[0]):
                best = (payload, eid, tdiff)
        payload, eid, tdiff = best
        header = stream.FrameHeader(
            flags=stream.FLAG_LOSSLESS, entropy=eid,
            n_frames=d0, height=h, width=w,
            minval=0.0, maxval=0.0, rmin=0.0, rmax=0.0,
            base_levels=tdiff, res_levels=0, base_nplanes=0, base_cut=0,
            base_top=0, res_nplanes=0, res_cut=0, res_top=0,
            base_comp_size=len(payload), res_comp_size=0)
        return stream.pack_frame_stream(header, payload, b"")

    with stage("lossless encode (host)"):
        return _host_pool_map(one, range(b))


def _lossless_decode_streams(headers, streams: List[bytes]) -> np.ndarray:
    """-> (N, d0, h, w) float32, bit-exact.  Predictor ids 0 and 1 (interim
    coders of the reference) are refused."""
    h0 = headers[0]
    n = len(streams)
    sz = h0.n_frames * h0.height * h0.width
    for hd in headers:
        if (hd.height > 4 * cfg.MAX_INTERNAL_IMAGE_DIM
                or hd.width > 4 * cfg.MAX_INTERNAL_IMAGE_DIM
                or hd.n_frames > 1 << 20):
            raise stream.StreamError("implausible ETPU header dimensions")
        if hd.base_levels not in (2, 3):
            raise stream.StreamError(
                "unsupported lossless predictor id (ids 0/1 were interim "
                "pre-release coders; re-encode with a current build)")
        if (hd.n_frames, hd.height, hd.width) != (h0.n_frames, h0.height,
                                                  h0.width):
            raise stream.StreamError("inconsistent chunk stream shapes")

    def one(i):
        hd = headers[i]
        payload = streams[i][stream.FRAME_HEADER_SIZE:
                             stream.FRAME_HEADER_SIZE + hd.base_comp_size]
        raw = entropy.decompress(payload, hd.entropy, sz * 4)
        if len(raw) != sz * 4:
            raise stream.StreamError("lossless payload size mismatch")
        d = np.frombuffer(raw, np.uint32).reshape(
            hd.n_frames, hd.height, hd.width)
        u = _lorenzo_inv(d)
        if hd.base_levels == 3:              # frame-axis difference first
            u = _wrapping_cumsum(u, 0)
        return _ordered_u32_to_f32(u.reshape(-1)).reshape(
            hd.n_frames, hd.height, hd.width)

    with stage("lossless decode (host)"):
        parts = _host_pool_map(one, range(n))
    return np.stack(parts)


def _maybe_lossless_batch(streams: List[bytes]):
    """-> the decoded (N, d0, h, w) array when the batch is lossless
    streams, else None (a peek at the first stream's flags byte; a mixed
    batch raises)."""
    if not streams or len(streams[0]) <= 5 or not (
            streams[0][5] & stream.FLAG_LOSSLESS):
        return None
    headers = [stream.split_frame_stream(s)[0] for s in streams]
    if not all(hd.lossless for hd in headers):
        raise stream.StreamError("mixed lossless/lossy batch")
    return _lossless_decode_streams(headers, streams)


def _lossless_input(x, device) -> np.ndarray:
    """The host array a lossless encode codes: a tensor comes to the host
    once; a numpy batch stays (``device`` is still resolved, so a missing
    card raises as on every entry point)."""
    _check_frames_input(x)
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    resolve_device(device)
    return np.ascontiguousarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# Host-side stream assembly
# ---------------------------------------------------------------------------

def partial_payload_builder(v, stored_cut: int, cut: int, num_planes: int):
    """Rate-mode payloads with a partial next-finer plane (reference
    ``build_partial_payload``, codec.py:543-568, ``FLAG_BASE_PARTIAL``) ->
    ``pb -> (payload_bytes, top)``: the full planes of the magnitudes at
    ``cut``, then the first ``pb`` bytes of the packed plane at ``cut - 1``
    (flat scan order), then the sign plane of the coefficients significant
    in that truncated representation; the header records ``base_cut = cut
    - 1``.  The full planes, the packed next plane and the two sign rows a
    payload can take do not depend on ``pb``, so they are built once per
    (v, cut).  Rows hold whole bytes (the padded width is a multiple of 8),
    so the sign row is that of the refined magnitudes for its first ``pb``
    bytes and that of the magnitudes at ``cut`` after them."""
    assert cut > stored_cut
    mag = np.abs(v) >> (cut - stored_cut)
    mx = int(mag.max()) if mag.size else 0
    msb = mx.bit_length()
    top = num_planes - cut - msb
    full = b"".join(
        np.packbits(((mag >> s) & 1).astype(np.uint8), axis=-1).tobytes()
        for s in range(msb - 1, -1, -1))
    pbit = ((np.abs(v) >> (cut - 1 - stored_cut)) & 1).astype(bool)
    plane = np.packbits(pbit.reshape(-1)).tobytes()
    neg = v < 0
    signs_at_cut = np.packbits(neg & (mag > 0)).tobytes()
    signs_refined = np.packbits(neg & ((mag > 0) | pbit)).tobytes()

    def at(pb: int):
        return (full + plane[:pb] + signs_refined[:pb] + signs_at_cut[pb:],
                top)

    return at


def build_layer_payload_sparse(pos, vals, shape, stored_cut: int, cut: int,
                               num_planes: int):
    """One layer's raw payload for one chunk from its sparse exchange pair
    (reference ebcc_tpu/core/codec.py:121-164): the bitplane stack of the
    magnitudes at ``cut``, MSB first, then the sign plane of coefficients
    significant at the cut.  The port's native packer
    (``native.sparse_to_planes``) writes it; ``EBCC_NO_NATIVE_PACK=1``
    selects the numpy twin below, which writes the same bytes.

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
    if not os.environ.get("EBCC_NO_NATIVE_PACK"):
        return (native.sparse_to_planes(pos, v32, shift, msb, d0v, hpv, wpv),
                top, msb)
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


def _entropy_encode(payload: bytes, backend: int, level: int, meta=None):
    """-> (compressed, backend id used); AUTO codes with both real backends
    and keeps the smaller (reference codec.py:166-173).  ``meta`` =
    (kept, d0, hp, wp, levels) of the payload, which the CAB coders need."""
    if not payload:
        return b"", (entropy.BACKEND_ZSTD
                     if backend == entropy.BACKEND_AUTO else backend)
    return entropy.compress_best(payload, backend, level, meta)


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

    def dense(self, layer: int, i: int) -> np.ndarray:
        """Dense (D0, Hp, Wp) int32 signed kept-values of one chunk/layer."""
        j = layer * self.b + i
        lo, hi = self.splits[j], self.splits[j + 1]
        out = np.zeros(self.sc, np.int32)
        out[self.idx[lo:hi] - j * self.sc] = self.vals[lo:hi]
        return out.reshape(self.shape)

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

    def base_values(self):
        return self.sparse.dense(0, self._i)

    def base_pair(self):
        return self.sparse.pair(0, self._i)

    def res_pair(self):
        return self.sparse.pair(1, self._i)


def _const_stream(res: _ChunkResult, config: CodecConfig, n_frames, h,
                  w) -> bytes:
    """The stream of a constant chunk: a header and no payload."""
    header = stream.FrameHeader(
        flags=stream.FLAG_CONST, entropy=entropy.BACKEND_ZSTD,
        n_frames=n_frames, height=h, width=w,
        minval=float(res.minval), maxval=float(res.maxval),
        rmin=0.0, rmax=0.0,
        base_levels=config.base_levels, res_levels=config.residual_levels,
        base_nplanes=cfg.BASE_NUM_PLANES, base_cut=0, base_top=0,
        res_nplanes=cfg.RES_NUM_PLANES, res_cut=0, res_top=0,
        base_comp_size=0, res_comp_size=0)
    return stream.pack_frame_stream(header, b"", b"")


def _check_overflow(res: _ChunkResult):
    if bool(res.overflow):
        raise RuntimeError(
            "internal coefficient overflow: bitplane count too small for "
            "this data (please report)")


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
        return _const_stream(res, config, n_frames, h, w)
    _check_overflow(res)

    base_cut = int(res.base_cut)
    pure_cut = int(res.pure_cut)
    res_cut = int(res.res_cut)
    skip_residual = bool(res.skip_residual)
    res_feasible = bool(res.res_feasible)
    pure_feasible = bool(res.pure_feasible)
    store_cut = int(res.store_cut)
    shape = res.sparse.shape
    base_meta = lambda kept: (kept, *shape, config.base_levels)
    res_meta = lambda kept: (kept, *shape, config.residual_levels)

    # Candidate A: base @ base_cut (+ residual @ res_cut unless skipped).
    base_pos, base_vals = res.base_pair()
    base_payload, base_top, base_kept = build_layer_payload_sparse(
        base_pos, base_vals, shape, store_cut, base_cut, cfg.BASE_NUM_PLANES)
    base_comp, base_be = _entropy_encode(base_payload, backend, level,
                                         base_meta(base_kept))

    use_residual = (not skip_residual) and res_feasible
    res_comp = b""
    res_top = 0
    res_be = 0
    if use_residual:
        res_payload, res_top, res_kept = build_layer_payload_sparse(
            *res.res_pair(), shape, res_cut, res_cut, cfg.RES_NUM_PLANES)
        res_comp, res_be = _entropy_encode(res_payload, backend, level,
                                           res_meta(res_kept))
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
        pure_payload, pure_top, pure_kept = build_layer_payload_sparse(
            base_pos, base_vals, shape, store_cut, pure_cut,
            cfg.BASE_NUM_PLANES)
        pure_comp, pure_be = _entropy_encode(pure_payload, backend, level,
                                             base_meta(pure_kept))
        if len(pure_comp) < len(base_comp) + len(res_comp):
            logger.info(
                "Pure base compression (%d) is better than base (%d) + "
                "residual (%d)", len(pure_comp), len(base_comp), len(res_comp))
            choose_pure = True

    if choose_pure:
        if pure_comp is None:
            pure_payload, pure_top, pure_kept = build_layer_payload_sparse(
                base_pos, base_vals, shape, store_cut, pure_cut,
                cfg.BASE_NUM_PLANES)
            pure_comp, pure_be = _entropy_encode(pure_payload, backend,
                                                 level, base_meta(pure_kept))
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


def _assemble_temporal_stream(res: _ChunkResult, config: CodecConfig,
                              n_frames, h, w, backend: int,
                              parallel_deltas: bool = True) -> bytes:
    """Serialization of a temporal chunk (reference codec.py:402-540).
    Frame 0's candidate is the one the device picked and carried into the
    prediction loop, so the host does not re-decide it on byte sizes: no
    pure-vs-residual comparison, no drop rule, no mean adjustment."""
    level = config.zstd_level
    if bool(res.const):
        return _const_stream(res, config, n_frames, h, w)
    _check_overflow(res)

    skip_residual = bool(res.skip_residual)
    res_feasible = bool(res.res_feasible)
    ship_pure = (not skip_residual) and (not res_feasible)
    base_cut = int(res.pure_cut) if ship_pure else int(res.base_cut)
    res_cut = int(res.res_cut)
    store_cut = int(res.store_cut)
    use_residual = (not skip_residual) and res_feasible
    if ship_pure and not bool(res.pure_feasible):
        logger.warning(
            "Could not reach error target %g on the intra frame in any "
            "configuration; shipping best effort (finest cut).",
            float(res.target_abs))
    t_feas = np.asarray(res.t_feasible)
    if not t_feas.all():
        logger.warning(
            "Could not reach error target %g on %d delta frame(s); "
            "shipping best effort (max shipped error %g).",
            float(res.target_abs), int((~t_feas).sum()),
            float(np.asarray(res.t_maxerr).max()))

    # Per-frame slices of the chunk's sorted positions: layer entries are
    # (T, Hp, Wp), frame 0's two layers in slot 0, each delta in its slot.
    _, hpv, wpv = res.sparse.shape
    fsz = hpv * wpv
    fshape = (1, hpv, wpv)

    def frame_pair(layer, t):
        pos, vals = res.sparse.pair(layer, res._i)
        lo, hi = np.searchsorted(pos, [t * fsz, (t + 1) * fsz])
        return pos[lo:hi] - t * fsz, vals[lo:hi]

    # Deltas are residual-scale layers: their CAB model takes res_levels.
    base_meta = lambda kept: (kept, *fshape, config.base_levels)
    res_meta = lambda kept: (kept, *fshape, config.residual_levels)

    base_payload, base_top, base_kept = build_layer_payload_sparse(
        *frame_pair(0, 0), fshape, store_cut, base_cut, cfg.BASE_NUM_PLANES)
    base_comp, base_be = _entropy_encode(base_payload, backend, level,
                                         base_meta(base_kept))
    res_comp = b""
    res_top = 0
    res_be = 0
    if use_residual:
        res_payload, res_top, res_kept = build_layer_payload_sparse(
            *frame_pair(1, 0), fshape, res_cut, res_cut, cfg.RES_NUM_PLANES)
        res_comp, res_be = _entropy_encode(res_payload, backend, level,
                                           res_meta(res_kept))

    t_cut = np.asarray(res.t_cut)
    t_rmin = np.asarray(res.t_rmin, np.float32)
    t_rmax = np.asarray(res.t_rmax, np.float32)

    def delta_one(t):
        cut_t = int(t_cut[t - 1])
        payload, top_t, kept_t = build_layer_payload_sparse(
            *frame_pair(1, t), fshape, cut_t, cut_t, cfg.DELTA_NUM_PLANES)
        comp_t, be_t = _entropy_encode(payload, backend, level,
                                       res_meta(kept_t))
        return (stream.DeltaRecord(
            rmin=float(t_rmin[t - 1]), rmax=float(t_rmax[t - 1]),
            cut=cut_t, top=top_t, entropy=be_t, comp_size=len(comp_t)),
            comp_t)

    # The frames' payloads are coded in a pool when the chunk is alone in
    # its batch (the batch-level pool has nothing to spread then).
    if n_frames <= 2 or not parallel_deltas:
        parts = [delta_one(t) for t in range(1, n_frames)]
    else:
        parts = _host_pool_map(delta_one, range(1, n_frames), 4)
    records = [p[0] for p in parts]
    dpayloads = [p[1] for p in parts]

    flags = stream.FLAG_TEMPORAL
    if use_residual:
        flags |= stream.FLAG_HAS_RESIDUAL
    total = (stream.FRAME_HEADER_SIZE + len(base_comp) + len(res_comp)
             + (n_frames - 1) * stream.DELTA_RECORD_SIZE
             + sum(len(p) for p in dpayloads))
    logger.info(
        "chunk %d (temporal): base=%d res=%d deltas=%d skipped=%d "
        "compression ratio: %.2f", res._i, len(base_comp), len(res_comp),
        sum(len(p) for p in dpayloads), int(np.asarray(res.t_skip).sum()),
        n_frames * h * w * 4 / total)

    header = stream.FrameHeader(
        flags=flags, entropy=base_be,
        n_frames=n_frames, height=h, width=w,
        minval=float(res.minval), maxval=float(res.maxval),
        rmin=float(res.rmin) if use_residual else 0.0,
        rmax=float(res.rmax) if use_residual else 0.0,
        base_levels=config.base_levels, res_levels=config.residual_levels,
        base_nplanes=cfg.BASE_NUM_PLANES, base_cut=base_cut,
        base_top=base_top,
        res_nplanes=cfg.RES_NUM_PLANES, res_cut=res_cut if use_residual else 0,
        res_top=res_top,
        base_comp_size=len(base_comp), res_comp_size=len(res_comp),
        res_entropy=res_be if use_residual else 0)
    return stream.pack_temporal_stream(header, base_comp, res_comp,
                                       records, dpayloads)


def _rate_budget(config: CodecConfig, n_frames: int, h: int, w: int) -> int:
    """Payload bytes a rate-mode chunk may take: its raw bytes over
    ``base_cr``, less the header (reference codec.py:598, :1380-1386)."""
    return max(0, int(n_frames * h * w * 4 / config.base_cr)
               - stream.FRAME_HEADER_SIZE)


def _assemble_rate_mode_stream(res: _ChunkResult, config: CodecConfig,
                               n_frames, h, w, backend: int) -> bytes:
    """Rate mode (RESIDUAL_NONE, reference codec.py:571-670): the finest
    cut whose real compressed size fits the ``base_cr`` byte budget, from
    the device's estimate and one entropy call per step (size is monotone
    in the cut), then the rest of the budget filled with a prefix of the
    next-finer plane (``FLAG_BASE_PARTIAL``), its length bisected to the
    byte."""
    level = config.zstd_level
    if bool(res.const):
        return _const_stream(res, config, n_frames, h, w)

    budget = _rate_budget(config, n_frames, h, w)
    est = res.base_est_sizes  # (P+1,)
    store_cut = int(res.store_cut)
    cut = (int(np.argmax(est <= budget)) if (est <= budget).any()
           else cfg.BASE_NUM_PLANES)
    cut = max(cut, store_cut)

    base_pos, base_vals = res.base_pair()
    d0v, hpv, wpv = res.sparse.shape

    def payload_at(c):
        if c >= cfg.BASE_NUM_PLANES:
            return b"", entropy.BACKEND_ZSTD, 0
        pl, top, kept = build_layer_payload_sparse(
            base_pos, base_vals, res.sparse.shape, store_cut, c,
            cfg.BASE_NUM_PLANES)
        comp, be = _entropy_encode(pl, backend, level,
                                   (kept, d0v, hpv, wpv, config.base_levels))
        return comp, be, top

    comp, base_be, top = payload_at(cut)
    while len(comp) > budget and cut < cfg.BASE_NUM_PLANES:
        cut += 1
        comp, base_be, top = payload_at(cut)
    while cut > store_cut:
        trial, trial_be, trial_top = payload_at(cut - 1)
        if len(trial) > budget:
            break
        cut -= 1
        comp, base_be, top = trial, trial_be, trial_top

    # Byte-granular fill, kept only when it beats the full-plane payload.
    flags = 0
    if store_cut < cut <= cfg.BASE_NUM_PLANES and len(comp) < budget:
        plane_bytes = d0v * hpv * wpv // 8
        zbk = entropy.default_backend()
        partial_at = partial_payload_builder(res.base_values(), store_cut,
                                             cut, cfg.BASE_NUM_PLANES)
        lo, hi = 0, plane_bytes
        best = None
        for _ in range(8):
            mid = (lo + hi + 1) // 2
            pl, ptop = partial_at(mid)
            trial = entropy.compress(pl, zbk, level)
            if len(trial) <= budget:
                lo = mid
                best = (trial, ptop)
            else:
                hi = mid - 1
            if lo >= hi:
                break
        if best is not None and len(best[0]) > len(comp):
            comp, top = best
            base_be = zbk
            cut -= 1
            flags |= stream.FLAG_BASE_PARTIAL

    header = stream.FrameHeader(
        flags=flags, entropy=base_be,
        n_frames=n_frames, height=h, width=w,
        minval=float(res.minval), maxval=float(res.maxval),
        rmin=0.0, rmax=0.0,
        base_levels=config.base_levels, res_levels=config.residual_levels,
        base_nplanes=cfg.BASE_NUM_PLANES, base_cut=cut, base_top=top,
        res_nplanes=cfg.RES_NUM_PLANES, res_cut=0, res_top=0,
        base_comp_size=len(comp), res_comp_size=0)
    return stream.pack_frame_stream(header, comp, b"")


def _assemble_batch(out_np, config, opts, n_frames, h, w, backend,
                    n_chunks: int) -> List[bytes]:
    """Host-side stream assembly for a fetched batch, with the entropy
    coding spread over a thread pool (zstandard releases the GIL)."""
    if _temporal_active(config, n_frames):
        fn = lambda i: _assemble_temporal_stream(
            _ChunkResult(out_np, i), config, n_frames, h, w, backend,
            parallel_deltas=n_chunks <= 1)
    elif config.residual_mode == cfg.RESIDUAL_NONE:
        fn = lambda i: _assemble_rate_mode_stream(
            _ChunkResult(out_np, i), config, n_frames, h, w, backend)
    else:
        fn = lambda i: _assemble_error_mode_stream(
            _ChunkResult(out_np, i), config, opts, n_frames, h, w, backend)
    with stage("assemble+zstd"):
        return _host_pool_map(fn, range(n_chunks), 4)


# ---------------------------------------------------------------------------
# Device encode and the exchange
# ---------------------------------------------------------------------------

def _pack_small(small: dict):
    """Every small encode output bit-packed into one int32 vector on the
    device, in key order."""
    parts = []
    for k in sorted(small):
        v = small[k].reshape(-1)
        parts.append(v.view(torch.int32) if v.dtype == torch.float32
                     else v.to(torch.int32))
    return torch.cat(parts)


def _split_small(flat: np.ndarray, small: dict) -> dict:
    """Host-side inverse of :func:`_pack_small`, with ``small`` (the device
    outputs) as the template of shapes and types."""
    outd = {}
    off = 0
    for k in sorted(small):
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


def _fetch_small(small: dict) -> dict:
    """One device-to-host copy of every small encode output."""
    return _split_small(transfer.download(_pack_small(small)), small)


def _rice_enabled() -> bool:
    """Whether the port's host library (the compact exchange's Rice
    readers, the blocked-Rice packer) builds and loads."""
    try:
        native.load_host()
        return True
    except (RuntimeError, OSError):
        return False


# Fused encode-direction fetch (reference codec.py:792-942): with a size
# hint from the previous sub-batch of the same shape, one copy brings the
# small outputs and the compacted Rice pair; the small outputs then give
# the true count and the Rice header the true word count, so a hint miss
# costs more copies, never correctness.  The hint only sizes transfers.
# With spans on, each batch adds its significant-pair count to one of two
# counters (``timing.count``): "exch: index pairs" where the pairs took the
# int32 index fallback, "exch: compact pairs" otherwise (the compact Rice
# pair, hinted or not; a batch with no pair adds 0).
_EXCH_HINTS: dict = {}
_EXCH_LOCK = threading.Lock()


def _exch_hint_get(key):
    with _EXCH_LOCK:
        return _EXCH_HINTS.get(key)


def _exch_hint_put(key, nnz: int, words: int) -> None:
    with _EXCH_LOCK:
        _EXCH_HINTS[key] = {"nnz": int(nnz), "words": int(words)}


def _decode_rice_pair_host(head: np.ndarray, nnz: int, hp: int, wp: int):
    """Host side of the compact exchange: split the fetched pair buffer
    (uint32) and Rice-decode positions and classed values with the port's
    native readers."""
    ga, vb_ = transfer.split_rice_pair(head, nnz)
    idx = native.rice_decode_gaps_classed(
        ga, nnz, hp, wp, transfer.unpack_rice_ks(ga[1]))
    cls = transfer.coeff_class_host(idx, hp, wp)
    vals = native.rice_decode_classed(
        vb_, nnz, cls, transfer.unpack_rice_ks(vb_[1]))
    return idx, vals


def _empty_sparse(b, d0, hp, wp):
    return _SparseBatch(np.zeros(0, np.int32), np.zeros(0, np.int32), b, d0,
                        hp, wp)


def _fetch_rice_pair(out, cap: int, key, nnz: int, hp: int, wp: int):
    """Compact at ``cap``, fetch the exact word count (4 bytes), then the
    pair buffer -> host (positions, values)."""
    words_dev, needed_dev = transfer.compact_rice_exchange(
        out["vals_comb"], out["sig_comb"].reshape(-1), cap=cap, hw=(hp, wp))
    need = int(transfer.download(needed_dev))
    bound = min(transfer.rice_block_bucket(need), int(words_dev.shape[0]))
    head = transfer.sliced_get(words_dev[:bound]).view(np.uint32)
    _exch_hint_put(key, nnz, need)
    return _decode_rice_pair_host(head, nnz, hp, wp)


def _fused_fetch_encode_outputs(out, small_dev, key, hint, b, d0, hp, wp):
    """Hint-sized single-copy fetch of the small outputs and the Rice
    pair.  Returns the host outputs, or None when the hinted capacity
    cannot be used (the caller takes the unhinted path)."""
    cap = transfer.bucket_count(max(1, int(hint["nnz"] * 1.15)))
    if cap > transfer.COMPACT_CAP_LIMIT:
        return None
    max_words = transfer.RICE_PAIR_HEADER_WORDS + (104 * cap) // 32 + 8
    bound = min(transfer.rice_block_bucket(
        max(64, int(hint["words"] * 1.04))), max_words)
    with stage("enc: fused fetch"):
        with stage("enc: fused dispatch"):
            packed = _pack_small(small_dev)
            words_dev, _ = transfer.compact_rice_exchange(
                out["vals_comb"], out["sig_comb"].reshape(-1), cap=cap,
                hw=(hp, wp))
            head_dev = torch.cat([packed, words_dev[:bound]])
        n_small = packed.numel()
        with stage("enc: fused get"):
            flat = transfer.sliced_get(head_dev)
        outd = _split_small(flat[:n_small], small_dev)
        nnz = int(outd.pop("exchange_nnz"))
        if nnz == 0:
            _exch_hint_put(key, 0, 64)
            outd["sparse"] = _empty_sparse(b, d0, hp, wp)
            return outd
        if nnz > cap:
            # Hint miss (the count grew over 15%): compact again at the
            # true capacity.
            cap2 = transfer.bucket_count(nnz)
            if cap2 > transfer.COMPACT_CAP_LIMIT:
                return None
            idx, vals = _fetch_rice_pair(out, cap2, key, nnz, hp, wp)
            outd["sparse"] = _SparseBatch(idx, vals, b, d0, hp, wp)
            return outd
        head = flat[n_small:].view(np.uint32)
        need = (transfer.RICE_PAIR_HEADER_WORDS + (int(head[0]) + 31) // 32
                + (int(head[2]) + 31) // 32)
        if need > bound:
            # Rare: more bits than the hint allowed; the tail is still in
            # the full word buffer on the device.
            hi = min(transfer.rice_block_bucket(need), max_words)
            tail = transfer.sliced_get(words_dev[bound:hi]).view(np.uint32)
            head = np.concatenate([head, tail])
        _exch_hint_put(key, nnz, need)
        with stage("enc: fused host rice"):
            idx, vals = _decode_rice_pair_host(head, nnz, hp, wp)
        outd["sparse"] = _SparseBatch(idx, vals, b, d0, hp, wp)
        return outd


def _fetch_encode_outputs(out: dict, b: int, d0: int, hp: int,
                          wp: int) -> dict:
    """Device encode outputs -> host through the sparse exchange
    (reference ``_fetch_encode_outputs``, codec.py:945-1011).

    With the port's host library: after a sub-batch of the same shape, one
    hint-sized copy of the small outputs and the compacted Rice pair
    (:func:`_fused_fetch_encode_outputs`); else the small outputs in one
    copy, then ``transfer.compact_rice_exchange`` at the bucketed true
    count, a 4-byte copy of its exact size and one copy of the pair buffer
    (~1.3 B per significant coefficient), Rice-decoded on the host.
    Without it, or above ``COMPACT_CAP_LIMIT``, a
    ``torch.nonzero`` over the flat kept values (sorted (layer, chunk)
    order, the pairs the reference's bitmap fallback derives) and one copy
    each of the int32 positions and values."""
    small_dev = {k: v for k, v in out.items()
                 if k not in ("vals_comb", "sig_comb")}
    key = tuple(out["sig_comb"].shape)
    if _rice_enabled():
        hint = _exch_hint_get(key)
        if hint is not None:
            res = _fused_fetch_encode_outputs(out, small_dev, key, hint, b,
                                              d0, hp, wp)
            if res is not None:
                timing.count("exch: compact pairs", res["sparse"].idx.size)
                return res

    with stage("enc: small fetch (+compute)"):
        small = _fetch_small(small_dev)
    nnz = int(small.pop("exchange_nnz"))
    if nnz == 0:
        timing.count("exch: compact pairs", 0)
        small["sparse"] = _empty_sparse(b, d0, hp, wp)
        return small
    if (_rice_enabled()
            and transfer.bucket_count(nnz) <= transfer.COMPACT_CAP_LIMIT):
        with stage("enc: compact+rice fetch"):
            idx, vals = _fetch_rice_pair(out, transfer.bucket_count(nnz),
                                         key, nnz, hp, wp)
        timing.count("exch: compact pairs", nnz)
        small["sparse"] = _SparseBatch(idx, vals, b, d0, hp, wp)
        return small
    vals_comb = out["vals_comb"]
    with stage("enc: sparse fetch"):
        idx = torch.nonzero(vals_comb).reshape(-1)
        vals = transfer.download(vals_comb[idx])
        idx = transfer.download(idx.to(torch.int32))
    timing.count("exch: index pairs", nnz)
    small["sparse"] = _SparseBatch(idx, vals, b, d0, hp, wp)
    return small


def _encode_to_host(xb, config: CodecConfig, opts: EncodeOptions,
                    device) -> dict:
    """Device encode of one (B, n_frames, h, w) batch (a tensor on its
    device, or a numpy batch uploaded to ``device``), fetched to host."""
    b, n_frames, h, w = xb.shape
    hp, wp = _padded_hw(h, w, max(config.base_levels, config.residual_levels))
    if b > _max_safe_batch(n_frames * hp * wp):
        raise ValueError(
            f"batch of {b} chunks x {n_frames * hp * wp} coefficients "
            "exceeds the int32 sparse-index space; lower max_batch")
    levels = dict(base_levels=config.base_levels,
                  res_levels=config.residual_levels)
    relative = config.residual_mode == cfg.RESIDUAL_RELATIVE_ERROR
    xb = _on_device(xb, device)
    with stage("enc: device"):
        if config.residual_mode == cfg.RESIDUAL_NONE:
            out = kernels.encode_batch_rate_only(
                xb, _rate_budget(config, n_frames, h, w), **levels)
        elif _temporal_active(config, n_frames):
            out = kernels.encode_batch_temporal(
                xb, config.error, opts.base_quantile_target,
                relative_mode=relative, **levels)
        else:
            out = kernels.encode_batch(
                xb, config.error, opts.base_quantile_target,
                relative_mode=relative,
                use_centered=not opts.disable_mean_adjustment, **levels)
    return _fetch_encode_outputs(out, b, n_frames, hp, wp)


def _pipeline_encode_slices(slices, config: CodecConfig, opts: EncodeOptions,
                            n_frames, h, w, backend: int,
                            device=None) -> List[bytes]:
    """Encode a sequence of (B, n_frames, h, w) batch slices, pipelined as
    in the reference (``_pipeline_encode_slices``, codec.py:1462-1495): up
    to ``_ENCODE_DEPTH`` fetch workers keep the device encode and fetch of
    later slices in flight while ``_ASSEMBLERS`` workers entropy-code the
    fetched ones.  A numpy slice is uploaded to ``device`` by its fetch
    worker, so only the slices in flight are on the device.  The streams do
    not depend on how the chunks are sliced."""
    fetched = zip(_submit_ahead(
        lambda sl: _encode_to_host(sl, config, opts, device), slices,
        min(_ENCODE_DEPTH, len(slices) - 1), _enc_wait), slices)

    def assemble(pair):
        out_np, sl = pair
        return _assemble_batch(out_np, config, opts, n_frames, h, w, backend,
                               sl.shape[0])

    if len(slices) == 1:
        return assemble(next(fetched))
    return [s for streams in _submit_ahead(assemble, fetched, None, _enc_wait,
                                           workers=_ASSEMBLERS)
            for s in streams]


def encode(data: np.ndarray, config: CodecConfig,
           opts: Optional[EncodeOptions] = None, device="cuda") -> bytes:
    """Encode one logical array (= one chunk) -> ETPU stream bytes, on
    ``device`` (the CUDA card unless ``device="cpu"``)."""
    resolve_device(device)
    set_level_from_env()
    opts = opts or EncodeOptions.from_env()
    data = np.asarray(data, dtype=np.float32).reshape(config.dims)
    n_frames, h, w = _layout(config.dims)
    logger.info("%s", config.describe())
    data = data.reshape(1, n_frames, h, w)
    if _native_routed("encode", device, opts):
        # Reference codec.py:1545-1557: the host codec codes the filled
        # data; the mask sections are appended here.
        if config.residual_mode == cfg.RESIDUAL_LOSSLESS:
            return native.native_encode(data, config)
        data, masks = _mask_fill_check(data, config.allow_nan)
        return _append_mask_sections([native.native_encode(data, config)],
                                     masks, config.zstd_level)[0]
    if config.residual_mode == cfg.RESIDUAL_LOSSLESS:
        return _lossless_encode_frames(data, config)[0]
    x, internal, masks, backend, dev = _prepare_input(data, config, opts,
                                                      device)
    return _finish_streams(
        _pipeline_encode_slices([x], internal, opts, n_frames, h, w, backend,
                                dev), config, masks)[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _parse_streams(streams):
    """-> (headers, (base, res) payloads, temporal sections, mask bitmaps):
    each temporal stream's (delta records, delta payloads), ([], []) for
    the others; each masked stream's packed invalid bitmap, None for the
    others, or None for the whole batch when no stream is masked."""
    headers = []
    payloads = []
    temporal_parts = []
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
        if hd.lossless:
            raise stream.StreamError("mixed lossless/lossy batch")
        headers.append(hd)
        payloads.append((basep, resp))
        # A const stream can be temporal (a flat frame 0 in a live chunk):
        # its deltas still apply.
        temporal_parts.append(stream.split_temporal_section(s, hd)
                              if hd.temporal else ([], []))
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
    # Plain const streams decode either way; every other stream of a batch
    # must agree on temporal against intra.
    tflags = {hd.temporal for hd in headers
              if hd.temporal or not hd.const_field}
    if len(tflags) > 1:
        raise stream.StreamError("inconsistent temporal flags across chunks")
    if all(m is None for m in mask_payloads):
        mask_payloads = None
    return headers, payloads, temporal_parts, mask_payloads


def _layer_values(raws, which: int, plane_bytes: int):
    """Planes -> signed kept-values of layer ``which`` across a batch of
    ``raws`` entries ((base, res) of (raw, kept, pb) each), the numpy twin
    of the native unpacker (``EBCC_NO_NATIVE_UNPACK=1``): bottom-aligned
    plane stack (a partial last row zero-filled), one unpackbits +
    shift-accumulate per plane row, one masked sign apply.  (entries,
    plane_bytes * 8) int32, or None when the layer is empty."""
    ne = len(raws)
    kmax = max((r[which][1] for r in raws), default=0)
    if kmax == 0:
        return None
    planes = np.zeros((ne, kmax, plane_bytes), np.uint8)
    signs = np.zeros((ne, plane_bytes), np.uint8)
    for i, r in enumerate(raws):
        raw, kept, pb = r[which]
        if raw is None:
            continue
        pl = np.frombuffer(raw, np.uint8)
        off = kmax - kept
        full = kept - 1
        planes[i, off:off + full] = pl[:full * plane_bytes].reshape(
            full, plane_bytes)
        planes[i, off + full, :pb] = pl[full * plane_bytes:
                                        full * plane_bytes + pb]
        signs[i] = pl[full * plane_bytes + pb:]
    mag = np.zeros((ne, plane_bytes * 8), np.int32)
    for k in range(kmax):
        mag = (mag << 1) | np.unpackbits(planes[:, k], axis=-1)
    sb = np.unpackbits(signs, axis=-1).astype(bool)
    return np.where(sb, -mag, mag)


def _unpack_planes(raws, shape):
    """Every (layer, entry) plane payload of a batch -> the sorted global
    (int64 index, int32 value) pairs over the (layer, entry, *shape)
    space.  The native unpacker (``native.planes_to_sparse``) runs once per
    (layer, entry) on a pool of at most 4 threads (ctypes releases the
    GIL), in (layer, entry) order so the global index stays sorted
    (reference codec.py:1802-1830); ``EBCC_NO_NATIVE_UNPACK=1`` selects
    the numpy twin :func:`_layer_values`, which gives the same pairs."""
    ne = len(raws)
    d0, hp, wp = shape
    sc = d0 * hp * wp
    parts_idx, parts_val = [], []
    if os.environ.get("EBCC_NO_NATIVE_UNPACK"):
        for layer in (0, 1):
            v = _layer_values(raws, layer, sc // 8)
            if v is None:
                continue
            flat = v.reshape(-1)
            pos = np.flatnonzero(flat)
            parts_idx.append(pos.astype(np.int64) + layer * ne * sc)
            parts_val.append(flat[pos])
    else:
        def one(task):
            layer, j = task
            raw, kept, pb = raws[j][layer]
            if raw is None:
                return None
            pos, vv = native.planes_to_sparse(raw, kept, pb, d0, hp, wp)
            return pos.astype(np.int64) + (layer * ne + j) * sc, vv

        # A one-entry batch unpacks its two layers on the caller's thread.
        tasks = [(layer, j) for layer in (0, 1) for j in range(ne)]
        for r in _host_pool_map(one, tasks, 4 if ne > 1 else 1):
            if r is not None and r[0].size:
                parts_idx.append(r[0])
                parts_val.append(r[1])
    idx = np.concatenate(parts_idx) if parts_idx else np.zeros(0, np.int64)
    vals = np.concatenate(parts_val) if idx.size else np.zeros(0, np.int32)
    return idx, vals


def _decode_streams_device(streams: List[bytes], device):
    """Decode ETPU streams sharing one shape into a ``(N, d0, h, w)`` tensor
    on ``device``, plus host-side (const_mask, const value per chunk, NaN
    mask bitmaps).  NaNs are not restored here.

    The host entropy-decodes the payloads and extracts the sorted (index,
    signed kept-value) pairs; they go up as blocked-Rice lanes up to
    ``transfer.COMPACT_CAP_LIMIT`` pairs and as the index form above it
    (:func:`_upload_rice`, :func:`_upload_index`), the device rebuilds
    the dense coefficient vector from them, and the
    inverse transforms rebuild the batch.  Temporal
    streams decode as one single-frame entry per frame (frame 0's two
    layers, then one delta layer per later frame), which
    :func:`kernels.temporal_accumulate` adds up in the order the encoder
    verified.  Log-domain chunks (pointwise-relative mode) get their
    ``exp`` as the last arithmetic step (reference ``_finish``,
    codec.py:1853-1865).  A lossless batch is decoded on the host and
    uploaded."""
    lossless = _maybe_lossless_batch(streams)
    if lossless is not None:
        n = lossless.shape[0]
        with stage("dec: upload lossless"):
            out = _put(lossless, device)
        return out, np.zeros(n, bool), np.zeros(n, np.float32), None
    headers, payloads, temporal_parts, nan_masks = _parse_streams(streams)
    h0 = headers[0]
    n = len(headers)
    d0, h, w = h0.n_frames, h0.height, h0.width
    hp, wp = _padded_hw(h, w, max(h0.base_levels, h0.res_levels))
    temporal = any(hd.temporal for hd in headers)
    t_frames = d0 if temporal else 1
    ent_d0 = 1 if temporal else d0
    ne = n * t_frames
    sc = ent_d0 * hp * wp
    if ne > _max_safe_batch(sc):
        raise stream.StreamError(
            "decode batch exceeds int32 sparse-index space; use a smaller "
            "max_batch")

    minval = np.zeros(ne, np.float32)
    maxval = np.zeros(ne, np.float32)
    rmin = np.zeros(ne, np.float32)
    rmax = np.zeros(ne, np.float32)
    base_cut = np.zeros(ne, np.int32)
    res_cut = np.zeros(ne, np.int32)
    const_mask = np.zeros(n, bool)
    for i, hd in enumerate(headers):
        j = i * t_frames
        minval[j], maxval[j] = hd.minval, hd.maxval
        # const + temporal: only frame 0 is flat (its entry decodes to
        # minval); the whole-chunk fill is for plain const streams.
        const_mask[i] = hd.const_field and not hd.temporal
        base_cut[j] = hd.base_cut
        if hd.has_residual:
            rmin[j], rmax[j] = hd.rmin, hd.rmax
            res_cut[j] = hd.res_cut
        for t, rec in enumerate(temporal_parts[i][0], start=1):
            if rec.cut > 32 or rec.top > 32:
                raise stream.StreamError("implausible delta record geometry")
            rmin[j + t], rmax[j + t] = rec.rmin, rec.rmax
            res_cut[j + t] = rec.cut
    any_residual = temporal or any(hd.has_residual for hd in headers)
    plane_bytes = ent_d0 * hp * (wp // 8)
    # Log-domain chunks store log values: the host const fill takes their
    # exp (reference codec.py:1682-1692).
    log_flags = np.array([hd.log_domain for hd in headers], bool)
    const_val = minval[::t_frames].copy()
    if log_flags.any():
        with np.errstate(over="ignore"):
            const_val = np.where(log_flags, np.exp(const_val),
                                 const_val).astype(np.float32)

    def _decompress_layer(hd, payload, which):
        """One chunk layer -> (raw bytes, kept, pb), pb the bytes of the
        last plane row present (plane_bytes unless the layer is a
        FLAG_BASE_PARTIAL prefix); (None, 0, 0) when empty."""
        if which == "base":
            num_planes, cut, top = hd.base_nplanes, hd.base_cut, hd.base_top
            backend = hd.entropy
        else:
            num_planes, cut, top = hd.res_nplanes, hd.res_cut, hd.res_top
            backend = hd.res_entropy_effective
        kept = num_planes - cut - top
        if kept <= 0 or not payload:
            return None, 0, 0
        levels = hd.base_levels if which == "base" else hd.res_levels
        max_size = (kept + 1) * plane_bytes
        if which == "base" and hd.flags & stream.FLAG_BASE_PARTIAL:
            if backend in (entropy.BACKEND_NATIVE_CAB,
                           entropy.BACKEND_NATIVE_CAB2):
                raise stream.StreamError(
                    "partial-plane payloads require a zstd/store entropy "
                    "layer")
            raw = entropy.decompress(payload, backend, max_size)
            pb = len(raw) - kept * plane_bytes
            if not 0 <= pb <= plane_bytes:
                raise stream.StreamError(
                    f"partial payload size {len(raw)} outside "
                    f"[{kept * plane_bytes}, {max_size}]")
            return raw, kept, pb
        return _decompress_full(payload, backend, kept, max_size, levels)

    def _decompress_full(payload, backend, kept, max_size, levels):
        raw = entropy.decompress(payload, backend, max_size,
                                 meta=(kept, ent_d0, hp, wp, levels))
        if len(raw) != max_size:
            raise stream.StreamError(
                f"decompressed payload size {len(raw)} != expected "
                f"{max_size}")
        return raw, kept, plane_bytes

    def _decompress_delta(rec, payload):
        # Delta geometry is measured against base_nplanes (the deeper plane
        # budget of config.DELTA_NUM_PLANES).
        kept = h0.base_nplanes - rec.cut - rec.top
        if kept <= 0 or not payload:
            return None, 0, 0
        return _decompress_full(payload, rec.entropy, kept,
                                (kept + 1) * plane_bytes, h0.res_levels)

    def _decompress_one(j):
        i, t = divmod(j, t_frames)
        hd = headers[i]
        if hd.const_field and not hd.temporal:
            return (None, 0, 0), (None, 0, 0)
        if t > 0:
            records, dpayloads = temporal_parts[i]
            return (None, 0, 0), _decompress_delta(records[t - 1],
                                                   dpayloads[t - 1])
        basep, resp = payloads[i]
        base = _decompress_layer(hd, basep, "base")
        res = (_decompress_layer(hd, resp, "res") if hd.has_residual
               else (None, 0, 0))
        return base, res

    with stage("dec: entropy decode"):
        raws = _host_pool_map(_decompress_one, range(ne), 4)

    with stage("dec: unpack planes"):
        idx, vals = _unpack_planes(raws, (ent_d0, hp, wp))

    with stage("dec: upload sparse + decode"):
        kw = dict(base_levels=h0.base_levels, res_levels=h0.res_levels,
                  out_hw=(h, w), has_residual=any_residual,
                  grid_shape=(ne, ent_d0, hp, wp))
        scalars = (base_cut, res_cut, minval, maxval, rmin, rmax)
        # Blocked Rice's lane offsets are int32 in the reference: above the
        # cap the pairs go up in the index form.
        rice = (transfer.bucket_count(max(1, idx.size))
                <= transfer.COMPACT_CAP_LIMIT)
        out = (_upload_rice if rice else _upload_index)(idx, vals, scalars,
                                                         device, kw)
        if temporal:
            out = kernels.temporal_accumulate(out, t_frames)
        if log_flags.any():
            fl = _put(log_flags[:, None, None, None], device)
            out = torch.where(fl, torch.exp(out), out)
    return out, const_mask, const_val, nan_masks


def _put(a: np.ndarray, device):
    """One host array uploaded to ``device``, its bytes counted."""
    return transfer.upload(np.ascontiguousarray(a), device)


def _floats(scalars) -> np.ndarray:
    """(4, B) float32 [minval, maxval, rmin, rmax] of the decode scalars."""
    return np.stack(scalars[2:]).astype(np.float32)


def _upload_rice(idx, vals, scalars, device, kw):
    """Blocked-Rice upload (~1.0 B per pair; reference codec.py:1880-1930):
    the pairs packed by ``native.rice_block_pack`` (its numpy twin without
    the host library) into one buffer, decoded into ``qflat`` by X1."""
    base_cut, res_cut = scalars[:2]
    ne = base_cut.size
    with stage("dec: rice pack host"):
        pack = (native.rice_block_pack if _rice_enabled()
                else transfer.rice_block_pack_host)
        words, lens_g, lens_v, k_packed, base_pos, nb = pack(idx, vals)
    nbk = transfer.rice_block_bucket(nb)
    nwk = transfer.rice_block_bucket(words.size)
    n_ints = nbk + 2 * ne + 1
    buf = np.zeros(4 * nwk + 5 * nbk + 4 * n_ints + 16 * ne, np.uint8)
    buf[:4 * words.size] = words.view(np.uint8)
    o = 4 * nwk
    # Padded lanes keep length 0, so the derived lane offsets stay right.
    buf[o:o + 2 * nb] = lens_g.view(np.uint8)
    o += 2 * nbk
    buf[o:o + 2 * nb] = lens_v.view(np.uint8)
    o += 2 * nbk
    buf[o:o + nb] = k_packed
    o += nbk
    ints = np.zeros(n_ints, np.int32)
    ints[:nb] = base_pos
    ints[nbk:nbk + ne] = base_cut
    ints[nbk + ne:nbk + 2 * ne] = res_cut
    ints[nbk + 2 * ne] = idx.size
    buf[o:o + 4 * n_ints] = ints.view(np.uint8)
    buf[o + 4 * n_ints:] = _floats(scalars).reshape(-1).view(np.uint8)
    with stage("dec: rice upload"):
        buf_dev = transfer.sliced_put(buf, device)
    b, d0, hp, wp = kw["grid_shape"]
    with stage("dec: rice dispatch"):
        return kernels.decode_from_qflat_program(
            *kernels.rice_unpack_qflat(buf_dev, n_blocks=nbk, n_words=nwk,
                                       n_entries=ne, s=b * d0 * hp * wp),
            **kw)


def _upload_index(idx, vals, scalars, device, kw):
    """The int32 index vector and the values (int16 where they all fit),
    one copy each, and one scatter on the device."""
    as16 = bool(np.abs(vals).max() < (1 << 15)) if vals.size else True
    return kernels.decode_batch_sparse(
        _put(idx.astype(np.int32), device).to(torch.int64),
        _put(vals.astype(np.int16 if as16 else np.int32), device),
        *(_put(a, device) for a in scalars), **kw)


def _decode_streams(streams: List[bytes], device) -> np.ndarray:
    """Host-resident decode: :func:`_decode_streams_device` + fetch.  A
    lossless batch is decoded on the host only."""
    arr = _maybe_lossless_batch(streams)
    if arr is not None:
        return arr
    return _finish_host(*_decode_streams_device(streams, device))


def _finish_host(out, const_mask, const_val, nan_masks) -> np.ndarray:
    """Fetch a decoded batch and finish it on the host: constant chunks
    filled, NaNs restored."""
    out = transfer.download(out)
    if const_mask.any():
        out[const_mask] = const_val[const_mask, None, None, None]
    return _apply_nan_masks_host(out, nan_masks)


def _decode_device_batch(streams: List[bytes], device):
    """Device-resident decode of one batch, NaNs restored on the device."""
    out, _, _, nan_masks = _decode_streams_device(streams, device)
    return _apply_nan_masks_device(out, nan_masks)


def decode(buf: bytes, device="cuda") -> np.ndarray:
    """Decode one ETPU stream -> (n_frames, h, w) float32, on ``device``
    (the CUDA card unless ``device="cpu"``).  An ETPK container goes to
    :func:`decode_chunked`, as in the reference.  A reference-format stream
    (EBCC frame or EBCK container) goes to the legacy reader,
    :func:`ebcc_tpu_torch.compat.decode`, which works on the host (J2K
    through Pillow, SPIHT and zstd in C) and returns what the JAX package
    returns: the flattened frame, or the container's N-D array."""
    dev = resolve_device(device)
    if buf[:4] == stream.MAGIC_CHUNKED:
        return decode_chunked(buf, device=dev)
    if buf[:4] in (b"EBCC", b"EBCK"):
        from .. import compat
        return compat.decode(buf)
    if _native_routed("decode", dev):
        header, _, _ = stream.split_frame_stream(buf)
        return native.native_decode(buf).reshape(
            header.n_frames, header.height, header.width)
    return _decode_streams([buf], dev)[0]


# ---------------------------------------------------------------------------
# Device-resident entry points
# ---------------------------------------------------------------------------

def encode_frames_device(x, config: CodecConfig,
                         opts: Optional[EncodeOptions] = None,
                         max_batch: Optional[int] = None,
                         device="cuda") -> List[bytes]:
    """Device-resident encode of a ``(B, n_frames, h, w)`` float32 tensor
    on its own device (or of a numpy array, uploaded to ``device`` one
    sub-batch at a time, the card unless ``device="cpu"``) -> one ETPU
    stream per batch entry.
    ``allow_nan`` masking applies to numpy inputs.

    ``max_batch`` splits the batch into sub-batches pipelined by
    :func:`_pipeline_encode_slices`.  A lossless encode runs on the host,
    ``max_batch`` chunks at a time."""
    opts = opts or EncodeOptions.from_env()
    if config.residual_mode == cfg.RESIDUAL_LOSSLESS:
        xb = _lossless_input(x, device)
        step = max(1, max_batch or xb.shape[0])
        return [s for i in range(0, xb.shape[0], step)
                for s in _lossless_encode_frames(xb[i:i + step], config)]
    x, internal, masks, backend, dev = _prepare_input(x, config, opts, device)
    b, n_frames, h, w = x.shape
    step = max_batch or b
    slices = [x[s:s + step] for s in range(0, b, step)]
    return _finish_streams(
        _pipeline_encode_slices(slices, internal, opts, n_frames, h, w,
                                backend, dev), config, masks)


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
    return torch.cat(list(_submit_ahead(
        lambda bt: _decode_device_batch(bt, dev), batches,
        _DEVICE_DECODE_DEPTH, _dec_wait)), dim=0)


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
    if config.residual_mode == cfg.RESIDUAL_LOSSLESS:
        dev = (x.device if isinstance(x, torch.Tensor)
               else resolve_device(device))
        streams = encode_frames_device(x, config, opts, max_batch, device)
        step = max(1, max_batch or len(streams))
        outs = [_decode_device_batch(streams[s:s + step], dev)
                for s in range(0, len(streams), step)]
        return streams, torch.cat(outs, dim=0)
    x, internal, masks, backend, dev = _prepare_input(x, config, opts, device)
    b, n_frames, h, w = x.shape
    if max_batch is None or b <= max_batch:
        streams = _finish_streams(
            _pipeline_encode_slices([x], internal, opts, n_frames, h, w,
                                    backend, dev), config, masks)
        return streams, _decode_device_batch(streams, dev)

    starts = list(range(0, b, max_batch))
    slices = [x[s:s + max_batch] for s in starts]
    fetched = zip(_submit_ahead(
        lambda sl: _encode_to_host(sl, internal, opts, dev), slices,
        min(_ENCODE_DEPTH, max(1, len(slices) - 1)), _enc_wait), starts,
        slices)

    def post_batch(item):
        """Assemble a slice's streams, then start its device decode."""
        out_np, s0, sl = item
        count = sl.shape[0]
        streams = _assemble_batch(out_np, internal, opts, n_frames, h, w,
                                  backend, count)
        streams = _finish_streams(
            streams, config,
            None if masks is None else masks[s0:s0 + count])
        return streams, _decode_device_batch(streams, dev)

    results = list(_submit_ahead(post_batch, fetched, None, _dec_wait,
                                 workers=_POSTERS))
    streams_out = [s for streams, _ in results for s in streams]
    return streams_out, torch.cat([d for _, d in results], dim=0)


# ---------------------------------------------------------------------------
# ETPK chunked containers (reference codec.py:2265-2567; parity:
# ebcc_encode_chunking / ebcc_encode_chunking_compat / ebcc_decode_chunking,
# ebcc_codec.c:920-1449).  The chunk grid is host numpy; each batch of
# chunks goes to the device on its own.
# ---------------------------------------------------------------------------

def _chunk_grid(dims, chunk_dims):
    return tuple(-(-d // c) for d, c in zip(dims, chunk_dims))


def _gather_chunks(data: np.ndarray, chunk_dims, counts) -> np.ndarray:
    """Every chunk of the grid, in chunk-linear order, with partial edge
    chunks padded by replicating the edge (parity:
    copy_chunk_from_data_padded, ebcc_codec.c:339-351, whose clamped
    indices are ``np.pad``'s edge mode).

    Chunks that span both trailing axes of a writable C-contiguous array
    with no padding are a view of ``data`` (the per-frame chunking of the
    HDF5 filter); every other grid is one strided copy, the inverse of
    :func:`_scatter_chunks`, after the edge padding.  A read-only input is
    copied, so that no tensor is made over memory it may not write."""
    (n0, n1, n2), (c0, c1, c2) = counts, chunk_dims
    if (data.shape == (n0 * c0, c1, c2) and n1 == n2 == 1
            and data.flags.c_contiguous and data.flags.writeable):
        return data.reshape(n0, c0, c1, c2)
    with stage("chunked: gather copy"):
        pad = [(0, n * c - d)
               for d, c, n in zip(data.shape, chunk_dims, counts)]
        if any(p for _, p in pad):
            data = np.pad(data, pad, mode="edge")
        g = np.ascontiguousarray(
            data.reshape(n0, c0, n1, c1, n2, c2).transpose(0, 2, 4, 1, 3, 5))
        if not g.flags.writeable:
            g = g.copy()
        return g.reshape(-1, c0, c1, c2)


def _scatter_chunks(chunks: np.ndarray, dims, chunk_dims,
                    counts) -> np.ndarray:
    """Inverse of :func:`_gather_chunks`: the padding is dropped (parity:
    copy_chunk_to_data_unpadded, ebcc_codec.c:353-370)."""
    n0, n1, n2 = counts
    c0, c1, c2 = chunk_dims
    full = chunks.reshape(n0, n1, n2, c0, c1, c2).transpose(0, 3, 1, 4, 2, 5)
    full = full.reshape(n0 * c0, n1 * c1, n2 * c2)
    return np.ascontiguousarray(full[:dims[0], :dims[1], :dims[2]])


def _container_chunk_dims(config: CodecConfig) -> Tuple[int, int, int]:
    """The config's chunk dims (all zero = one chunk of ``dims``), checked
    as the reference checks them (ebcc_codec.c:937-941)."""
    chunk_dims = tuple(config.chunk_dims)
    if all(c == 0 for c in chunk_dims):
        chunk_dims = tuple(config.dims)
    if any(c == 0 for c in chunk_dims):
        raise ValueError("dims and chunk_dims must be non-zero")
    _layout(chunk_dims)
    return chunk_dims


def _encode_chunk_set(chunks: np.ndarray, chunk_cfg: CodecConfig,
                      opts: EncodeOptions, max_batch: int,
                      device) -> List[bytes]:
    """(N, n_frames, h, w) host chunks -> N streams, with ``chunk_cfg`` from
    ``config.per_chunk``: :func:`encode_frames_device` in slices of
    ``max_batch`` chunks, clamped to the int32 sparse-index space as in the
    reference (the NaN gate and the log check run over this set)."""
    _, n_frames, h, w = chunks.shape
    if chunk_cfg.residual_mode != cfg.RESIDUAL_LOSSLESS:
        hp, wp = _padded_hw(h, w, max(chunk_cfg.base_levels,
                                      chunk_cfg.residual_levels))
        max_batch = min(max_batch, _max_safe_batch(n_frames * hp * wp))
    return encode_frames_device(chunks, chunk_cfg, opts, max_batch, device)


def _native_encode_chunks(chunks: np.ndarray, config: CodecConfig,
                          chunk_dims) -> List[bytes]:
    """Every chunk through the host codec, one stream each (reference
    codec.py:2340-2370): NaNs filled first and mask sections appended to
    the streams, except in lossless mode, which codes every bit."""
    chunk_cfg = config.per_chunk(chunk_dims)
    masks = None
    if config.residual_mode != cfg.RESIDUAL_LOSSLESS:
        chunks, masks = _mask_fill_check(chunks, config.allow_nan)
    with stage("enc: native"):
        streams = _host_pool_map(
            lambda c: native.native_encode(c, chunk_cfg), list(chunks))
    return _append_mask_sections(streams, masks, config.zstd_level)


def encode_chunked(data: np.ndarray, config: CodecConfig,
                   opts: Optional[EncodeOptions] = None,
                   max_batch: int = DEFAULT_MAX_BATCH,
                   device="cuda") -> bytes:
    """Chunked encode -> ETPK container, on ``device`` (the CUDA card unless
    ``device="cpu"``): the chunk grid of ``config.chunk_dims`` over
    ``config.dims``, edge chunks padded by replication, every chunk coded
    as its own stream, ``max_batch`` chunks per device batch (uploaded one
    batch at a time).  The bytes do not depend on ``max_batch``."""
    with stage("request: encode_chunked"):
        dev = resolve_device(device)
        routed = _native_routed("encode", dev, opts)
        set_level_from_env()
        opts = opts or EncodeOptions.from_env()
        chunks, header = _container_chunks(data, config)
        if routed:
            streams = _native_encode_chunks(chunks, config,
                                            header.chunk_dims)
        else:
            streams = _encode_chunk_set(
                chunks, config.per_chunk(header.chunk_dims), opts,
                max_batch, dev)
        return stream.pack_chunked(header, streams)


def _container_header(config: CodecConfig) -> stream.ChunkedHeader:
    """The ETPK header of the chunk grid of ``config`` (chunk dims
    checked)."""
    chunk_dims = _container_chunk_dims(config)
    counts = _chunk_grid(config.dims, chunk_dims)
    return stream.ChunkedHeader(
        dims=tuple(config.dims), chunk_dims=chunk_dims,
        num_chunks=int(np.prod(counts)), chunk_size=int(np.prod(chunk_dims)))


def _container_chunks(data, config: CodecConfig):
    """``data`` on the chunk grid of ``config`` -> ((N, n_frames, h, w)
    host chunks in chunk-linear order, the container's header); warns when
    edge padding adds over 10% to the values.  The chunks may be a view of
    ``data`` (:func:`_gather_chunks`), so callers only read them."""
    data = np.asarray(data, dtype=np.float32).reshape(config.dims)
    header = _container_header(config)
    total = int(np.prod(config.dims))
    padded = header.chunk_size * header.num_chunks
    if padded - total > total // 10:
        logger.warning(
            "Chunk padding adds %d values over %d real values (%.2f%%)",
            padded - total, total, 100.0 * (padded - total) / total)
    with stage("chunked: gather"):
        chunks = _gather_chunks(
            data, header.chunk_dims,
            _chunk_grid(config.dims, header.chunk_dims)).reshape(
                header.num_chunks, *_layout(header.chunk_dims))
    return chunks, header


def encode_chunked_compat(data: np.ndarray, config: CodecConfig,
                          opts: Optional[EncodeOptions] = None,
                          device="cuda") -> bytes:
    """Parity: ``ebcc_encode_chunking_compat`` (ebcc_codec.c:1054-1090).
    Without chunk dims the chunks default to (1, <=1024, <=1024) tiles (a
    dim above the frame limit is tiled by 1024), with an 8-frame lead for
    temporal configs; RELATIVE_ERROR becomes MAX_ERROR over the GLOBAL
    data range, so the bound is uniform across chunks."""
    data = np.asarray(data, dtype=np.float32).reshape(config.dims)
    change = {}
    if all(c == 0 for c in config.chunk_dims):
        d = config.dims
        # Temporal prediction runs along the chunk's leading axis, so
        # per-frame tiles would disable it: 8-frame groups instead.
        lead = min(d[0], 8) if config.temporal else 1
        change["chunk_dims"] = (
            lead,
            1024 if d[1] > cfg.MAX_INTERNAL_IMAGE_DIM else d[1],
            1024 if d[2] > cfg.MAX_INTERNAL_IMAGE_DIM else d[2])
        logger.info("compat chunk dimensions: %s", change["chunk_dims"])
    if config.residual_mode == cfg.RESIDUAL_RELATIVE_ERROR:
        if config.allow_nan:
            if np.isinf(data).any():
                raise ValueError("Inf found in data")
            rng = float(np.nanmax(data) - np.nanmin(data))
            if not np.isfinite(rng):
                raise ValueError("relative mode needs at least one valid "
                                 "sample to derive the range")
        else:
            if not np.isfinite(data).all():
                raise ValueError("NaN or Inf found in data")
            rng = float(data.max() - data.min())
        change.update(error=config.error * rng,
                      residual_mode=cfg.RESIDUAL_MAX_ERROR)
    return encode_chunked(data, dataclasses.replace(config, **change), opts,
                          device=device)


def _container_grid(header):
    """-> the container's chunk-grid counts, after the checks the reference
    makes of its metadata."""
    if any(c == 0 for c in header.chunk_dims) or header.num_chunks == 0:
        raise stream.StreamError("inconsistent chunk metadata")
    counts = _chunk_grid(header.dims, header.chunk_dims)
    if (int(np.prod(counts)) != header.num_chunks
            or int(np.prod(header.chunk_dims)) != header.chunk_size):
        raise stream.StreamError("inconsistent chunk metadata")
    return counts


def _decode_max_batch(header, max_batch: int) -> int:
    n_frames, h, w = _layout(header.chunk_dims)
    hp, wp = _padded_hw(h, w, 5)
    return min(max_batch, _max_safe_batch(n_frames * hp * wp))


def decode_chunked(buf: bytes, max_batch: int = DEFAULT_MAX_BATCH,
                   device="cuda") -> np.ndarray:
    """Decode an ETPK container -> array of its dims, on ``device`` (the
    CUDA card unless ``device="cpu"``), ``max_batch`` chunks per device
    batch.  A plain ETPU stream goes to :func:`decode`, as in the
    reference (ebcc_codec.c:1326-1329)."""
    with stage("request: decode_chunked"):
        dev = resolve_device(device)
        if buf[:4] != stream.MAGIC_CHUNKED:
            return decode(buf, device=dev)
        routed = _native_routed("decode", dev)
        header, chunk_streams = stream.iter_chunked(buf)
        counts = _container_grid(header)
        if routed:
            return _native_decode_chunks(header, chunk_streams, counts,
                                         header.dims)
        return _decode_chunk_subset(header, chunk_streams, counts,
                                    header.dims,
                                    _decode_max_batch(header, max_batch),
                                    dev)


def _region_bounds(region, dims):
    """``region``: 3 ``(start, stop)`` pairs or step-1 slices -> checked
    (lo, hi) pairs."""
    if len(region) != 3:
        raise ValueError(f"region {region} must have 3 axes")
    bounds = []
    for d, r in enumerate(region):
        if isinstance(r, slice):
            if r.step not in (None, 1):
                raise ValueError("region slices must have step 1")
            lo = 0 if r.start is None else int(r.start)
            hi = dims[d] if r.stop is None else int(r.stop)
        else:
            lo, hi = int(r[0]), int(r[1])
        if not 0 <= lo < hi <= dims[d]:
            raise ValueError(
                f"region {region} outside dims {dims} (axis {d})")
        bounds.append((lo, hi))
    return bounds


def decode_chunked_region(buf: bytes, region,
                          max_batch: int = DEFAULT_MAX_BATCH,
                          device="cuda") -> np.ndarray:
    """Random-access decode of a sub-region of an ETPK container, on
    ``device`` (the CUDA card unless ``device="cpu"``).  ``region`` is 3
    ``(start, stop)`` pairs or step-1 slices in the container's dims.
    Only the chunks that intersect it are parsed, entropy-decoded and sent
    to the device; the covering block is clamped to the dims and cropped
    to exactly the region."""
    dev = resolve_device(device)
    if buf[:4] != stream.MAGIC_CHUNKED:
        raise stream.StreamError("region decode needs an ETPK container")
    routed = _native_routed("decode", dev)
    header, chunk_streams = stream.iter_chunked(buf)
    counts = _container_grid(header)
    bounds = _region_bounds(region, header.dims)
    crange = [range(lo // c, -(-hi // c))
              for (lo, hi), c in zip(bounds, header.chunk_dims)]
    ids = [(i0 * counts[1] + i1) * counts[2] + i2
           for i0 in crange[0] for i1 in crange[1] for i2 in crange[2]]
    origin = tuple(r.start * c for r, c in zip(crange, header.chunk_dims))
    # Edge chunks decode to full chunk dims (they were encoded padded):
    # the covered block is clamped to the dims.
    block_dims = tuple(min(o + len(r) * c, d) - o for o, r, c, d in zip(
        origin, crange, header.chunk_dims, header.dims))
    sub = [chunk_streams[i] for i in ids]
    sub_counts = tuple(len(r) for r in crange)
    if routed:
        block = _native_decode_chunks(header, sub, sub_counts, block_dims)
    else:
        block = _decode_chunk_subset(header, sub, sub_counts, block_dims,
                                     _decode_max_batch(header, max_batch),
                                     dev)
    sl = tuple(slice(lo - o, hi - o) for (lo, hi), o in zip(bounds, origin))
    return np.ascontiguousarray(block[sl])


def _native_decode_chunks(header, chunk_streams, counts,
                          out_dims) -> np.ndarray:
    """:func:`_decode_chunk_subset` through the host codec, one stream per
    thread (reference codec.py:2451-2462, :2519-2530)."""
    with stage("dec: native"):
        parts = _host_pool_map(native.native_decode, chunk_streams)
    chunks = np.stack(parts).reshape(len(chunk_streams), *header.chunk_dims)
    return _scatter_chunks(chunks, out_dims, header.chunk_dims, counts)


def _decode_chunk_subset(header, chunk_streams, counts, out_dims, max_batch,
                         device) -> np.ndarray:
    """Decode chunk streams laid out on a ``counts`` grid into an array of
    ``out_dims`` (the grid's coverage, clipped to the container's dims)."""
    arr = _decode_chunk_arrays(chunk_streams, max_batch, device)
    with stage("chunked: scatter"):
        return _scatter_chunks(arr.reshape(len(chunk_streams),
                                           *header.chunk_dims),
                               out_dims, header.chunk_dims, counts)


def _decode_chunk_arrays(chunk_streams, max_batch, device) -> np.ndarray:
    """Chunk streams -> their (N, n_frames, h, w) host arrays, decoded on
    ``device`` ``max_batch`` chunks at a time.  With more than one batch,
    one worker parses, entropy-decodes and uploads batch k+1 while the
    device decodes batch k and the host fetches it; one batch is decoded on
    the caller's thread.  Lossless chunks decode on the host only."""
    arr = _maybe_lossless_batch(chunk_streams)
    if arr is not None:
        return arr
    batches = [chunk_streams[s:s + max_batch]
               for s in range(0, len(chunk_streams), max_batch)]
    decoded = []
    for parts in _submit_ahead(
            lambda bt: _decode_streams_device(bt, device), batches,
            _CHUNK_DECODE_DEPTH, _dec_wait):
        with stage("dec: output fetch"):
            decoded.append(_finish_host(*parts))
    return np.concatenate(decoded, axis=0)
