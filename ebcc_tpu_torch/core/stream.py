"""Versioned bitstream containers (host-side serialization).

The PyTorch port's own copy of ``ebcc_tpu/core/stream.py``: the header
formats and flag values are the shared stream contract (docs/FORMAT.md) and
must stay byte-identical with the JAX package's.

Format-capability parity with the reference's self-describing, versioned,
chunk-independent containers:

  * ``ETPU`` frame stream <-> reference ``EBCC`` 48-byte frame header
    (reference ``src/ebcc_codec.c:190-202, 870-907, 1226-1258``): magic,
    version, const-field flag, stored min/max (mean-adjusted), residual
    min/max, payload sizes.
  * ``ETPK`` chunking container <-> reference ``EBCK`` 80-byte header
    (ebcc_codec.c:204-213, 975-992): dims, chunk dims, chunk count/size,
    then independent per-chunk ``[u64 size][stream]`` records — chunk
    independence is what makes decode trivially parallel and any prefix of
    chunks resumable.

Differences (deliberate, TPU-first): payloads are entropy-coded dense
bitplane stacks rather than J2K/SPIHT codestreams, so the header carries the
wavelet depths, plane counts, cuts and entropy backend id instead of J2K
lengths.  Little-endian throughout; decoder bounds-checks every field like
the reference's robust-decoder posture (c:1235-1258, 1314-1317).
"""

from __future__ import annotations

import dataclasses
import struct

MAGIC_FRAME = b"ETPU"
MAGIC_CHUNKED = b"ETPK"
# Version 2: the CAB (backend 2) bitstream gained hierarchical skip modes,
# a third refinement context, and two-speed adaptation in round 2 — version
# 1 CAB payloads would silently desync the range coder, so the frame
# version was bumped to make pre-round-2 streams fail loudly instead.
FRAME_VERSION = 2
CHUNKED_VERSION = 1

FLAG_CONST = 0x01
FLAG_HAS_RESIDUAL = 0x02
FLAG_MEAN_ADJUSTED = 0x04
# Rate-mode byte-granular rate control: the base payload carries, after the
# full planes and before the sign plane, a PREFIX of the next-finer
# magnitude plane (coefficients in flat scan order; the rest of that plane
# is zero).  header.base_cut is the finer cut; derived kept counts the
# partial plane; the prefix length is implied by the payload size.  Only
# ever produced with a zstd/store entropy payload.
FLAG_BASE_PARTIAL = 0x08
# Temporal (closed-loop predictive) chunk: the base/res layers describe
# frame 0 only; frames 1..n_frames-1 are coded as error-bounded DELTAS
# against the previous frame's reconstruction.  After the res payload the
# stream carries n_frames-1 DeltaRecord entries (16 B each) followed by
# their concatenated entropy payloads.  Decoders without this flag fail
# loudly on the trailing-bytes check.  No capability in the reference
# (its chunks are always intra-coded); see docs/FORMAT.md.
FLAG_TEMPORAL = 0x10
# Masked chunk (allow_nan): the stream's samples were encoded with every
# NaN input replaced by a per-frame fill value, and the stream's LAST
# section (after the temporal delta section, when present) is an
# entropy-coded packbits bitmap of the invalid samples — decoders restore
# NaN at those positions.  The error bound therefore applies to the VALID
# samples (the reference has no counterpart: it hard-exits on NaN input,
# check_nan_inf, ebcc_codec.c:598-605).  See docs/FORMAT.md.
FLAG_MASKED = 0x20
# Log-domain chunk (pointwise-relative mode): the payloads encode
# log(x) under a max-error bound of log1p(eps) minus the float32 log/exp
# margin; decoders apply exp() as the final arithmetic step (before the
# NaN restore, whose positions are exp-invariant), which guarantees
# |x̂ - x| <= eps * |x| on every sample.  No reference counterpart.
FLAG_LOG_DOMAIN = 0x40
# Lossless chunk (RESIDUAL_LOSSLESS): the base payload is the chunk's
# float32 bits, order-preserving-mapped to uint32, coded per frame as
# wrapping 2-D Lorenzo predictor residuals, entropy-coded (header entropy byte; zstd or
# store).  No residual payload; min/max fields 0; NaN/Inf round-trip
# bit-exactly.  No reference counterpart.  See docs/FORMAT.md.
FLAG_LOSSLESS = 0x80

# magic, version, flags, entropy (base layer), res_entropy,
# n_frames, height, width, reserved2,
# minval, maxval, rmin, rmax,
# base_levels, res_levels, base_nplanes, base_cut, base_top,
# res_nplanes, res_cut, res_top,
# base_comp_size, res_comp_size, reserved3
_FRAME_FMT = "<4s4B4I4f8B3Q"
FRAME_HEADER_SIZE = struct.calcsize(_FRAME_FMT)
assert FRAME_HEADER_SIZE == 72

_CHUNKED_FMT = "<4sIII3Q3QQQ"
CHUNKED_HEADER_SIZE = struct.calcsize(_CHUNKED_FMT)
assert CHUNKED_HEADER_SIZE == 80


class StreamError(ValueError):
    """Invalid/corrupt stream (decode paths return errors, never exit —
    mirrors the reference decoder's error-return posture)."""


@dataclasses.dataclass
class FrameHeader:
    flags: int
    entropy: int            # base-layer entropy backend id
    n_frames: int
    height: int
    width: int
    minval: float
    maxval: float
    rmin: float
    rmax: float
    base_levels: int
    res_levels: int
    base_nplanes: int
    base_cut: int
    base_top: int
    res_nplanes: int
    res_cut: int
    res_top: int
    base_comp_size: int
    res_comp_size: int
    res_entropy: int = 0    # residual backend id; 0 => same as `entropy`

    @property
    def res_entropy_effective(self) -> int:
        return self.res_entropy if self.res_entropy else self.entropy

    @property
    def const_field(self) -> bool:
        return bool(self.flags & FLAG_CONST)

    @property
    def has_residual(self) -> bool:
        return bool(self.flags & FLAG_HAS_RESIDUAL)

    @property
    def temporal(self) -> bool:
        return bool(self.flags & FLAG_TEMPORAL)

    @property
    def masked(self) -> bool:
        return bool(self.flags & FLAG_MASKED)

    @property
    def log_domain(self) -> bool:
        return bool(self.flags & FLAG_LOG_DOMAIN)

    @property
    def lossless(self) -> bool:
        return bool(self.flags & FLAG_LOSSLESS)

    def pack(self) -> bytes:
        return struct.pack(
            _FRAME_FMT, MAGIC_FRAME, FRAME_VERSION, self.flags, self.entropy,
            self.res_entropy,
            self.n_frames, self.height, self.width, 0,
            self.minval, self.maxval, self.rmin, self.rmax,
            self.base_levels, self.res_levels, self.base_nplanes,
            self.base_cut, self.base_top,
            self.res_nplanes, self.res_cut, self.res_top,
            self.base_comp_size, self.res_comp_size, 0)

    @classmethod
    def unpack(cls, buf: bytes) -> "FrameHeader":
        if len(buf) < FRAME_HEADER_SIZE:
            raise StreamError("truncated ETPU header")
        (magic, version, flags, entropy, res_entropy,
         n_frames, height, width, _r1,
         minval, maxval, rmin, rmax,
         base_levels, res_levels, base_nplanes, base_cut, base_top,
         res_nplanes, res_cut, res_top,
         base_comp, res_comp, _r2) = struct.unpack_from(_FRAME_FMT, buf)
        if magic != MAGIC_FRAME:
            raise StreamError(f"bad ETPU magic {magic!r}")
        if version != FRAME_VERSION:
            # Version 1 differs only in the CAB (backend 2) bitstream;
            # zstd/store streams are byte-compatible and stay readable.
            cab = 2  # entropy.BACKEND_NATIVE_CAB (no import cycle)
            if not (version == 1 and entropy != cab
                    and (res_entropy or entropy) != cab):
                raise StreamError(f"unsupported ETPU version {version}")
        if n_frames == 0 or height == 0 or width == 0:
            raise StreamError("invalid ETPU dims")
        return cls(flags, entropy, n_frames, height, width,
                   minval, maxval, rmin, rmax,
                   base_levels, res_levels, base_nplanes, base_cut, base_top,
                   res_nplanes, res_cut, res_top, base_comp, res_comp,
                   res_entropy)


def pack_frame_stream(header: FrameHeader, base_payload: bytes,
                      res_payload: bytes) -> bytes:
    assert header.base_comp_size == len(base_payload)
    assert header.res_comp_size == len(res_payload)
    return header.pack() + base_payload + res_payload


def split_frame_stream(buf: bytes):
    """-> (header, base_payload, res_payload); validates exact length
    (trailing-bytes check parity, ebcc_codec.c:1314-1317).  Temporal
    streams (FLAG_TEMPORAL) carry a delta section after the res payload;
    its records/payloads are validated here and read by
    :func:`split_temporal_section`."""
    header = FrameHeader.unpack(buf)
    off = FRAME_HEADER_SIZE
    end_base = off + header.base_comp_size
    end_res = end_base + header.res_comp_size
    end = end_res
    if header.temporal:
        if header.n_frames < 2:
            raise StreamError("temporal stream with n_frames < 2")
        end = _validate_temporal_section(buf, header, end_res)
    if header.masked:
        end = _validate_mask_section(buf, end)
    if end != len(buf):
        raise StreamError(
            f"payload size mismatch: header says {end}, have {len(buf)}")
    return header, buf[off:end_base], buf[end_base:end_res]


# Per-delta-frame record: rmin, rmax (f32; the stored residual-style scale,
# 0/0 for a skipped frame), cut, top (bitplane geometry like the res
# layer's), entropy backend id, reserved, compressed payload size.
_DELTA_FMT = "<ffBBBBI"
DELTA_RECORD_SIZE = struct.calcsize(_DELTA_FMT)
assert DELTA_RECORD_SIZE == 16


@dataclasses.dataclass
class DeltaRecord:
    rmin: float
    rmax: float
    cut: int
    top: int
    entropy: int
    comp_size: int

    def pack(self) -> bytes:
        return struct.pack(_DELTA_FMT, self.rmin, self.rmax, self.cut,
                           self.top, self.entropy, 0, self.comp_size)


def _validate_temporal_section(buf: bytes, header: FrameHeader,
                               start: int) -> int:
    """-> section end offset (exclusive)."""
    nt = header.n_frames - 1
    rec_end = start + nt * DELTA_RECORD_SIZE
    if rec_end > len(buf):
        raise StreamError("truncated temporal delta records")
    total = 0
    for t in range(nt):
        (_rmin, _rmax, _cut, _top, _ent, _res, csz) = struct.unpack_from(
            _DELTA_FMT, buf, start + t * DELTA_RECORD_SIZE)
        total += csz
    if rec_end + total > len(buf):
        raise StreamError(
            f"temporal payload size mismatch: records say "
            f"{rec_end + total}, have {len(buf)}")
    return rec_end + total


def split_temporal_section(buf: bytes, header: FrameHeader):
    """-> ([DeltaRecord] * (n_frames-1), [payload bytes]); call after
    :func:`split_frame_stream` validated the stream."""
    start = (FRAME_HEADER_SIZE + header.base_comp_size
             + header.res_comp_size)
    nt = header.n_frames - 1
    records = []
    payloads = []
    off = start + nt * DELTA_RECORD_SIZE
    for t in range(nt):
        (rmin, rmax, cut, top, ent, _res, csz) = struct.unpack_from(
            _DELTA_FMT, buf, start + t * DELTA_RECORD_SIZE)
        records.append(DeltaRecord(rmin, rmax, cut, top, ent, csz))
        payloads.append(buf[off:off + csz])
        off += csz
    return records, payloads


def pack_temporal_stream(header: FrameHeader, base_payload: bytes,
                         res_payload: bytes, records, delta_payloads) -> bytes:
    assert header.temporal and len(records) == header.n_frames - 1
    parts = [pack_frame_stream(header, base_payload, res_payload)]
    parts.extend(r.pack() for r in records)
    parts.extend(delta_payloads)
    return b"".join(parts)


# Mask section (FLAG_MASKED), always the LAST section of a stream:
# u8 entropy backend id, 3 reserved bytes, u32 compressed size, payload.
# The payload entropy-decodes to ``ceil(n_frames*height*width / 8)`` bytes
# of np.packbits(bitorder="big") over the row-major invalid-sample bitmap.
_MASK_SECTION_FMT = "<BBBBI"
MASK_SECTION_HEADER_SIZE = struct.calcsize(_MASK_SECTION_FMT)
assert MASK_SECTION_HEADER_SIZE == 8


def _validate_mask_section(buf: bytes, start: int) -> int:
    """-> section end offset (exclusive)."""
    if start + MASK_SECTION_HEADER_SIZE > len(buf):
        raise StreamError("truncated mask section header")
    (_ent, _r0, _r1, _r2, csz) = struct.unpack_from(_MASK_SECTION_FMT, buf,
                                                    start)
    end = start + MASK_SECTION_HEADER_SIZE + csz
    if end > len(buf):
        raise StreamError("truncated mask section payload")
    return end


def mask_section_start(buf: bytes, header: FrameHeader) -> int:
    start = (FRAME_HEADER_SIZE + header.base_comp_size
             + header.res_comp_size)
    if header.temporal:
        start = _validate_temporal_section(buf, header, start)
    return start


def split_mask_section(buf: bytes, header: FrameHeader):
    """-> (entropy backend id, compressed payload bytes); call after
    :func:`split_frame_stream` validated the stream."""
    start = mask_section_start(buf, header)
    (ent, _r0, _r1, _r2, csz) = struct.unpack_from(_MASK_SECTION_FMT, buf,
                                                   start)
    off = start + MASK_SECTION_HEADER_SIZE
    return ent, buf[off:off + csz]


def set_flag(stream_bytes: bytes, flag: int) -> bytes:
    """OR a flag bit into an assembled ETPU stream (the flags byte sits at
    a fixed offset and no header field depends on it)."""
    b = bytearray(stream_bytes)
    b[5] |= flag
    return bytes(b)


def append_mask_section(stream_bytes: bytes, entropy_id: int,
                        payload: bytes) -> bytes:
    """Set FLAG_MASKED on an assembled stream and append its mask section.
    Valid on any assembled ETPU stream: the flags byte is at a fixed offset
    and no header field covers the trailing sections."""
    b = bytearray(set_flag(stream_bytes, FLAG_MASKED))
    b += struct.pack(_MASK_SECTION_FMT, entropy_id, 0, 0, 0, len(payload))
    b += payload
    return bytes(b)


@dataclasses.dataclass
class ChunkedHeader:
    dims: tuple
    chunk_dims: tuple
    num_chunks: int
    chunk_size: int

    def pack(self) -> bytes:
        return struct.pack(
            _CHUNKED_FMT, MAGIC_CHUNKED, CHUNKED_VERSION, 3, 0,
            *self.dims, *self.chunk_dims, self.num_chunks, self.chunk_size)

    @classmethod
    def unpack(cls, buf: bytes) -> "ChunkedHeader":
        if len(buf) < CHUNKED_HEADER_SIZE:
            raise StreamError("truncated ETPK header")
        vals = struct.unpack_from(_CHUNKED_FMT, buf)
        magic, version, ndims = vals[0], vals[1], vals[2]
        if magic != MAGIC_CHUNKED:
            raise StreamError(f"bad ETPK magic {magic!r}")
        if version != CHUNKED_VERSION:
            raise StreamError(f"unsupported ETPK version {version}")
        if ndims != 3:
            raise StreamError(f"unsupported ETPK ndims {ndims}")
        return cls(tuple(vals[4:7]), tuple(vals[7:10]), vals[10], vals[11])


def pack_chunked(header: ChunkedHeader, chunk_streams) -> bytes:
    """The ETPK container: the 80-byte header, then one ``[u64 size]
    [stream]`` record per chunk in chunk-linear order."""
    parts = [header.pack()]
    for s in chunk_streams:
        parts.append(struct.pack("<Q", len(s)))
        parts.append(s)
    return b"".join(parts)


def iter_chunked(buf: bytes):
    """-> (header, [chunk_stream, ...]) with every record bounds-checked
    and no trailing bytes allowed (parity: ebcc_decode_chunking validation,
    ebcc_codec.c:1337-1446)."""
    header = ChunkedHeader.unpack(buf)
    off = CHUNKED_HEADER_SIZE
    streams = []
    for i in range(header.num_chunks):
        if off + 8 > len(buf):
            raise StreamError(f"missing chunk {i} size")
        (size,) = struct.unpack_from("<Q", buf, off)
        off += 8
        if off + size > len(buf):
            raise StreamError(f"truncated chunk {i} payload")
        streams.append(buf[off:off + size])
        off += size
    if off != len(buf):
        raise StreamError("trailing payload bytes")
    return header, streams
