"""Plain decoder of ETPK containers of intra ETPU streams, written from
``docs/FORMAT.md`` (frame version 2, container version 1).

It decides ``correct``: write cells decode the program's containers with it,
read cells compare the program's arrays with its decode of the same
containers.  It imports numpy, torch and :mod:`portbench.zstd_ref`, and
nothing of the program.  It covers what the benchmark's configurations
produce: intra streams with zstd (checksummed) or STORE payloads, the
const-field, has-residual and mean-adjusted flags, and refuses every other
flag or backend.  Every check the format makes normative is made: magic,
versions, dims, chunk grid, record and payload sizes, exact lengths, the
sign plane masked to significant coefficients.

Arithmetic, as the format states it: per coefficient with transmitted
magnitude ``m`` (in units of ``2**cut``) the value ``m * 2**cut`` plus the
midpoint ``2**(cut-1)`` (0.5 at cut 0) when ``m > 0``, sign restored; the
inverse CDF 9/7 lifting, coarsest level first, a column pass then a row
pass, whole-point symmetric boundaries; crop; ``y * (max - min) / scale +
min`` per layer, the residual layer added to the base.  Every operation is
its own torch call, so each is rounded once, in ``dtype`` (float32 for the
reference; the control passes a lower precision).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import zstd_ref

FRAME = struct.Struct("<4sBBBBIIIIffffBBBBBBBBQQQ")
CONTAINER = struct.Struct("<4sIII3Q3QQQ")
assert FRAME.size == 72 and CONTAINER.size == 80

FLAG_CONST, FLAG_RESIDUAL, FLAG_MEAN_ADJUSTED = 0x01, 0x02, 0x04
KNOWN_FLAGS = FLAG_CONST | FLAG_RESIDUAL | FLAG_MEAN_ADJUSTED
STORE, ZSTD = 0, 1
BASE_SCALE, RES_SCALE = 65535.0, 255.0
MIN_DIM, MAX_DIM = 32, 2047

# CDF 9/7 lifting (Daubechies & Sweldens 1998).
ALPHA = -1.586134342
BETA = -0.05298011854
GAMMA = 0.8829110762
DELTA = 0.44355068522
XI = 1.149604398


class FormatError(ValueError):
    """A container or stream that breaks docs/FORMAT.md."""


def layout(dims):
    """Chunk dims (d0, d1, d2) -> the stream's (n_frames, height, width):
    d0 frames of d1 x d2 when d1 is a valid frame height, else one frame of
    d0*d1 x d2."""
    d0, d1, d2 = (int(d) for d in dims)
    if not MIN_DIM <= d2 <= MAX_DIM:
        raise FormatError(f"chunk width {d2} outside [{MIN_DIM}, {MAX_DIM}]")
    if MIN_DIM <= d1 <= MAX_DIM:
        return d0, d1, d2
    if not MIN_DIM <= d0 * d1 <= MAX_DIM:
        raise FormatError(f"invalid chunk dims {dims}")
    return 1, d0 * d1, d2


def parse_container(buf: bytes):
    """-> (dims, chunk_dims, [stream bytes per chunk])."""
    if len(buf) < CONTAINER.size:
        raise FormatError("truncated ETPK header")
    (magic, version, ndims, _r, d0, d1, d2, c0, c1, c2, num_chunks,
     chunk_size) = CONTAINER.unpack_from(buf)
    if magic != b"ETPK" or version != 1 or ndims != 3:
        raise FormatError(f"bad ETPK header {magic!r} v{version} n{ndims}")
    dims, cdims = (d0, d1, d2), (c0, c1, c2)
    if 0 in dims or 0 in cdims:
        raise FormatError("zero dims")
    counts = [-(-d // c) for d, c in zip(dims, cdims)]
    if num_chunks != int(np.prod(counts)) or chunk_size != c0 * c1 * c2:
        raise FormatError("inconsistent chunk metadata")
    off = CONTAINER.size
    streams = []
    for i in range(num_chunks):
        if off + 8 > len(buf):
            raise FormatError(f"missing record {i}")
        (size,) = struct.unpack_from("<Q", buf, off)
        off += 8
        if off + size > len(buf):
            raise FormatError(f"truncated record {i}")
        streams.append(bytes(buf[off:off + size]))
        off += size
    if off != len(buf):
        raise FormatError("trailing bytes after the last record")
    return dims, cdims, streams


def parse_frame(buf: bytes) -> dict:
    """One intra ETPU stream -> its header fields and both payloads."""
    if len(buf) < FRAME.size:
        raise FormatError("truncated ETPU header")
    f = dict(zip(
        ("magic", "version", "flags", "entropy", "res_entropy", "n_frames",
         "height", "width", "reserved", "minval", "maxval", "rmin", "rmax",
         "base_levels", "res_levels", "base_nplanes", "base_cut",
         "base_top", "res_nplanes", "res_cut", "res_top", "base_size",
         "res_size", "reserved2"), FRAME.unpack_from(buf)))
    if f["magic"] != b"ETPU":
        raise FormatError(f"bad ETPU magic {f['magic']!r}")
    if f["version"] not in (1, 2):
        raise FormatError(f"unsupported ETPU version {f['version']}")
    if f["flags"] & ~KNOWN_FLAGS:
        raise FormatError(f"flags {f['flags']:#x} outside this benchmark's "
                          "configurations")
    if f["res_entropy"] == 0:
        f["res_entropy"] = f["entropy"]
    for key in ("entropy", "res_entropy"):
        if f[key] not in (STORE, ZSTD):
            raise FormatError(f"entropy backend {f[key]} not zstd/store")
    if f["reserved"] or f["reserved2"]:
        raise FormatError("reserved header fields not zero")
    end = FRAME.size + f["base_size"] + f["res_size"]
    if end != len(buf):
        raise FormatError(f"stream length {len(buf)}, header says {end}")
    for p in ("base", "res"):
        if not 0 <= f[f"{p}_cut"] + f[f"{p}_top"] <= f[f"{p}_nplanes"] <= 32:
            raise FormatError(f"implausible {p} plane geometry")
    if not (3 <= f["base_levels"] <= 8 and 3 <= f["res_levels"] <= 8):
        raise FormatError("transform depth outside [3, 8]")
    f["base"] = buf[FRAME.size:FRAME.size + f["base_size"]]
    f["res"] = buf[FRAME.size + f["base_size"]:end]
    if f["flags"] & FLAG_CONST and (f["base_size"] or f["res_size"]):
        raise FormatError("const-field stream with payloads")
    if not f["flags"] & FLAG_RESIDUAL and f["res_size"]:
        raise FormatError("residual payload without the residual flag")
    return f


def padded(h: int, w: int, levels: int):
    m = 1 << levels
    return -(-h // m) * m, -(-w // m) * m


def layer_values(payload: bytes, entropy: int, nplanes: int, cut: int,
                 top: int, shape, device, dtype):
    """A layer's payload -> its dequantized coefficients, ``shape`` =
    (n_frames, Hp, Wp), in ``dtype`` on ``device``."""
    nf, hp, wp = shape
    if wp % 8:
        raise FormatError("padded width not a multiple of 8")
    kept = nplanes - cut - top
    if kept <= 0 or not payload:
        if kept <= 0 and payload:
            raise FormatError("payload for a layer with no kept planes")
        return torch.zeros(shape, dtype=dtype, device=device)
    plane = nf * hp * wp // 8
    need = (kept + 1) * plane
    raw = (zstd_ref.decompress(payload, need) if entropy == ZSTD
           else bytes(payload))
    if len(raw) != need:
        raise FormatError(f"layer payload {len(raw)} bytes, {need} expected")
    u8 = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)
    u8 = u8.view(kept + 1, nf, hp, wp // 8)
    shifts = torch.arange(7, -1, -1, device=device, dtype=torch.uint8)
    bits = ((u8.unsqueeze(-1) >> shifts) & 1).reshape(kept + 1, nf, hp, wp)
    m = torch.zeros(shape, dtype=torch.int64, device=device)
    for i in range(kept):                      # MSB plane first
        m = (m << 1) | bits[i].to(torch.int64)
    neg = bits[kept].bool()
    sig = m > 0
    if bool((neg & ~sig).any()):
        raise FormatError("sign plane not masked to significant values")
    mid = float(1 << (cut - 1)) if cut > 0 else 0.5
    mag = (m << cut).to(dtype) + torch.where(sig, mid, 0.0).to(dtype)
    mag = torch.where(sig, mag, torch.zeros((), dtype=dtype, device=device))
    return torch.where(neg, -mag, mag)


def _lift(a, b, coef, axis, forward_neighbour):
    """a + coef * (b + b shifted), the shift with edge replication:
    b[i+1] (last repeated) or b[i-1] (first repeated)."""
    n = b.shape[axis]
    if forward_neighbour:
        nb = torch.cat([b.narrow(axis, 1, n - 1), b.narrow(axis, n - 1, 1)],
                       dim=axis)
    else:
        nb = torch.cat([b.narrow(axis, 0, 1), b.narrow(axis, 0, n - 1)],
                       dim=axis)
    return a + coef * (b + nb)


def idwt1d(y, axis):
    """Inverse 9/7 lifting along ``axis`` (-1 rows, -2 columns) of an
    [low | high] block of even length."""
    n = y.shape[axis]
    even = y.narrow(axis, 0, n // 2) * (1.0 / XI)
    odd = y.narrow(axis, n // 2, n // 2) * XI
    even = _lift(even, odd, -DELTA, axis, forward_neighbour=False)
    odd = _lift(odd, even, -GAMMA, axis, forward_neighbour=True)
    even = _lift(even, odd, -BETA, axis, forward_neighbour=False)
    odd = _lift(odd, even, -ALPHA, axis, forward_neighbour=True)
    return torch.stack([even, odd], dim=axis).reshape(y.shape)


def idwt2d(y, levels: int):
    """Multi-level inverse of (..., Hp, Wp) in Mallat layout."""
    y = y.clone()
    hp, wp = y.shape[-2], y.shape[-1]
    for lvl in range(levels - 1, -1, -1):
        hl, wl = hp >> lvl, wp >> lvl
        blk = idwt1d(y[..., :hl, :wl], axis=-2)
        y[..., :hl, :wl] = idwt1d(blk, axis=-1)
    return y


def _rescale(y, lo, hi, scale, dtype, device):
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=device)
    rng = torch.where(hi_t > lo_t, hi_t - lo_t,
                      torch.ones_like(hi_t)).to(dtype)
    b = (-1,) + (1,) * (y.dim() - 1)
    return y * rng.view(b) / scale + lo_t.to(dtype).view(b)


def decode_streams(streams, dims, device="cpu", dtype=torch.float32):
    """Intra ETPU streams of one chunk shape ``dims`` (n_frames, h, w) ->
    (N, n_frames, h, w) float32 on ``device``, and each stream's header."""
    nf, h, w = dims
    heads = [parse_frame(s) for s in streams]
    out = torch.empty((len(heads), nf, h, w), dtype=dtype, device=device)
    groups = {}
    for i, f in enumerate(heads):
        if (f["n_frames"], f["height"], f["width"]) != (nf, h, w):
            raise FormatError(
                f"stream {i} dims {(f['n_frames'], f['height'], f['width'])}"
                f", chunk {dims}")
        if f["flags"] & FLAG_CONST:
            out[i] = torch.tensor(f["minval"], dtype=torch.float32).to(dtype)
            continue
        groups.setdefault((f["base_levels"], f["res_levels"]), []).append(i)
    for (bl, rl), ids in groups.items():
        hp, wp = padded(h, w, max(bl, rl))
        layers = [("base", bl, BASE_SCALE, "minval", "maxval")]
        if any(heads[i]["flags"] & FLAG_RESIDUAL for i in ids):
            layers.append(("res", rl, RES_SCALE, "rmin", "rmax"))
        acc = None
        for p, levels, scale, lo_key, hi_key in layers:
            use = [i for i in ids if p == "base"
                   or heads[i]["flags"] & FLAG_RESIDUAL]
            coeffs = torch.stack([layer_values(
                heads[i][p], heads[i]["entropy" if p == "base"
                                      else "res_entropy"],
                heads[i][f"{p}_nplanes"], heads[i][f"{p}_cut"],
                heads[i][f"{p}_top"], (nf, hp, wp), device, dtype)
                for i in use])
            y = idwt2d(coeffs, levels)[..., :h, :w]
            y = _rescale(y, [heads[i][lo_key] for i in use],
                         [heads[i][hi_key] for i in use], scale, dtype,
                         device)
            if acc is None:
                acc = y
            else:
                pos = torch.tensor([ids.index(i) for i in use],
                                   device=device)
                acc = acc.index_add(0, pos, y)
        out[torch.tensor(ids, device=device)] = acc
    return out.to(torch.float32), heads


def scatter(chunks, dims, cdims):
    """(N, *cdims) chunks in chunk-linear order -> the (dims) array, edge
    chunks cropped."""
    n0, n1, n2 = (-(-d // c) for d, c in zip(dims, cdims))
    c0, c1, c2 = cdims
    full = chunks.reshape(n0, n1, n2, c0, c1, c2).permute(0, 3, 1, 4, 2, 5)
    full = full.reshape(n0 * c0, n1 * c1, n2 * c2)
    return full[:dims[0], :dims[1], :dims[2]].contiguous()


def decode_container(buf: bytes, device="cpu", dtype=torch.float32):
    """An ETPK container -> (array of its dims as float32 on ``device``,
    per-chunk (minval, maxval) from the stream headers)."""
    dims, cdims, streams = parse_container(buf)
    chunks, heads = decode_streams(streams, layout(cdims), device, dtype)
    ranges = [(f["minval"], f["maxval"]) for f in heads]
    return scatter(chunks.reshape(len(streams), *cdims), dims, cdims), ranges
