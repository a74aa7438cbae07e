"""The port's ETPK chunked containers and region decode against the JAX
package's, on the CPU.

Three smooth frames of 96x150 in chunks of (2, 64, 96): 8 chunks, with an
edge chunk on every axis (1 real frame, 32 real rows, 54 real columns).  In
every mode (rate, MAX_ERROR, RELATIVE_ERROR, POINTWISE_RELATIVE_ERROR with
``allow_nan``, temporal and lossless):

* the container header and record framing are byte-equal to
  ``ebcc_tpu.encode_chunked``'s, and each record is the port's own stream of
  that chunk (gathered by the JAX package's ``_gather_chunks``);
* per record, flags, cuts and size (within 1%) equal the JAX package's.  A
  record may differ where a bisection converges onto the error boundary
  (the base-scale refinement, the pure-base against residual choice):
  XLA's CPU code contracts multiply-adds into FMAs and the port accumulates
  means in float64 (ROADMAP Queue 3).  On seeds 0-3 of this fixture at most
  one of the 8 records differed per mode (temporal, seeds 2 and 3), so at
  most one may, and each that does must be byte-identical to its package's
  per-stream encode of that chunk: the difference is the stream encoders',
  not the container path's.  The fixture uses seed 2, where one
  temporal record differs, so that check runs.  Every record must meet the
  bound under both decoders, and the container sizes agree within 1%.
  Lossless containers are byte-identical;
* each package decodes the other's containers within the bound, and the
  port's bytes do not depend on ``max_batch`` (1, 3, 8 and 32).

Region decodes equal a crop of the full decode bit for bit, and only the
intersecting chunks reach the decode.  Malformed containers raise
``StreamError`` where the JAX package raises.  The port's gather equals
the JAX package's clamped-index gather on per-frame, interior and padded
grids, a view of the input where the grid allows one, and no encode route
that gathers writes into the caller's array.  Every port call passes
``device="cpu"``.
"""

import dataclasses
import io
import warnings

import numpy as np
import pytest
import torch

import ebcc_tpu
from ebcc_tpu.core import codec as jcodec
from ebcc_tpu.core.kernels import DECODER_EPS_REL

import ebcc_tpu_torch as et
from ebcc_tpu_torch.core import codec as tcodec
from ebcc_tpu_torch.core import stream as tstream

torch.set_num_threads(2)

DIMS = (3, 96, 150)
CHUNK = (2, 64, 96)
COUNTS = (2, 2, 2)
SEED = 2
# mode -> (config fields, base error quantile)
MODES = {
    "rate": (dict(), 1e-6),
    "max_error": (dict(residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR,
                       error=0.1), 1e-2),
    "relative": (dict(residual_mode=ebcc_tpu.RESIDUAL_RELATIVE_ERROR,
                      error=1e-3), 1e-2),
    "pointwise_nan": (dict(
        residual_mode=ebcc_tpu.RESIDUAL_POINTWISE_RELATIVE_ERROR, error=1e-3,
        allow_nan=True), 1e-2),
    "temporal": (dict(residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR, error=0.1,
                      temporal=True), 1e-2),
    "lossless": (dict(residual_mode=ebcc_tpu.RESIDUAL_LOSSLESS), 1e-6),
}
LOSSY = [m for m in MODES if m != "lossless"]
# Records per mode whose decisions or size may differ from the JAX
# package's (module docstring).
MAX_DIFFERING = 1


def smooth_frames(dims=DIMS, seed=0):
    """Smooth fields with 16x16 blocks of coarse noise and fine noise (the
    residual layer ships on them at a 1e-2 base quantile)."""
    n, h, w = dims
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        f = 260 + 25 * np.sin(yy / h * np.pi + i) * np.cos(xx / w * 6.28)
        f += np.kron(rng.normal(size=(-(-h // 16), -(-w // 16))),
                     np.ones((16, 16)))[:h, :w]
        out.append(f + 0.02 * rng.normal(size=(h, w)))
    return np.stack(out).astype(np.float32)


def mode_data(mode, dims=DIMS, seed=SEED):
    x = smooth_frames(dims, seed)
    if MODES[mode][0].get("allow_nan"):
        x[0, 10:40, 5:50] = np.nan
        x[-1, 80:, 120:] = np.nan
    return x


def configs(mode, dims=DIMS, chunk_dims=CHUNK):
    kw, q = MODES[mode]
    ref = ebcc_tpu.CodecConfig(dims=dims, chunk_dims=chunk_dims, base_cr=30,
                               zstd_level=3, **kw)
    return (ref, et.config_from_reference(dataclasses.asdict(ref)),
            ebcc_tpu.EncodeOptions(base_error_quantile=q),
            et.EncodeOptions(base_error_quantile=q))


@pytest.fixture(scope="module")
def containers():
    """mode -> (data, JAX container, port container)."""
    out = {}
    for mode in MODES:
        x = mode_data(mode)
        ref, cfg, ropts, opts = configs(mode)
        out[mode] = (x, ebcc_tpu.encode_chunked(x, ref, ropts),
                     et.encode_chunked(x, cfg, opts, device="cpu"))
    return out


def assert_bound(mode, x, out):
    """The mode's bound on every valid sample; NaNs exactly where the input
    had them.  RELATIVE bounds each chunk by its own range."""
    assert out.shape == x.shape and out.dtype == np.float32
    nan = np.isnan(x)
    np.testing.assert_array_equal(np.isnan(out), nan)
    kw = MODES[mode][0]
    v = ~nan
    if mode == "lossless":
        np.testing.assert_array_equal(out.view(np.int32), x.view(np.int32))
    elif mode == "pointwise_nan":
        assert np.abs(out[v] / x[v] - 1).max() <= kw["error"]
    elif mode == "relative":
        chunks = tcodec._gather_chunks(x, CHUNK, COUNTS)
        rng = chunks.max(axis=(1, 2, 3)) - chunks.min(axis=(1, 2, 3))
        bound = tcodec._scatter_chunks(
            np.broadcast_to((kw["error"] * rng)[:, None, None, None],
                            chunks.shape), DIMS, CHUNK, COUNTS)
        assert (np.abs(out - x) <= bound).all()
    elif mode == "rate":
        assert np.isfinite(out).all()
    else:
        assert np.abs(out[v] - x[v]).max() <= kw["error"]


def decisions(s):
    hd = tstream.split_frame_stream(s)[0]
    res = (hd.res_cut, hd.res_top) if hd.has_residual else None
    return hd.flags, hd.base_cut, hd.base_top, res


@pytest.mark.parametrize("mode", list(MODES))
def test_header_and_framing_match_jax(containers, mode):
    _, s_jax, s_port = containers[mode]
    assert s_port[:tstream.CHUNKED_HEADER_SIZE] == \
        s_jax[:tstream.CHUNKED_HEADER_SIZE]
    hj, rj = tstream.iter_chunked(s_jax)
    hp, rp = tstream.iter_chunked(s_port)
    assert hp == hj and hp.num_chunks == 8 and len(rp) == len(rj)
    assert hp.dims == DIMS and hp.chunk_dims == CHUNK
    if mode == "lossless":
        assert s_port == s_jax


@pytest.mark.parametrize("mode", LOSSY)
def test_records_match_jax(containers, mode):
    """Per record the JAX package's decisions and size; a record that
    differs is each package's per-stream encode of that chunk
    (``encode_frames_device`` over the gathered chunks) byte for byte, so
    the container path adds no difference of its own."""
    x, s_jax, s_port = containers[mode]
    differing = differing_records(s_jax, s_port)
    assert len(differing) <= MAX_DIFFERING, differing
    assert abs(len(s_port) - len(s_jax)) <= 0.01 * len(s_jax)
    if differing:
        assert stream_encoders_wrote(mode, x, s_jax, s_port, differing)


def differing_records(s_jax, s_port):
    """-> [(index, JAX decisions, port decisions, JAX bytes, port bytes)]
    of the records whose flags or cuts differ or whose sizes are more than
    1% apart."""
    _, rj = tstream.iter_chunked(s_jax)
    _, rp = tstream.iter_chunked(s_port)
    return [(i, decisions(a), decisions(b), len(a), len(b))
            for i, (a, b) in enumerate(zip(rj, rp))
            if decisions(a) != decisions(b)
            or abs(len(a) - len(b)) > 0.01 * len(a)]


def stream_encoders_wrote(mode, x, s_jax, s_port, differing):
    """Whether each package's per-stream encode of the gathered chunks
    (``encode_frames_device``) wrote its differing records byte for
    byte."""
    hd, rj = tstream.iter_chunked(s_jax)
    _, rp = tstream.iter_chunked(s_port)
    ref, cfg, ropts, opts = configs(mode, hd.dims, hd.chunk_dims)
    chunks = jcodec._gather_chunks(
        x, hd.chunk_dims, tcodec._chunk_grid(hd.dims, hd.chunk_dims))
    jax_streams = jcodec.encode_frames_device(
        chunks, ref.per_chunk(hd.chunk_dims), ropts)
    port_streams = et.encode_frames_device(
        chunks, cfg.per_chunk(hd.chunk_dims), opts, device="cpu")
    return all(jax_streams[i] == rj[i] and port_streams[i] == rp[i]
               for i, *_ in differing)


@pytest.mark.parametrize("mode", list(MODES))
def test_records_are_the_ports_chunk_streams(containers, mode):
    """Each record equals the port's own encode of that chunk, gathered by
    the JAX package (which also holds the port's gather to it)."""
    x, _, s_port = containers[mode]
    _, cfg, _, opts = configs(mode)
    chunks = jcodec._gather_chunks(x, CHUNK, COUNTS)
    np.testing.assert_array_equal(
        tcodec._gather_chunks(x, CHUNK, COUNTS), chunks)
    streams = et.encode_frames_device(chunks, cfg.per_chunk(CHUNK), opts,
                                      max_batch=3, device="cpu")
    assert tstream.iter_chunked(s_port)[1] == streams


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_cross_package_decode_meets_bound(containers, mode, direction):
    x, s_jax, s_port = containers[mode]
    if direction == "port_to_jax":
        out = ebcc_tpu.decode_chunked(s_port)
    else:
        out = et.decode_chunked(s_jax, device="cpu")
    assert_bound(mode, x, out)


@pytest.mark.parametrize("mode", list(MODES))
def test_port_decode_meets_bound(containers, mode):
    """The port's own containers, through ``decode_chunked`` and through
    ``decode``'s dispatch on the magic, which agree bit for bit."""
    x, _, s_port = containers[mode]
    out = et.decode_chunked(s_port, device="cpu")
    assert_bound(mode, x, out)
    np.testing.assert_array_equal(et.decode(s_port, device="cpu"), out)


@pytest.mark.parametrize("mode", LOSSY)
def test_bytes_do_not_depend_on_max_batch(containers, mode):
    """The first chunk group (4 chunks) at max_batch 1, 3 and 32 gives the
    same bytes, equal to the container's first 4 records (the whole
    container at max_batch 3: the records test); the decode does not depend
    on max_batch either."""
    x, _, s_port = containers[mode]
    _, cfg, _, opts = configs(mode)
    cfg = dataclasses.replace(cfg, dims=(CHUNK[0], *DIMS[1:]))
    blobs = [et.encode_chunked(x[:CHUNK[0]], cfg, opts, max_batch=mb,
                               device="cpu") for mb in (1, 3, 32)]
    assert blobs[0] == blobs[1] == blobs[2]
    assert tstream.iter_chunked(blobs[0])[1] == \
        tstream.iter_chunked(s_port)[1][:COUNTS[1] * COUNTS[2]]
    np.testing.assert_array_equal(
        et.decode_chunked(s_port, max_batch=3, device="cpu"),
        et.decode_chunked(s_port, device="cpu"))


REGIONS = {
    "interior": ((0, 2), (60, 70), (90, 100)),
    "high_edge": ((2, 3), (50, 96), (90, 150)),
    "one_sample": ((2, 3), (95, 96), (149, 150)),
    "slices": (slice(None), slice(10, 60), slice(None, 97)),
    "everything": ((0, 3), (0, 96), (0, 150)),
}


def _touched(region):
    """Chunks that intersect ``region``, counted per axis."""
    n = 1
    for r, d, c in zip(region, DIMS, CHUNK):
        lo, hi = ((r.start or 0, d if r.stop is None else r.stop)
                  if isinstance(r, slice) else r)
        n *= -(-hi // c) - lo // c
    return n


def _count_decoded(monkeypatch, name):
    seen = []
    inner = getattr(tcodec, name)

    def counting(streams, *args, **kw):
        seen.append(len(streams))
        return inner(streams, *args, **kw)

    monkeypatch.setattr(tcodec, name, counting)
    return seen


@pytest.mark.parametrize("region", list(REGIONS))
@pytest.mark.parametrize("mode", ["max_error", "temporal", "lossless"])
def test_region_is_a_crop_of_the_full_decode(containers, monkeypatch, mode,
                                             region):
    _, _, s_port = containers[mode]
    full = et.decode_chunked(s_port, device="cpu")
    name = ("_lossless_decode_streams" if mode == "lossless"
            else "_decode_streams_device")
    seen = _count_decoded(monkeypatch, name)
    reg = REGIONS[region]
    got = et.decode_chunked_region(s_port, reg, max_batch=3, device="cpu")
    crop = full[tuple(r if isinstance(r, slice) else slice(*r)
                      for r in reg)]
    assert got.shape == crop.shape
    np.testing.assert_array_equal(got.view(np.int32), crop.view(np.int32))
    assert sum(seen) == _touched(reg)


@pytest.mark.parametrize("mode", ["relative", "temporal"])
def test_region_of_a_jax_container(containers, mode):
    """The port's region decode of the JAX package's container equals the
    crop of the port's full decode of it, and agrees with the JAX
    package's own region decode within the decoder-conformance allowance
    (temporal chains: 2 T of it)."""
    x, s_jax, _ = containers[mode]
    reg = REGIONS["high_edge"]
    got = et.decode_chunked_region(s_jax, reg, device="cpu")
    full = et.decode_chunked(s_jax, device="cpu")
    sl = tuple(slice(*r) for r in reg)
    np.testing.assert_array_equal(got.view(np.int32),
                                  full[sl].view(np.int32))
    want = ebcc_tpu.decode_chunked_region(s_jax, reg)
    allowance = (2 * CHUNK[0] if mode == "temporal" else 1) * DECODER_EPS_REL
    assert np.abs(got - want).max() <= allowance * float(x.max() - x.min())


@pytest.mark.parametrize("region", [
    ((0, 4), (0, 96), (0, 150)), ((2, 2), (0, 96), (0, 150)),
    ((-1, 3), (0, 96), (0, 150)), ((0, 3), (0, 97), (0, 150)),
    (slice(0, 5, 2), slice(None), slice(None)),
], ids=["past_end", "empty", "negative", "past_rows", "step_2"])
def test_region_out_of_range_raises(containers, region):
    _, s_jax, s_port = containers["max_error"]
    with pytest.raises(ValueError):
        ebcc_tpu.decode_chunked_region(s_jax, region)
    with pytest.raises(ValueError):
        et.decode_chunked_region(s_port, region, device="cpu")


def _edit_header(buf, offset, fmt, value):
    import struct
    b = bytearray(buf)
    struct.pack_into(fmt, b, offset, value)
    return bytes(b)


MALFORMED = {
    "truncated": lambda b: b[:-1],
    "truncated_header": lambda b: b[:40],
    "missing_size": lambda b: b[:tstream.CHUNKED_HEADER_SIZE + 4],
    "trailing": lambda b: b + b"\0",
    "bad_magic": lambda b: b"ETPX" + b[4:],
    "bad_version": lambda b: _edit_header(b, 4, "<I", 2),
    "bad_ndims": lambda b: _edit_header(b, 8, "<I", 2),
    "dims_disagree": lambda b: _edit_header(b, 16, "<Q", 7),
    "chunk_size_disagrees": lambda b: _edit_header(b, 72, "<Q", 1000),
    "zeroed_header": lambda b: b"ETPK" + bytes(96),
}


@pytest.mark.parametrize("kind", list(MALFORMED))
def test_malformed_containers_raise(containers, kind):
    _, _, s_port = containers["max_error"]
    bad = MALFORMED[kind](s_port)
    with pytest.raises(ValueError):
        ebcc_tpu.decode_chunked(bad)
    with pytest.raises(tstream.StreamError):
        et.decode_chunked(bad, device="cpu")
    with pytest.raises(tstream.StreamError):
        et.decode_chunked_region(bad, REGIONS["interior"], device="cpu")
    with pytest.raises(tstream.StreamError):
        et.decode(bad, device="cpu")


@pytest.mark.parametrize("call", [
    "encode_chunked", "encode_chunked_compat", "decode_chunked",
    "decode_chunked_region"])
def test_default_device_is_the_card(containers, monkeypatch, call):
    x, _, s_port = containers["max_error"]
    _, cfg, _, opts = configs("max_error")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "encode_chunked":
            et.encode_chunked(x, cfg, opts)
        elif call == "encode_chunked_compat":
            et.encode_chunked_compat(x, cfg, opts)
        elif call == "decode_chunked":
            et.decode_chunked(s_port)
        else:
            et.decode_chunked_region(s_port, REGIONS["interior"])


def test_native_routing(containers, monkeypatch):
    """``EBCC_{ENCODE,DECODE}_BACKEND=native`` route the container paths
    through the port's copy of the host codec: ``encode_chunked`` writes
    the JAX package's routed container byte for byte, and
    ``decode_chunked`` and the region decode give the JAX package's
    native decode (a region equal to its crop), within the bound."""
    x, _, _ = containers["max_error"]
    ref, cfg, ropts, opts = configs("max_error")
    monkeypatch.setenv("EBCC_ENCODE_BACKEND", "native")
    blob = et.encode_chunked(x, cfg, opts, device="cpu")
    assert blob == ebcc_tpu.encode_chunked(x, ref, ropts)
    monkeypatch.setenv("EBCC_DECODE_BACKEND", "native")
    full = et.decode_chunked(blob, device="cpu")
    np.testing.assert_array_equal(full, ebcc_tpu.decode_chunked(blob))
    assert_bound("max_error", x, full)
    region = REGIONS["interior"]
    np.testing.assert_array_equal(
        et.decode_chunked_region(blob, region, device="cpu"),
        full[tuple(slice(*r) for r in region)])


def _compat_config(monkeypatch, data, mode, **change):
    """The config each package's ``encode_chunked_compat`` hands to its
    ``encode_chunked`` (captured; nothing is encoded)."""
    ref, cfg, _, _ = configs(mode, dims=data.shape, chunk_dims=(0, 0, 0))
    ref = dataclasses.replace(ref, **change)
    cfg = dataclasses.replace(cfg, **change)
    got = []
    monkeypatch.setattr(jcodec, "encode_chunked",
                        lambda d, c, o=None: got.append(c))
    monkeypatch.setattr(tcodec, "encode_chunked",
                        lambda d, c, o=None, device="cuda": got.append(c))
    ebcc_tpu.encode_chunked_compat(data, ref)
    et.encode_chunked_compat(data, cfg, device="cpu")
    return [dataclasses.asdict(c) for c in got]


@pytest.mark.parametrize("dims,want", [
    ((20, 130, 200), (8, 130, 200)), ((5, 130, 200), (5, 130, 200)),
    ((3, 64, 2100), (3, 64, 1024))])
def test_compat_temporal_lead_of_8(monkeypatch, dims, want):
    data = smooth_frames((dims[0], dims[1], 64))
    data = np.tile(data, (1, 1, -(-dims[2] // 64)))[:, :, :dims[2]]
    ref, port = _compat_config(monkeypatch, np.ascontiguousarray(data),
                               "temporal")
    assert port == ref and port["chunk_dims"] == want
    ref, port = _compat_config(monkeypatch, np.ascontiguousarray(data),
                               "max_error")
    assert port == ref and port["chunk_dims"] == (1, *want[1:])


@pytest.mark.parametrize("case", ["finite", "nan_masked"])
def test_compat_relative_uses_the_global_range(monkeypatch, case):
    data = smooth_frames()
    mode = "relative"
    change = {}
    if case == "nan_masked":
        data[2, :30] = np.nan
        change["allow_nan"] = True
    ref, port = _compat_config(monkeypatch, data, mode, **change)
    assert port == ref
    assert port["residual_mode"] == ebcc_tpu.RESIDUAL_MAX_ERROR
    assert port["error"] == 1e-3 * float(np.nanmax(data) - np.nanmin(data))


@pytest.mark.parametrize("case", ["inf", "nan_unmasked", "all_nan"])
def test_compat_relative_refuses_what_the_jax_package_refuses(case):
    data = smooth_frames()
    ref, cfg, _, _ = configs("relative", chunk_dims=(0, 0, 0))
    if case == "inf":
        data[1, 5, 5] = np.inf
    elif case == "nan_unmasked":
        data[1, 5, 5] = np.nan
    else:
        data[:] = np.nan
    if case != "nan_unmasked":
        ref = dataclasses.replace(ref, allow_nan=True)
        cfg = dataclasses.replace(cfg, allow_nan=True)
    with pytest.raises(ValueError):
        ebcc_tpu.encode_chunked_compat(data, ref)
    with pytest.raises(ValueError):
        et.encode_chunked_compat(data, cfg, device="cpu")


def test_compat_relative_container_meets_the_global_bound():
    """A compat RELATIVE container of the port holds error x the global
    range on every sample, under both decoders."""
    x = smooth_frames()
    _, cfg, _, opts = configs("relative")
    blob = et.encode_chunked_compat(x, cfg, opts, device="cpu")
    bound = 1e-3 * float(x.max() - x.min())
    for out in (et.decode_chunked(blob, device="cpu"),
                ebcc_tpu.decode_chunked(blob)):
        assert np.abs(out - x).max() <= bound


# grid -> (dims, chunk dims, layout of the input, whether the chunks are a
# view of it).  "float64" and "strided" go through ``_container_chunks``.
GATHER_GRIDS = {
    "per_frame": ((8, 32, 40), (1, 32, 40), "c", True),
    "one_chunk": ((3, 32, 40), (3, 32, 40), "c", True),
    "interior": ((4, 64, 96), (2, 32, 32), "c", False),
    "pad_frames": ((3, 32, 40), (2, 32, 40), "c", False),
    "pad_rows": ((2, 72, 40), (1, 32, 40), "c", False),
    "pad_cols": ((2, 32, 72), (1, 32, 32), "c", False),
    "pad_all": (DIMS, CHUNK, "c", False),
    "read_only": ((8, 32, 40), (1, 32, 40), "read_only", False),
    "float64": ((8, 32, 40), (1, 32, 40), "float64", False),
    "strided": ((8, 32, 40), (1, 32, 40), "strided", False),
}


def _gather_input(dims, layout, seed=0):
    x = np.random.default_rng(seed).normal(size=dims).astype(np.float32)
    if layout == "read_only":
        x.flags.writeable = False
    elif layout == "float64":
        x = x.astype(np.float64)
    elif layout == "strided":
        wide = np.zeros((*dims[:2], 2 * dims[2]), np.float32)
        wide[..., ::2] = x
        x = wide[..., ::2]
    return x


@pytest.mark.parametrize("grid", list(GATHER_GRIDS))
def test_gather_equals_the_clamped_index_gather(grid):
    """The port's gather (a view, or edge padding and one strided copy)
    equals the JAX package's clamped-index gather value for value; only
    a writable C-contiguous input chunked along its leading axis alone is
    a view."""
    dims, chunk, layout, view = GATHER_GRIDS[grid]
    x = _gather_input(dims, layout)
    counts = tcodec._chunk_grid(dims, chunk)
    want = jcodec._gather_chunks(np.asarray(x, np.float32), chunk, counts)
    if layout in ("float64", "strided"):
        cfg = et.CodecConfig(dims=dims, chunk_dims=chunk)
        got, header = tcodec._container_chunks(x, cfg)
        assert header.num_chunks == want.shape[0]
    else:
        got = tcodec._gather_chunks(x, chunk, counts)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert np.shares_memory(got, x) == view
    assert got.flags.writeable


FRAME = (1, *DIMS[1:])
# (route:mode, source) of the encodes that gather chunks of the caller's
# array: ``encode_chunked`` in each mode, the other routes once, and a
# writable and a read-only memmap.
UNTOUCHED_CASES = (
    [(f"encode_chunked:{m}", "array") for m in MODES]
    + [(r, "array") for r in ("native:max_error", "compat:relative",
                              "sharded:max_error", "multihost:max_error",
                              "legacy:max_error")]
    + [(r, s) for r in ("encode_chunked:max_error",
                        "compress_stream:max_error")
       for s in ("memmap_r+", "memmap_r")])


def _encode_route(route, x):
    kind, mode = route.split(":")
    # A temporal chunk needs frames: one chunk of the whole array (also a
    # view); one-frame chunks elsewhere, as the HDF5 filter sets them.
    chunk = DIMS if mode == "temporal" else FRAME
    _, cfg, _, opts = configs(mode, chunk_dims=chunk)
    if kind in ("encode_chunked", "native"):
        return et.encode_chunked(x, cfg, opts, device="cpu")
    if kind == "compat":
        _, cfg, _, opts = configs(mode, chunk_dims=(0, 0, 0))
        return et.encode_chunked_compat(x, cfg, opts, device="cpu")
    if kind == "sharded":
        from ebcc_tpu_torch.parallel import encode_chunked_sharded, make_mesh
        return encode_chunked_sharded(x, cfg, opts,
                                      mesh=make_mesh(device="cpu", n=2))
    if kind == "multihost":
        from ebcc_tpu_torch.parallel import multihost
        return multihost.encode_owned_chunks(x, cfg, opts, 0, 1,
                                             device="cpu")
    if kind == "compress_stream":
        from ebcc_tpu_torch import io as tio
        out = io.BytesIO()
        tio.compress_stream(x, cfg, out, opts, device="cpu")
        return out.getvalue()
    from ebcc_tpu_torch.compat import legacy
    return legacy.encode_chunked(x, cfg)


@pytest.mark.parametrize("route,source", UNTOUCHED_CASES)
def test_encode_leaves_the_callers_array_untouched(route, source, tmp_path,
                                                   monkeypatch):
    """Every encode route that gathers reads the caller's array through the
    gather's view and writes nothing into it: after the encode the array
    is byte-equal to a copy taken before.  A read-only memmap takes the
    copy and encodes with no warning."""
    if route.startswith("legacy"):
        from PIL import features
        if not features.check("jpg_2000"):
            pytest.skip("Pillow lacks JPEG2000 support")
    if route.startswith("native"):
        monkeypatch.setenv("EBCC_ENCODE_BACKEND", "native")
    x = mode_data(route.split(":")[1])
    if source != "array":
        np.save(tmp_path / "slab.npy", x)
        x = np.load(tmp_path / "slab.npy", mmap_mode=source[len("memmap_"):])
    before = np.array(x, copy=True)
    views = []
    gather = tcodec._gather_chunks

    def spy(data, chunk_dims, counts):
        out = gather(data, chunk_dims, counts)
        views.append(np.shares_memory(out, x))
        return out
    monkeypatch.setattr(tcodec, "_gather_chunks", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        blob = _encode_route(route, x)
    assert blob and views
    assert all(views) if x.flags.writeable else not any(views)
    np.testing.assert_array_equal(np.asarray(x).view(np.uint32),
                                  before.view(np.uint32))


if __name__ == "__main__":
    # The readings behind MAX_DIFFERING:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_chunked.py \
    #       [--dims D,H,W] SEED...
    # prints, per seed and lossy mode, the records that differ from the JAX
    # package's and whether each package's per-stream encode wrote them.
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--dims", default=",".join(map(str, DIMS)))
    args = ap.parse_args()
    dims = tuple(int(v) for v in args.dims.split(","))
    for seed in args.seeds:
        for mode in LOSSY:
            x = mode_data(mode, dims, seed)
            ref, cfg, ropts, opts = configs(mode, dims)
            s_jax = ebcc_tpu.encode_chunked(x, ref, ropts)
            s_port = et.encode_chunked(x, cfg, opts, device="cpu")
            diff = differing_records(s_jax, s_port)
            wrote = (stream_encoders_wrote(mode, x, s_jax, s_port, diff)
                     if diff else None)
            print(f"dims {dims} chunk {CHUNK} seed {seed} {mode}: "
                  f"differing {diff}, written by the stream encoders "
                  f"{wrote}", flush=True)
