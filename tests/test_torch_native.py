"""The port's host C++ (``ebcc_tpu_torch.native``: the CAB coders, the
sparse packer and unpacker, native routing) against the JAX package's
(``ebcc_tpu.native``), on the CPU.

* The CAB coders (backends 2 and 4) write the JAX package's bytes, on
  random payloads and on payloads of real streams, and decompress them
  back; malformed geometry raises ``ValueError`` in both packages, and a
  corrupted payload decompresses to the same bytes in both.
* The native packer equals its numpy twin (``EBCC_NO_NATIVE_PACK=1``) and
  the reference's packer; the native unpacker equals its numpy twin
  (``_layer_values``) at full planes and at partial last rows.
* Streams with ``entropy_backend`` cab, cab2 and auto, in MAX_ERROR,
  RELATIVE_ERROR, temporal mode and an ETPK container, decode through both
  packages within the bound, both ways.  Against the JAX package's stream
  of the same config the cuts and flags are equal and the sizes within 1%
  (ROADMAP Queue 3: XLA's FMA contraction can move a quantized integer).
* Streams are byte-identical with and without ``EBCC_NO_NATIVE_PACK=1``,
  decodes bit-equal with and without ``EBCC_NO_NATIVE_UNPACK=1``.
* Rate mode's hoisted partial-plane builder writes the JAX package's
  ``build_partial_payload`` bytes at every prefix the bisection visits.
* Native routing writes the JAX package's native encoder's bytes, and
  raises ``RuntimeError`` when the host codec cannot be built.
* The Rice coders of the exchange (``rice_block_pack``, ``rice_decode``,
  ``rice_decode_gaps_classed``, ``rice_decode_classed``) give the JAX
  package's outputs.

Every port call passes ``device="cpu"``.  The ``cuda``-marked tests run
the packer and unpacker checks on the card's encodes and skip without one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ebcc_tpu
from ebcc_tpu import native as jnative
from ebcc_tpu.core import codec as jcodec

import ebcc_tpu_torch as et
from ebcc_tpu_torch import native as tnative
from ebcc_tpu_torch.core import codec as tcodec
from ebcc_tpu_torch.core import stream as tstream
from ebcc_tpu_torch.ops import _build

torch.set_num_threads(2)

QUANTILE = 1e-2          # the residual layer ships at this base quantile
# name -> (dims, chunk dims or None for a frame stream, config fields)
CASES = {
    "max_error": ((1, 96, 160), None,
                  dict(residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR, error=0.1)),
    "relative": ((2, 64, 96), None,
                 dict(residual_mode=ebcc_tpu.RESIDUAL_RELATIVE_ERROR,
                      error=1e-3)),
    "temporal": ((5, 64, 96), None,
                 dict(residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR, error=0.1,
                      temporal=True)),
    "container": ((2, 96, 160), (1, 96, 160),
                  dict(residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR, error=0.1)),
}
# (case, backend) pairs coded by both packages.
CROSS = [("max_error", "cab"), ("max_error", "cab2"), ("max_error", "auto"),
         ("relative", "cab"), ("temporal", "cab2"), ("container", "cab")]


def smooth_frames(dims, seed=0):
    """Smooth fields with 16x16 blocks of coarse noise and fine noise,
    drifting 0.1 per frame."""
    n, h, w = dims
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = 260 + 25 * np.sin(yy / h * np.pi) * np.cos(xx / w * 6.28)
    f += np.kron(rng.normal(size=(-(-h // 16), -(-w // 16))),
                 np.ones((16, 16)))[:h, :w]
    return np.stack([f + 0.1 * k + 0.02 * rng.normal(size=(h, w))
                     for k in range(n)]).astype(np.float32)


def configs(case, backend):
    dims, chunk, kw = CASES[case]
    ref = ebcc_tpu.CodecConfig(dims=dims, chunk_dims=chunk or (0, 0, 0),
                               base_cr=30, zstd_level=3,
                               entropy_backend=backend, **kw)
    return (ref, et.config_from_reference(dataclasses.asdict(ref)),
            ebcc_tpu.EncodeOptions(base_error_quantile=QUANTILE),
            et.EncodeOptions(base_error_quantile=QUANTILE))


def encode_both(case, backend):
    """-> (data, JAX bytes, port bytes) of one case."""
    x = smooth_frames(CASES[case][0])
    ref, cfg, ropts, opts = configs(case, backend)
    if CASES[case][1] is None:
        return (x, ebcc_tpu.encode(x, ref, ropts),
                et.encode(x, cfg, opts, device="cpu"))
    return (x, ebcc_tpu.encode_chunked(x, ref, ropts),
            et.encode_chunked(x, cfg, opts, device="cpu"))


@pytest.fixture(scope="module")
def encoded():
    """(case, backend) -> (data, JAX bytes, port bytes), for CROSS."""
    return {cb: encode_both(*cb) for cb in CROSS}


def records(blob):
    """The frame streams of a stream or a container."""
    if blob[:4] == tstream.MAGIC_CHUNKED:
        return tstream.iter_chunked(blob)[1]
    return [blob]


def decisions(s):
    """(flags, entropy ids, cuts) of a frame stream and its delta records."""
    hd = tstream.split_frame_stream(s)[0]
    out = [(hd.flags, hd.entropy, hd.res_entropy, hd.base_cut, hd.res_cut)]
    if hd.temporal:
        out += [(r.cut, r.entropy, r.comp_size == 0)
                for r in tstream.split_temporal_section(s, hd)[0]]
    return out


def bound(case, x):
    kw = CASES[case][2]
    if kw["residual_mode"] == ebcc_tpu.RESIDUAL_RELATIVE_ERROR:
        return kw["error"] * float(x.max() - x.min())
    return kw["error"]


def payload(rng, kept, plane_bytes, density):
    """A raw layer payload: ``kept`` random plane rows with about
    ``density`` of their bits set, and a sign row set only where some
    magnitude bit is (as the encoders write it)."""
    planes = np.packbits(rng.random((kept, plane_bytes * 8)) < density,
                         axis=-1)
    sig = np.bitwise_or.reduce(planes, axis=0)
    signs = rng.integers(0, 256, plane_bytes, dtype=np.uint8) & sig
    return planes.tobytes() + signs.tobytes()


def stream_payloads():
    """(raw payload, meta) of every non-empty base and residual layer of a
    zstd-coded port stream of the MAX_ERROR case."""
    x = smooth_frames(CASES["max_error"][0])
    _, cfg, _, opts = configs("max_error", "zstd")
    s = et.encode(x, cfg, opts, device="cpu")
    hd, basep, resp = tstream.split_frame_stream(s)
    hp, wp = tcodec._padded_hw(hd.height, hd.width, 5)
    out = []
    for p, nplanes, cut, top, levels in (
            (basep, hd.base_nplanes, hd.base_cut, hd.base_top,
             hd.base_levels),
            (resp, hd.res_nplanes, hd.res_cut, hd.res_top, hd.res_levels)):
        kept = nplanes - cut - top
        if p and kept > 0:
            raw = tcodec.entropy.decompress(p, hd.entropy, 1 << 24)
            out.append((raw, (kept, hd.n_frames, hp, wp, levels)))
    assert len(out) == 2, "the case must ship a residual layer"
    return out


# ---------------------------------------------------------------------------
# The CAB coders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coder", ["cab", "cab2"])
@pytest.mark.parametrize("source", ["random", "stream"])
def test_cab_bytes_equal_reference(coder, source):
    """Exact: the port's coder writes the JAX package's native bytes, and
    each package's decompressor gives the payload back."""
    if source == "random":
        rng = np.random.default_rng(3)
        cases = [(payload(rng, kept, 96 * 160 // 8, dens), (kept, 1, 96, 160,
                                                            lv))
                 for kept, dens, lv in ((1, 0.02, 5), (6, 0.1, 3),
                                        (14, 0.6, 5))]
    else:
        cases = stream_payloads()
    comp_t = getattr(tnative, f"{coder}_compress")
    comp_j = getattr(jnative, f"{coder}_compress")
    dec_t = getattr(tnative, f"{coder}_decompress")
    dec_j = getattr(jnative, f"{coder}_decompress")
    for raw, meta in cases:
        c = comp_t(raw, *meta)
        assert c == comp_j(raw, *meta)
        assert len(c) < len(raw)
        assert dec_t(c, *meta) == raw == dec_j(c, *meta)


@pytest.mark.parametrize("coder", ["cab", "cab2"])
def test_cab_malformed_payload(coder):
    """Malformed geometry raises ``ValueError`` (decompress) or
    ``RuntimeError`` (compress) in the port, where the JAX package raises
    the same; a corrupted stream decompresses to the JAX package's bytes
    (the arithmetic code carries no checksum)."""
    rng = np.random.default_rng(4)
    raw = payload(rng, 5, 64 * 64 // 8, 0.1)
    meta = (5, 1, 64, 64, 3)
    comp = getattr(tnative, f"{coder}_compress")(raw, *meta)
    dec_t = getattr(tnative, f"{coder}_decompress")
    dec_j = getattr(jnative, f"{coder}_decompress")
    for bad_meta in ((0, 1, 64, 64, 3), (5, 1, 64, 60, 3)):
        for dec in (dec_t, dec_j):
            with pytest.raises(ValueError, match="corrupt"):
                dec(comp, *bad_meta)
    for comp_fn in (getattr(tnative, f"{coder}_compress"),
                    getattr(jnative, f"{coder}_compress")):
        with pytest.raises(RuntimeError):
            comp_fn(raw[:-1], *meta)
    bad = bytearray(comp)
    bad[len(bad) // 2] ^= 0xFF
    assert dec_t(bytes(bad), *meta) == dec_j(bytes(bad), *meta)


# ---------------------------------------------------------------------------
# The packer and the unpacker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift,msb_max,density", [
    (0, 1, 0.05), (0, 22, 0.3), (3, 10, 0.6), (0, 0, 0.0)],
    ids=["one_plane", "msb22", "shift3", "empty"])
def test_sparse_to_planes_equals_numpy_twin(monkeypatch, shift, msb_max,
                                            density):
    """Exact: the native packer's payload equals the numpy twin's and the
    JAX package's native packer's, for random sparse sets (sorted
    positions, values up to ``msb_max`` bits after the shift)."""
    d0, hp, wp = 2, 64, 96
    n = d0 * hp * wp
    rng = np.random.default_rng(5)
    pos = np.flatnonzero(rng.random(n) < density).astype(np.int32)
    mags = rng.integers(1, 1 << max(msb_max, 1), pos.size) << shift
    vals = np.where(rng.random(pos.size) < 0.5, -mags, mags).astype(np.int32)
    if pos.size == 0:
        empty = tnative.sparse_to_planes(pos, vals, shift, 1, d0, hp, wp)
        assert empty == bytes(2 * n // 8)
        assert empty == jnative.sparse_to_planes(pos, vals, shift, 1, d0, hp,
                                                 wp)
        assert tcodec.build_layer_payload_sparse(
            pos, vals, (d0, hp, wp), 0, shift, 22) == (b"", 22 - shift, 0)
        return
    native = tcodec.build_layer_payload_sparse(pos, vals, (d0, hp, wp), 0,
                                               shift, 22)
    monkeypatch.setenv("EBCC_NO_NATIVE_PACK", "1")
    twin = tcodec.build_layer_payload_sparse(pos, vals, (d0, hp, wp), 0,
                                             shift, 22)
    msb = native[2]
    assert msb == int((np.abs(vals) >> shift).max()).bit_length()
    assert native == twin
    assert native[0] == jnative.sparse_to_planes(pos, vals, shift, msb, d0,
                                                 hp, wp)


@pytest.mark.parametrize("pb", ["none", "one", "all_but_one", "full"])
def test_planes_to_sparse_equals_layer_values(pb):
    """Exact: the native unpacker gives the (position, value) pairs of the
    numpy twin ``_layer_values``, with a full last row and with a partial
    one of 0, 1 or plane_bytes - 1 bytes."""
    d0, hp, wp, kept = 1, 96, 160, 5
    plane_bytes = d0 * hp * wp // 8
    nb = {"none": 0, "one": 1, "all_but_one": plane_bytes - 1,
          "full": plane_bytes}[pb]
    full = payload(np.random.default_rng(6), kept, plane_bytes, 0.2)
    rows = np.frombuffer(full, np.uint8).reshape(kept + 1, plane_bytes)
    last = rows[kept - 1].copy()
    last[nb:] = 0
    sig = np.bitwise_or.reduce(np.vstack([rows[:kept - 1], last[None]]),
                               axis=0)
    raw = (rows[:kept - 1].tobytes() + last[:nb].tobytes()
           + (rows[kept] & sig).tobytes())
    pos, vals = tnative.planes_to_sparse(raw, kept, nb, d0, hp, wp)
    twin = tcodec._layer_values([((raw, kept, nb), (None, 0, 0))], 0,
                                plane_bytes)[0]
    np.testing.assert_array_equal(pos, np.flatnonzero(twin))
    np.testing.assert_array_equal(vals, twin[pos])
    jpos, jvals = jnative.planes_to_sparse(raw, kept, nb, d0, hp, wp)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(vals, jvals)
    with pytest.raises(ValueError, match="malformed"):
        tnative.planes_to_sparse(raw + b"x", kept, nb, d0, hp, wp)


# ---------------------------------------------------------------------------
# CAB streams between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,backend", CROSS,
                         ids=[f"{c}-{b}" for c, b in CROSS])
def test_cab_streams_cross_decode(encoded, case, backend):
    """Each package decodes the other's stream within the bound; per
    record the flags, entropy ids and cuts equal the JAX package's, and
    sizes agree within 1%."""
    x, s_jax, s_port = encoded[(case, backend)]
    want = {"cab": 2, "cab2": 4}.get(backend)
    for rj, rp in zip(records(s_jax), records(s_port), strict=True):
        assert decisions(rp) == decisions(rj)
        assert abs(len(rp) - len(rj)) <= 0.01 * len(rj)
        ids = {decisions(rp)[0][1]}
        assert ids <= ({want} if want else {1, 2})
    assert abs(len(s_port) - len(s_jax)) <= 0.01 * len(s_jax)
    b = bound(case, x)
    for out in (ebcc_tpu.decode(s_port), et.decode(s_jax, device="cpu")):
        out = out.reshape(x.shape)
        assert np.abs(out - x).max() <= b


@pytest.mark.parametrize("case,backend", [
    ("max_error", "cab"), ("temporal", "cab2"), ("container", "auto"),
    ("rate", "zstd")], ids=["max_error", "temporal", "container", "rate"])
def test_native_pack_and_unpack_equal_twins(monkeypatch, case, backend):
    """Exact: the port's bytes do not change with ``EBCC_NO_NATIVE_PACK=1``
    and its decodes do not change with ``EBCC_NO_NATIVE_UNPACK=1`` (rate
    mode: a partial last plane)."""
    if case == "rate":
        x = smooth_frames((1, 96, 160))
        cfg = et.CodecConfig(dims=x.shape, base_cr=30, zstd_level=3)
        opts = et.EncodeOptions()
        enc = lambda: et.encode(x, cfg, opts, device="cpu")
    else:
        x = smooth_frames(CASES[case][0])
        _, cfg, _, opts = configs(case, backend)
        enc = ((lambda: et.encode(x, cfg, opts, device="cpu"))
               if CASES[case][1] is None else
               (lambda: et.encode_chunked(x, cfg, opts, device="cpu")))
    blob = enc()
    if case == "rate":
        hd = tstream.split_frame_stream(blob)[0]
        assert hd.flags & tstream.FLAG_BASE_PARTIAL
    dec = et.decode(blob, device="cpu")
    monkeypatch.setenv("EBCC_NO_NATIVE_PACK", "1")
    assert enc() == blob
    monkeypatch.setenv("EBCC_NO_NATIVE_UNPACK", "1")
    np.testing.assert_array_equal(et.decode(blob, device="cpu").view(np.int32),
                                  dec.view(np.int32))


def test_rate_partial_payload_equals_reference(monkeypatch):
    """Exact: at every prefix length the rate-mode bisection tries, the
    hoisted builder writes ``ebcc_tpu.core.codec.build_partial_payload``'s
    bytes and top."""
    visited = []
    inner = tcodec.partial_payload_builder

    def recording(v, stored_cut, cut, num_planes):
        at = inner(v, stored_cut, cut, num_planes)

        def rec(pb):
            out = at(pb)
            visited.append((v, stored_cut, cut, pb, out))
            return out
        return rec

    monkeypatch.setattr(tcodec, "partial_payload_builder", recording)
    for cr in (10, 30):
        x = smooth_frames((1, 96, 160), seed=cr)
        et.encode(x, et.CodecConfig(dims=x.shape, base_cr=cr, zstd_level=3),
                  device="cpu")
    monkeypatch.undo()
    assert len(visited) >= 8
    for v, stored_cut, cut, pb, (pl, top) in visited:
        assert (pl, top) == jcodec.build_partial_payload(v, stored_cut, cut,
                                                         pb, 22)


# ---------------------------------------------------------------------------
# Native routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["encode", "encode_chunked"])
def test_routed_encode_equals_reference_native(monkeypatch, call):
    """Exact: a routed encode writes ``ebcc_tpu.native.native_encode`` /
    ``native_encode_chunked``'s bytes (the same C++), CAB included, and the
    routed decodes give ``native_decode``'s values."""
    case = "max_error" if call == "encode" else "container"
    x = smooth_frames(CASES[case][0])
    ref, cfg, _, opts = configs(case, "cab")
    monkeypatch.setenv("EBCC_ENCODE_BACKEND", "native")
    monkeypatch.setenv("EBCC_DECODE_BACKEND", "host")
    if call == "encode":
        blob = et.encode(x, cfg, opts, device="cpu")
        assert blob == jnative.native_encode(x, ref)
        out = et.decode(blob, device="cpu")
    else:
        blob = et.encode_chunked(x, cfg, opts, device="cpu")
        assert blob == jnative.native_encode_chunked(x, ref)
        out = et.decode_chunked(blob, device="cpu")
        region = ((1, 2), (10, 90), (150, 160))
        np.testing.assert_array_equal(
            et.decode_chunked_region(blob, region, device="cpu"),
            out[tuple(slice(*r) for r in region)])
    np.testing.assert_array_equal(out.reshape(-1), jnative.native_decode(blob))
    assert np.abs(out - x).max() <= bound(case, x)


@pytest.mark.parametrize("kind", ["ENCODE", "DECODE"])
def test_routing_without_native_codec_raises(monkeypatch, kind):
    """When the host codec cannot be built a routed call raises
    ``RuntimeError`` naming zstd; it never takes the device path."""
    x = smooth_frames((1, 64, 96))
    _, cfg, _, opts = configs("max_error", "zstd")
    cfg = dataclasses.replace(cfg, dims=x.shape)
    blob = et.encode(x, cfg, opts, device="cpu")

    def fail(name):
        raise RuntimeError("fatal error: zstd.h: No such file or directory")

    monkeypatch.setattr(tnative, "_codec_lib", None)
    monkeypatch.setattr(_build, "load_host", fail)
    monkeypatch.setattr(tcodec, "_pipeline_encode_slices", None)
    monkeypatch.setattr(tcodec, "_decode_streams", None)
    monkeypatch.setenv(f"EBCC_{kind}_BACKEND", "native")
    with pytest.raises(RuntimeError, match="zstd"):
        if kind == "ENCODE":
            et.encode(x, cfg, opts, device="cpu")
        else:
            et.decode(blob, device="cpu")


def test_host_build_is_the_port_own():
    """The host libraries are built from the port's sources into the
    port's build directory, never from or into ``ebcc_tpu/native``."""
    tnative.cab_compress(payload(np.random.default_rng(7), 2, 64, 0.1),
                         2, 1, 8, 64, 2)
    port_csrc = _build.CSRC
    assert port_csrc.endswith("ebcc_tpu_torch/csrc")
    assert {"cab_coder.cc", "sparse_unpack.cc", "rice_decode.cc",
            "rice_block_pack.cc",
            "spiht_coder.cc"} <= set(_build.HOST_LIBS["ebcc_host"][0])
    for name, (srcs, headers, _) in _build.HOST_LIBS.items():
        for f in srcs + headers + [_build.PGO_TRAINER]:
            if f == "zstd_decls.h":     # the port's own: no zstd.h there
                continue
            src = f"{port_csrc}/host/{f}"
            ref = f"{port_csrc}/../../ebcc_tpu/native/{f}"
            with open(src) as a, open(ref) as b:
                # The copy adds a two-line note and is otherwise the
                # original (the codec takes zstd's declarations from the
                # port's header), so the bytes it codes are the original's.
                copy = a.read().split("\n", 2)[2].replace(
                    '#include "zstd_decls.h"', "#include <zstd.h>")
                assert copy == b.read()
    loaded = _build._LIBS["ebcc_host"]._name
    assert loaded.startswith(_build.BUILD_DIR)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 5000])
@pytest.mark.parametrize("scale", [300, 1 << 28], ids=["small", "escape"])
def test_rice_coders_equal_reference(n, scale):
    """The port's copies of the exchange's Rice coders give the JAX
    package's native outputs: the blocked packer's arrays, and the readers'
    pairs from the same word streams."""
    rng = np.random.default_rng([n, scale])
    idx = np.sort(rng.choice(1 << 24, n, replace=False)).astype(np.int64)
    vals = (rng.integers(1, scale + 1, n)
            * rng.choice([-1, 1], n)).astype(np.int32)
    for a, b in zip(tnative.rice_block_pack(idx, vals),
                    jnative.rice_block_pack(idx, vals)):
        np.testing.assert_array_equal(a, b)
    from ebcc_tpu_torch.core import transfer as tt
    cap = tt.bucket_count(max(n, 1))
    v = np.zeros(cap, np.int32)
    v[:n] = vals
    words = tt.rice_pack(torch.from_numpy(v), n, cap=cap).numpy().view(
        np.uint32)
    np.testing.assert_array_equal(tnative.rice_decode(words, n),
                                  jnative.rice_decode(words, n))
    hp, wp = 64, 64
    flat = np.zeros(4 * hp * wp, np.int32)
    pos = np.sort(rng.choice(flat.size, min(n, flat.size), replace=False))
    flat[pos] = vals[:pos.size]
    tw, need = tt.compact_rice_exchange(
        torch.from_numpy(flat), torch.from_numpy(np.packbits(flat != 0)),
        cap=tt.bucket_count(max(pos.size, 1)), hw=(hp, wp))
    ga, vb = tt.split_rice_pair(tw.numpy().view(np.uint32)[:int(need)],
                                pos.size)
    ks_g, ks_v = tt.unpack_rice_ks(ga[1]), tt.unpack_rice_ks(vb[1])
    got = tnative.rice_decode_gaps_classed(ga, pos.size, hp, wp, ks_g)
    np.testing.assert_array_equal(
        got, jnative.rice_decode_gaps_classed(ga, pos.size, hp, wp, ks_g))
    cls = tt.coeff_class_host(got, hp, wp)
    np.testing.assert_array_equal(
        tnative.rice_decode_classed(vb, pos.size, cls, ks_v),
        jnative.rice_decode_classed(vb, pos.size, cls, ks_v))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["max_error", "temporal"])
def test_card_pack_and_unpack_equal_twins(monkeypatch, card, case):
    """On the card's encodes: streams byte-identical with and without
    ``EBCC_NO_NATIVE_PACK=1``, decodes bit-equal with and without
    ``EBCC_NO_NATIVE_UNPACK=1``, within the bound."""
    x = smooth_frames((8, 721, 1440) if case == "max_error" else
                      (2 * 8, 721, 1440))
    _, cfg, _, opts = configs(case, "cab")
    t = 8 if case == "temporal" else 1
    cfg = dataclasses.replace(cfg, dims=x.shape, chunk_dims=(t, 721, 1440))
    xb = torch.from_numpy(x.reshape(-1, t, 721, 1440)).to(card)
    streams = et.encode_frames_device(xb, cfg, opts, max_batch=2)
    dec = et.decode_frames_device(streams, max_batch=2)
    assert float((dec - xb).abs().max()) <= 0.1
    monkeypatch.setenv("EBCC_NO_NATIVE_PACK", "1")
    assert et.encode_frames_device(xb, cfg, opts, max_batch=2) == streams
    monkeypatch.setenv("EBCC_NO_NATIVE_UNPACK", "1")
    assert torch.equal(et.decode_frames_device(streams, max_batch=2), dec)
