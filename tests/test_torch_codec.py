"""The port's codec entry points against the JAX package's, on the CPU.

Streams cross between the packages in both directions and must meet the
error bound; for the same stream the port's reconstruction stays within
``DECODER_EPS_REL`` (4e-6) of the chunk range of the JAX package's (the
decoder-conformance allowance of docs/FORMAT.md); stream sizes of the two
packages agree within 1%; inside the port, streams are byte-identical
whatever the batch partitioning.  Every port call passes ``device="cpu"``
or a CPU tensor.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ebcc_tpu
from ebcc_tpu.core.kernels import DECODER_EPS_REL

import ebcc_tpu_torch as et
from ebcc_tpu_torch.core import stream as tstream

torch.set_num_threads(2)

ERROR = 0.5
SHAPES = {"frame128x256": (1, 128, 256), "three96x128": (3, 96, 128)}


def _data(base, shape):
    n, h, w = shape
    frames = [base[40 * i:40 * i + h, 300 + 50 * i:300 + 50 * i + w]
              for i in range(n)]
    return np.ascontiguousarray(np.stack(frames).astype(np.float32))


def _configs(shape, error=ERROR):
    ref = ebcc_tpu.CodecConfig(dims=shape, base_cr=30,
                               residual_mode=ebcc_tpu.RESIDUAL_MAX_ERROR,
                               error=error, zstd_level=3)
    return ref, et.config_from_reference(dataclasses.asdict(ref))


@pytest.fixture(scope="module")
def streams(base_test_data):
    """name -> (data, JAX stream, port stream)."""
    out = {}
    for name, shape in SHAPES.items():
        x = _data(base_test_data, shape)
        ref_cfg, cfg = _configs(shape)
        out[name] = (x, ebcc_tpu.encode(x, ref_cfg),
                     et.encode(x, cfg, device="cpu"))
    return out


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_cross_package_decode_meets_bound(streams, name, direction):
    x, s_jax, s_port = streams[name]
    if direction == "port_to_jax":
        out = ebcc_tpu.decode(s_port)
    else:
        out = et.decode(s_jax, device="cpu")
    assert out.shape == x.shape and out.dtype == np.float32
    assert np.abs(out - x).max() <= ERROR


@pytest.mark.parametrize("name", list(SHAPES))
def test_decoder_conformance(streams, name):
    x, s_jax, s_port = streams[name]
    for s in (s_jax, s_port):
        ours = et.decode(s, device="cpu")
        ref = ebcc_tpu.decode(s)
        hd = tstream.split_frame_stream(s)[0]
        rng = max(float(x.max() - x.min()), 1e-30)
        assert np.abs(ours - ref).max() <= DECODER_EPS_REL * rng, hd


@pytest.mark.parametrize("name", list(SHAPES))
def test_stream_sizes_agree(streams, name):
    x, s_jax, s_port = streams[name]
    assert abs(len(s_port) - len(s_jax)) <= 0.01 * len(s_jax)


def _smooth_frames(n=5, h=96, w=128, seed=0):
    """Smooth fields with fine noise, on which the residual layer ships
    when the base quantile target is 1e-2."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        f = 260 + 25 * np.sin(yy / h * np.pi + i) * np.cos(xx / w * 6.28)
        f += np.kron(rng.normal(size=(h // 16, w // 16)), np.ones((16, 16)))
        out.append(f + 0.02 * rng.normal(size=(h, w)))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("quantile", [1e-6, 1e-2])
def test_byte_identical_across_batch_partitionings(quantile):
    frames = _smooth_frames()
    x = torch.from_numpy(frames[:, None])
    _, cfg = _configs((5, 96, 128))
    cfg = dataclasses.replace(cfg, chunk_dims=(1, 96, 128))
    opts = et.EncodeOptions(base_error_quantile=quantile)
    runs = [et.encode_frames_device(x, cfg, opts, max_batch=mb)
            for mb in (1, 2, None)]
    assert len(runs[0]) == 5
    assert runs[0] == runs[1] == runs[2]
    flags = [tstream.split_frame_stream(s)[0].has_residual for s in runs[0]]
    assert any(flags) == (quantile > 1e-3)
    streams_rt, dec = et.roundtrip_frames_device(x, cfg, opts, max_batch=2)
    assert streams_rt == runs[0]
    assert dec.device.type == "cpu" and dec.shape == x.shape
    assert float((dec - x).abs().max()) <= ERROR
    dec2 = et.decode_frames_device(streams_rt, max_batch=2, device="cpu")
    assert torch.equal(dec, dec2)
    for i, (s, frame) in enumerate(zip(streams_rt, frames)):
        np.testing.assert_array_equal(et.decode(s, device="cpu")[0],
                                      dec2[i, 0].numpy())
        assert np.abs(ebcc_tpu.decode(s)[0] - frame).max() <= ERROR


@pytest.mark.parametrize("call", ["encode", "decode", "decode_frames"])
def test_default_device_is_the_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((1, 64, 64), np.float32)
    _, cfg = _configs(x.shape)
    blob = et.encode(x, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "encode":
            et.encode(x, cfg)
        elif call == "decode":
            et.decode(blob)
        else:
            et.decode_frames_device([blob])


def test_constant_chunk_roundtrip():
    x = np.full((1, 64, 64), 3.25, np.float32)
    _, cfg = _configs(x.shape)
    blob = et.encode(x, cfg, device="cpu")
    np.testing.assert_array_equal(et.decode(blob, device="cpu"), x)
    np.testing.assert_array_equal(ebcc_tpu.decode(blob), x)


def test_nan_input_raises():
    x = np.zeros((1, 64, 64), np.float32)
    x[0, 3, 4] = np.nan
    _, cfg = _configs(x.shape)
    with pytest.raises(ValueError):
        et.encode(x, cfg, device="cpu")
    with pytest.raises(ValueError):
        et.encode_frames_device(torch.from_numpy(x[None]), cfg)


def test_truncated_stream_raises(streams):
    _, _, s_port = streams["frame128x256"]
    for bad in (s_port[:-1], s_port[:40], b"XXXX" + s_port[4:]):
        with pytest.raises(tstream.StreamError):
            et.decode(bad, device="cpu")


@pytest.mark.parametrize("change", [
    dict(temporal=True, entropy_backend="cab"),
    dict(residual_mode=ebcc_tpu.RESIDUAL_NONE, entropy_backend="cab"),
    dict(residual_mode=ebcc_tpu.RESIDUAL_LOSSLESS, native_routing=True),
    dict(entropy_backend="cab"),
], ids=["temporal", "rate", "lossless", "cab"])
def test_cab_and_native_routing_in_every_mode(monkeypatch, streams,
                                              change):
    """The CAB coder in temporal, rate and intra mode, and native routing
    of a lossless encode, on the fixture's three frames: the port's stream
    decodes through both packages within the mode's bound (bit-exact for
    lossless).  Against the JAX package's stream of the same config (the
    temporal one is held against it in ``test_torch_native.py``), the size
    is within 1% and the flags, cut and entropy byte are equal; the routed
    lossless stream is the JAX package's native encoder's, byte for byte."""
    x = streams["three96x128"][0]
    ref, cfg = _configs(x.shape)
    change = dict(change)
    routed = change.pop("native_routing", False)
    ref = dataclasses.replace(ref, **change)
    cfg = dataclasses.replace(cfg, **change)
    if routed:
        monkeypatch.setenv("EBCC_ENCODE_BACKEND", "native")
    s_port = et.encode(x, cfg, device="cpu")
    hd = tstream.split_frame_stream(s_port)[0]
    if routed:
        from ebcc_tpu import native as jnative
        assert s_port == jnative.native_encode(x[None], ref)
    else:
        # A rate-mode partial-plane payload is zstd-coded, as in the
        # reference; the header then says so.
        partial = bool(hd.flags & tstream.FLAG_BASE_PARTIAL)
        assert hd.entropy == (1 if partial else 2)
        assert hd.temporal == cfg.temporal
    if not (routed or cfg.temporal):
        s_jax = ebcc_tpu.encode(x, ref)
        hj = tstream.split_frame_stream(s_jax)[0]
        assert (hd.flags, hd.entropy, hd.base_cut) == (hj.flags, hj.entropy,
                                                      hj.base_cut)
        assert abs(len(s_port) - len(s_jax)) <= 0.01 * len(s_jax)
    for out in (et.decode(s_port, device="cpu"), ebcc_tpu.decode(s_port)):
        if cfg.residual_mode == ebcc_tpu.RESIDUAL_LOSSLESS:
            np.testing.assert_array_equal(out.view(np.int32),
                                          x.view(np.int32))
        elif cfg.residual_mode == ebcc_tpu.RESIDUAL_NONE:
            assert len(s_port) <= x.nbytes / cfg.base_cr
            assert np.isfinite(out).all()
        else:
            assert np.abs(out - x).max() <= ERROR


@pytest.mark.parametrize("kind", ["ENCODE", "DECODE"])
def test_native_routing(monkeypatch, kind):
    """``EBCC_{ENCODE,DECODE}_BACKEND=native`` routes ``encode`` and
    ``decode`` through the port's copy of the host codec: the routed
    encode writes the JAX package's native encoder's bytes, the routed
    decode gives its native decoder's values, within the bound."""
    from ebcc_tpu import native as jnative
    x = _smooth_frames(n=1)
    ref, cfg = _configs(x.shape)
    blob = et.encode(x, cfg, device="cpu")
    monkeypatch.setenv(f"EBCC_{kind}_BACKEND", "native")
    if kind == "ENCODE":
        routed = et.encode(x, cfg, device="cpu")
        assert routed == jnative.native_encode(x, ref)
        assert np.abs(et.decode(routed, device="cpu") - x).max() <= ERROR
    else:
        out = et.decode(blob, device="cpu")
        np.testing.assert_array_equal(out.reshape(-1),
                                      jnative.native_decode(blob))
        assert out.shape == x.shape and np.abs(out - x).max() <= ERROR


@pytest.mark.parametrize("magic", [b"EBCC", b"EBCK"])
def test_reference_only_streams_raise(magic):
    """The original codec's streams are dispatched on their magic, as the
    reference does, to the port's legacy reader (``ebcc_tpu_torch.compat``;
    whole streams: test_torch_legacy.py), which refuses a malformed one as
    the JAX package's does."""
    from ebcc_tpu.compat import LegacyFormatError as JaxLegacyFormatError
    from ebcc_tpu_torch.compat import LegacyFormatError
    with pytest.raises(LegacyFormatError, match="unsupported"):
        et.decode(magic + bytes(96), device="cpu")
    with pytest.raises(JaxLegacyFormatError, match="unsupported"):
        ebcc_tpu.decode(magic + bytes(96))


@pytest.mark.parametrize("name", list(SHAPES))
def test_libzstd_streams_meet_reference(streams, name, monkeypatch):
    """Without ``zstandard`` (the card's machine) the port codes ZSTD
    payloads through ``libzstd.so.1`` with ``ctypes``: the streams decode
    with the JAX package within the bound, and their size is within 1% of
    the JAX package's stream (zstd versions differ in bytes, not in
    format)."""
    from ebcc_tpu_torch.core import entropy as tentropy
    monkeypatch.setattr(tentropy, "_zstd", None)
    assert tentropy._libzstd is not None
    x, s_jax, _ = streams[name]
    _, cfg = _configs(x.shape)
    s = et.encode(x, cfg, device="cpu")
    assert tstream.split_frame_stream(s)[0].entropy == tentropy.BACKEND_ZSTD
    assert np.abs(ebcc_tpu.decode(s) - x).max() <= ERROR
    assert abs(len(s) - len(s_jax)) <= 0.01 * len(s_jax)
