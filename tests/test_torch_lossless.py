"""The port's lossless mode (RESIDUAL_LOSSLESS) against the JAX package's,
on the CPU.

Lossless streams are host work in both packages, so the port's streams
must be byte-identical to the JAX package's, for one-frame chunks
(predictor id 2) and multi-frame chunks (id 3, a frame-axis difference
first, wins on a correlated stack).  Both decoders return the input's bits
exactly, NaN payloads, +-Inf and -0.0 included; ids 0 and 1 are refused.
Every port call passes ``device="cpu"`` or a CPU tensor.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ebcc_tpu

import ebcc_tpu_torch as et
from ebcc_tpu_torch.core import stream as tstream

torch.set_num_threads(2)

SHAPES = {"one_frame": (1, 96, 160), "three_frames": (3, 96, 160)}
# Offset of the header's base_levels byte (the predictor id).
_PREDICTOR_BYTE = 40


def _data(base, shape):
    """A correlated stack (frame i is one crop moved up by i times a smooth
    field of ulps) with NaN (two payloads), +-Inf, -0.0 and a denormal
    planted in frame 0."""
    n, h, w = shape
    crop = np.ascontiguousarray(base[:h, :w], np.float32).view(np.uint32)
    yy, xx = np.mgrid[0:h, 0:w]
    drift = (40 * (1 + np.sin(xx / 9)) * (1 + np.cos(yy / 7))).astype(
        np.uint32)
    x = np.stack([crop + np.uint32(i) * drift for i in range(n)]).view(
        np.float32)
    bits = x.view(np.uint32)
    bits[0, 1, 2] = 0x7FC00001          # quiet NaN with a payload
    bits[0, 3, 4] = 0xFFA00000          # negative NaN
    x[0, 5, 6] = np.inf
    x[0, 7, 8] = -np.inf
    x[0, 9, 10] = -0.0
    bits[0, 11, 12] = 0x00000003        # denormal
    return x


def _configs(shape, **kw):
    ref = ebcc_tpu.CodecConfig(dims=shape, residual_mode=ebcc_tpu.
                               RESIDUAL_LOSSLESS, zstd_level=3, **kw)
    return ref, et.config_from_reference(dataclasses.asdict(ref))


def _assert_bits(got, want):
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


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
def test_streams_byte_identical_to_jax(streams, name):
    x, s_jax, s_port = streams[name]
    assert s_port == s_jax
    hd = tstream.split_frame_stream(s_port)[0]
    assert hd.lossless and hd.n_frames == x.shape[0]
    assert hd.base_levels == (2 if x.shape[0] == 1 else 3)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_cross_package_decode_bit_exact(streams, name, direction):
    x, s_jax, s_port = streams[name]
    out = (ebcc_tpu.decode(s_port) if direction == "port_to_jax"
           else et.decode(s_jax, device="cpu"))
    _assert_bits(out, x)


@pytest.mark.parametrize("seed", [0, 1])
def test_every_bit_pattern_round_trips(seed):
    """Random uint32 words as float32 (NaNs of every payload, Infs,
    denormals, both zeros): the port's stream equals the JAX package's and
    both decoders give the words back."""
    words = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(2, 64, 96), dtype=np.uint64).astype(np.uint32)
    x = words.view(np.float32)
    ref_cfg, cfg = _configs(x.shape)
    blob = et.encode(x, cfg, device="cpu")
    assert blob == ebcc_tpu.encode(x, ref_cfg)
    _assert_bits(et.decode(blob, device="cpu"), x)
    _assert_bits(ebcc_tpu.decode(blob), x)


@pytest.mark.parametrize("pid", [0, 1])
def test_interim_predictor_ids_refused(streams, pid):
    bad = bytearray(streams["one_frame"][2])
    bad[_PREDICTOR_BYTE] = pid
    with pytest.raises(tstream.StreamError, match="predictor"):
        et.decode(bytes(bad), device="cpu")


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_device_entry_points(streams, kind):
    """A batch of three chunks through encode_frames_device (sub-batches of
    2), roundtrip_frames_device and decode_frames_device: the streams of
    one-chunk encodes, bit-exact output on the input's device."""
    x, _, _ = streams["three_frames"]
    xb = np.stack([x, x[::-1], x[:, :, ::-1]])     # (3, 3, 96, 160)
    _, cfg = _configs(x.shape)
    want = [et.encode(c, cfg, device="cpu") for c in xb]
    inp = torch.from_numpy(xb) if kind == "tensor" else xb
    assert et.encode_frames_device(inp, cfg, max_batch=2,
                                   device="cpu") == want
    got, dec = et.roundtrip_frames_device(inp, cfg, max_batch=2,
                                          device="cpu")
    assert got == want
    assert dec.device.type == "cpu"
    _assert_bits(dec.numpy(), xb)
    dec2 = et.decode_frames_device(got, max_batch=2, device="cpu")
    _assert_bits(dec2.numpy(), xb)


def test_mixed_lossless_and_lossy_batch_raises(streams, base_test_data):
    x = np.ascontiguousarray(base_test_data[:64, :64][None])
    lossy = et.encode(x, et.CodecConfig(
        dims=x.shape, residual_mode=et.RESIDUAL_MAX_ERROR, error=0.5,
        zstd_level=3), device="cpu")
    lossless = streams["one_frame"][2]
    for batch in ([lossless, lossy], [lossy, lossless]):
        with pytest.raises(tstream.StreamError):
            et.decode_frames_device(batch, device="cpu")


def test_truncated_stream_raises(streams):
    blob = streams["three_frames"][2]
    for bad in (blob[:-1], blob + b"x", blob[:60]):
        with pytest.raises(tstream.StreamError):
            et.decode(bad, device="cpu")


def test_default_device_is_the_card(monkeypatch, streams):
    """Lossless work runs on the host, but the entry points still take the
    card by default and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _, blob = streams["one_frame"]
    _, cfg = _configs(x.shape)
    with pytest.raises(RuntimeError, match="CUDA"):
        et.encode(x, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        et.decode(blob)
    with pytest.raises(RuntimeError, match="CUDA"):
        et.encode_frames_device(x[None], cfg)
