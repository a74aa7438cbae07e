"""The port's rate mode (RESIDUAL_NONE, the config's default) against the
JAX package's, on the CPU.

The host picks each chunk's cut from real zstd sizes and fills the rest of
the ``base_cr`` budget with a prefix of the next plane
(FLAG_BASE_PARTIAL).  At base_cr 10, 30 and 100 on one frame, and at 30
on a three-frame chunk, the port makes the JAX package's cut and flags,
a stream within the budget and at least 90% of it, and a size within 1%
of the JAX stream's.  The same stream decodes to within
``DECODER_EPS_REL`` of the chunk range under both decoders.  Every port
call passes ``device="cpu"`` or a CPU tensor.
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

CASES = {"frame_cr10": ((1, 96, 160), 10), "frame_cr30": ((1, 96, 160), 30),
         "frame_cr100": ((1, 96, 160), 100),
         "three_frames_cr30": ((3, 96, 128), 30)}
# The offset of the header's base-layer entropy byte.
_ENTROPY_BYTE = 6


def _data(base, shape):
    n, h, w = shape
    frames = [base[40 * i:40 * i + h, 300 + 50 * i:300 + 50 * i + w]
              for i in range(n)]
    return np.ascontiguousarray(np.stack(frames).astype(np.float32))


def _configs(shape, base_cr, **kw):
    ref = ebcc_tpu.CodecConfig(dims=shape, base_cr=base_cr, zstd_level=3,
                               **kw)
    assert ref.residual_mode == ebcc_tpu.RESIDUAL_NONE
    return ref, et.config_from_reference(dataclasses.asdict(ref))


@pytest.fixture(scope="module")
def streams(base_test_data):
    """name -> (data, JAX stream, port stream)."""
    out = {}
    for name, (shape, cr) in CASES.items():
        x = _data(base_test_data, shape)
        ref_cfg, cfg = _configs(shape, cr)
        out[name] = (x, ebcc_tpu.encode(x, ref_cfg),
                     et.encode(x, cfg, device="cpu"))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_same_cut_and_flags_as_jax(streams, name):
    _, s_jax, s_port = streams[name]
    hj = tstream.split_frame_stream(s_jax)[0]
    hp = tstream.split_frame_stream(s_port)[0]
    assert (hp.flags, hp.base_cut, hp.base_top) == (hj.flags, hj.base_cut,
                                                      hj.base_top)
    assert not hp.has_residual and hp.entropy == hj.entropy


@pytest.mark.parametrize("name", list(CASES))
def test_size_fills_the_budget(streams, name):
    """The stream is at most raw bytes / base_cr and at least 90% of that,
    and within 1% of the JAX package's."""
    x, s_jax, s_port = streams[name]
    limit = x.size * 4 / CASES[name][1]
    assert 0.90 * limit <= len(s_port) <= limit
    assert abs(len(s_port) - len(s_jax)) <= 0.01 * len(s_jax)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("which", ["jax_stream", "port_stream"])
def test_decoders_agree(streams, name, which):
    """Each package's stream decodes under both decoders to within
    DECODER_EPS_REL of the chunk range of each other."""
    x, s_jax, s_port = streams[name]
    s = s_jax if which == "jax_stream" else s_port
    ours = et.decode(s, device="cpu")
    ref = ebcc_tpu.decode(s)
    assert ours.shape == x.shape and ours.dtype == np.float32
    rng = float(x.max() - x.min())
    assert np.abs(ours - ref).max() <= DECODER_EPS_REL * rng


def test_partial_plane_is_used(streams):
    """At every budget here the byte-granular fill beats the full-plane
    payload: the flag is set."""
    for name in CASES:
        hd = tstream.split_frame_stream(streams[name][2])[0]
        assert hd.flags & tstream.FLAG_BASE_PARTIAL, name


def test_rmse_falls_as_rate_rises(streams):
    x = streams["frame_cr10"][0]
    rmse = [float(np.sqrt(np.mean(
        (et.decode(streams[f"frame_cr{cr}"][2], device="cpu") - x) ** 2)))
        for cr in (10, 30, 100)]
    assert rmse[0] < rmse[1] < rmse[2], rmse


def test_constant_chunk():
    x = np.full((2, 64, 64), -7.5, np.float32)
    _, cfg = _configs(x.shape, 30)
    blob = et.encode(x, cfg, device="cpu")
    assert tstream.split_frame_stream(blob)[0].const_field
    np.testing.assert_array_equal(et.decode(blob, device="cpu"), x)
    np.testing.assert_array_equal(ebcc_tpu.decode(blob), x)


def test_device_entry_points(base_test_data):
    """Three chunks through encode_frames_device (sub-batches of 2),
    roundtrip_frames_device and decode_frames_device: the streams of
    one-chunk encodes, whatever the partitioning, and decodes equal to
    decode()'s."""
    xb = np.stack([_data(base_test_data[10 * i:], (1, 96, 160))
                   for i in range(3)])                  # (3, 1, 96, 160)
    _, cfg = _configs((3, 96, 160), 30, chunk_dims=(1, 96, 160))
    _, one = _configs((1, 96, 160), 30)
    want = [et.encode(c, one, device="cpu") for c in xb]
    x = torch.from_numpy(xb)
    assert et.encode_frames_device(x, cfg, max_batch=2) == want
    got, dec = et.roundtrip_frames_device(x, cfg, max_batch=2)
    assert got == want
    dec2 = et.decode_frames_device(got, max_batch=2, device="cpu")
    assert torch.equal(dec, dec2)
    for s, d in zip(got, dec):
        np.testing.assert_array_equal(et.decode(s, device="cpu"),
                                      d.numpy())


def test_allow_nan(base_test_data):
    """A masked chunk in rate mode: the NaNs come back under both
    decoders, the budget counts the payload only."""
    x = _data(base_test_data, (1, 96, 160))
    x[0, 20:40, 30:90] = np.nan
    ref_cfg, cfg = _configs(x.shape, 30, allow_nan=True)
    blob = et.encode(x, cfg, device="cpu")
    hd = tstream.split_frame_stream(blob)[0]
    assert hd.masked
    for out in (et.decode(blob, device="cpu"), ebcc_tpu.decode(blob)):
        np.testing.assert_array_equal(np.isnan(out), np.isnan(x))
    hj = tstream.split_frame_stream(ebcc_tpu.encode(x, ref_cfg))[0]
    assert (hd.flags, hd.base_cut) == (hj.flags, hj.base_cut)


def test_partial_payload_with_cab_backend_refused(streams):
    """A FLAG_BASE_PARTIAL payload is only ever zstd or store: a stream
    that says CAB is refused before any decoding."""
    bad = bytearray(streams["frame_cr30"][2])
    bad[_ENTROPY_BYTE] = 2
    with pytest.raises(tstream.StreamError, match="partial"):
        et.decode(bytes(bad), device="cpu")


def test_truncated_partial_payload_raises(streams):
    blob = streams["frame_cr30"][2]
    for bad in (blob[:-1], blob + b"x"):
        with pytest.raises(tstream.StreamError):
            et.decode(bad, device="cpu")


@pytest.mark.parametrize("base_cr", [4, 30])
def test_store_payloads(monkeypatch, base_cr, base_test_data):
    """With no zstd binding (neither zstandard nor libzstd.so.1) the
    payloads are STORE: the budget holds (at base_cr 30 it takes less than
    one plane, at 4 several), and both decoders agree on the stream."""
    from ebcc_tpu_torch.core import entropy as tentropy
    monkeypatch.setattr(tentropy, "_zstd", None)
    monkeypatch.setattr(tentropy, "_libzstd", None)
    x = _data(base_test_data, (1, 96, 160))
    _, cfg = _configs(x.shape, base_cr)
    blob = et.encode(x, cfg, device="cpu")
    hd = tstream.split_frame_stream(blob)[0]
    assert hd.entropy == tentropy.BACKEND_STORE
    assert len(blob) <= x.size * 4 / base_cr
    ours = et.decode(blob, device="cpu")
    rng = float(x.max() - x.min())
    assert np.abs(ours - ebcc_tpu.decode(blob)).max() <= DECODER_EPS_REL * rng
