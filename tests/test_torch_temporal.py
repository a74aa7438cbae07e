"""The port's temporal mode (closed-loop predictive coding) against the
JAX package's, on the CPU.

On a drifting stack (one crop advected sub-pixel per frame plus a slow
drift), at MAX_ERROR 0.1 and RELATIVE_ERROR 1e-3: every frame of both
packages' streams meets the bound under both decoders; the port's decode
equals, bit for bit, the reconstruction its encoder carried; and the
decisions (frame 0's cuts and flags, every delta's cut and skip) equal the
JAX package's.  Decisions could differ in a few places where XLA's FMA
contraction moves a frame-0 integer by one (ROADMAP Queue 3); on these
fixtures they are equal, so the test asks for equality, and sizes within
1%.  Every port call passes ``device="cpu"`` or a CPU tensor.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ebcc_tpu
from ebcc_tpu.core import stream as jstream
from ebcc_tpu.core.kernels import DECODER_EPS_REL

import ebcc_tpu_torch as et
from ebcc_tpu_torch.core import kernels as tkernels
from ebcc_tpu_torch.core import stream as tstream

torch.set_num_threads(2)

MODES = {"max_error": (ebcc_tpu.RESIDUAL_MAX_ERROR, 0.1),
         "relative": (ebcc_tpu.RESIDUAL_RELATIVE_ERROR, 1e-3)}
SHAPE = (6, 96, 160)


def _subpixel_shift(a, s):
    i = int(np.floor(s))
    f = np.float32(s - i)
    return (1 - f) * np.roll(a, i, axis=1) + f * np.roll(a, i + 1, axis=1)


def _drifting(base, shape=SHAPE, row0=0):
    t, h, w = shape
    crop = base[row0:row0 + h, :w]
    return np.stack([_subpixel_shift(crop, 0.7 * k) + 0.12 * k
                     for k in range(t)]).astype(np.float32)


def _configs(shape, mode="max_error", **kw):
    rmode, err = MODES[mode]
    kw = dict(dict(residual_mode=rmode, error=err), **kw)
    ref = ebcc_tpu.CodecConfig(dims=shape, temporal=True, zstd_level=3,
                               **kw)
    return ref, et.config_from_reference(dataclasses.asdict(ref))


def _bound(mode, x):
    rmode, err = MODES[mode]
    if rmode == ebcc_tpu.RESIDUAL_RELATIVE_ERROR:
        return err * float(x.max() - x.min())
    return err


@pytest.fixture(scope="module")
def stack(base_test_data):
    return _drifting(base_test_data)


@pytest.fixture(scope="module")
def streams(stack):
    """mode -> (JAX stream, port stream)."""
    out = {}
    for mode in MODES:
        ref_cfg, cfg = _configs(stack.shape, mode)
        out[mode] = (ebcc_tpu.encode(stack, ref_cfg),
                     et.encode(stack, cfg, device="cpu"))
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("which", ["jax_stream", "port_stream"])
@pytest.mark.parametrize("decoder", ["jax", "port"])
def test_bound_on_every_frame(stack, streams, mode, which, decoder):
    s = streams[mode][0 if which == "jax_stream" else 1]
    hd = tstream.split_frame_stream(s)[0]
    assert hd.temporal and hd.n_frames == stack.shape[0]
    out = (ebcc_tpu.decode(s) if decoder == "jax"
           else et.decode(s, device="cpu"))
    assert out.shape == stack.shape and out.dtype == np.float32
    per_frame = np.abs(out - stack).max(axis=(1, 2))
    assert (per_frame <= _bound(mode, stack)).all(), per_frame


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_equals_the_encoders_carry(stack, streams, mode):
    rmode, err = MODES[mode]
    out = tkernels.encode_batch_temporal(
        torch.from_numpy(stack[None]), err, 1.0 - 1e-6,
        relative_mode=rmode == ebcc_tpu.RESIDUAL_RELATIVE_ERROR,
        return_carry=True)
    dec = et.decode(streams[mode][1], device="cpu")
    np.testing.assert_array_equal(out["_carry"][0].numpy(), dec)


def _decisions(s):
    hd = tstream.split_frame_stream(s)[0]
    records, _ = tstream.split_temporal_section(s, hd)
    return ((hd.flags, hd.base_cut, hd.res_cut),
            [(r.cut, r.comp_size == 0 and r.rmin == r.rmax == 0.0)
             for r in records])


@pytest.mark.parametrize("mode", list(MODES))
def test_decisions_match_jax(streams, mode):
    s_jax, s_port = streams[mode]
    assert _decisions(s_port) == _decisions(s_jax)
    assert abs(len(s_port) - len(s_jax)) <= 0.01 * len(s_jax)


@pytest.mark.parametrize("mode", list(MODES))
def test_decoders_agree(stack, streams, mode):
    """The two decoders' frames of one stream differ by at most the
    allowance the encoder budgets for a T-frame chain, 2 T DECODER_EPS_REL
    times the chunk range."""
    for s in streams[mode]:
        diff = np.abs(et.decode(s, device="cpu") - ebcc_tpu.decode(s))
        rng = float(stack.max() - stack.min())
        assert diff.max() <= 2 * stack.shape[0] * DECODER_EPS_REL * rng


def test_static_frames_ship_skips(base_test_data):
    frame = np.ascontiguousarray(base_test_data[:96, :160])
    frames = np.repeat(frame[None], 5, axis=0)
    _, cfg = _configs(frames.shape)
    blob = et.encode(frames, cfg, device="cpu")
    hd = tstream.split_frame_stream(blob)[0]
    records, _ = tstream.split_temporal_section(blob, hd)
    assert all(r.comp_size == 0 and r.rmin == 0.0 and r.rmax == 0.0
               for r in records)
    _, one = _configs((1, 96, 160))
    assert len(blob) <= (len(et.encode(frame[None], one, device="cpu"))
                         + 4 * tstream.DELTA_RECORD_SIZE)
    for out in (et.decode(blob, device="cpu"), ebcc_tpu.decode(blob)):
        assert np.abs(out - frames).max() <= 0.1


def test_constant_chunk():
    frames = np.full((4, 64, 64), 2.5, np.float32)
    _, cfg = _configs(frames.shape, error=0.01)
    blob = et.encode(frames, cfg, device="cpu")
    hd = tstream.split_frame_stream(blob)[0]
    assert hd.const_field and not hd.temporal
    np.testing.assert_array_equal(et.decode(blob, device="cpu"), frames)
    np.testing.assert_array_equal(ebcc_tpu.decode(blob), frames)


def test_flat_first_frame_keeps_its_deltas(base_test_data):
    """A flat frame 0 in a live chunk: the stream stays temporal, frame 0
    decodes to its value and the deltas apply.  With FLAG_CONST set as
    well (as other encoders write such a chunk) both decoders still apply
    the deltas: only a stream that is const and not temporal is filled."""
    frames = _drifting(base_test_data, (3, 64, 96))
    frames[0] = 250.0
    _, cfg = _configs(frames.shape)
    blob = et.encode(frames, cfg, device="cpu")
    hd = tstream.split_frame_stream(blob)[0]
    assert hd.temporal and not hd.const_field
    const_blob = tstream.set_flag(blob, tstream.FLAG_CONST)
    want = et.decode(blob, device="cpu")
    assert np.abs(want - frames).max() <= 0.1
    np.testing.assert_array_equal(et.decode(const_blob, device="cpu"), want)
    for s in (blob, const_blob):
        assert np.abs(ebcc_tpu.decode(s) - frames).max() <= 0.1


def test_one_frame_chunk_falls_back_to_intra(base_test_data):
    data = np.ascontiguousarray(base_test_data[:96, :160][None])
    _, cfg_t = _configs(data.shape)
    cfg_i = dataclasses.replace(cfg_t, temporal=False)
    assert et.encode(data, cfg_t, device="cpu") == et.encode(
        data, cfg_i, device="cpu")


def test_chunk_alone_equals_chunk_in_batch(base_test_data):
    """Three chunks of four frames: each chunk's stream is the same
    whether encoded alone or in the batch, in sub-batches of 2, or through
    roundtrip_frames_device, whose decode equals decode_frames_device's."""
    xb = np.stack([_drifting(base_test_data, (4, 64, 96), row0=30 * i)
                   for i in range(3)])
    _, cfg = _configs((12, 64, 96), chunk_dims=(4, 64, 96))
    _, one = _configs((4, 64, 96))
    x = torch.from_numpy(xb)
    batch = et.encode_frames_device(x, cfg)
    assert batch == [et.encode(c, one, device="cpu") for c in xb]
    assert et.encode_frames_device(x, cfg, max_batch=2) == batch
    got, dec = et.roundtrip_frames_device(x, cfg, max_batch=2)
    assert got == batch
    assert torch.equal(dec, et.decode_frames_device(got, device="cpu"))
    assert float((dec - x).abs().max()) <= 0.1


def test_truncated_delta_section_raises(streams):
    blob = streams["max_error"][1]
    hd = tstream.split_frame_stream(blob)[0]
    records_at = (tstream.FRAME_HEADER_SIZE + hd.base_comp_size
                  + hd.res_comp_size)
    for bad in (blob[:-1], blob + b"x",
                blob[:records_at + tstream.DELTA_RECORD_SIZE]):
        with pytest.raises(tstream.StreamError):
            et.decode(bad, device="cpu")


def test_allow_nan(base_test_data):
    """A temporal stream with a mask section round-trips its NaNs under
    both decoders; the bound holds on the valid samples of every frame."""
    frames = _drifting(base_test_data, (4, 64, 96))
    frames[1:, 10:20, 30:50] = np.nan
    _, cfg = _configs(frames.shape, allow_nan=True)
    blob = et.encode(frames, cfg, device="cpu")
    hd = tstream.split_frame_stream(blob)[0]
    assert hd.temporal and hd.masked
    valid = ~np.isnan(frames)
    for out in (et.decode(blob, device="cpu"), ebcc_tpu.decode(blob)):
        np.testing.assert_array_equal(np.isnan(out), ~valid)
        assert np.abs(out[valid] - frames[valid]).max() <= 0.1


def test_pointwise_relative(base_test_data):
    """Log-domain temporal coding: |x^/x - 1| <= error on every sample of
    every frame, under both decoders."""
    frames = _drifting(base_test_data, (4, 64, 96))
    _, cfg = _configs(frames.shape, residual_mode=ebcc_tpu.
                      RESIDUAL_POINTWISE_RELATIVE_ERROR, error=1e-3)
    blob = et.encode(frames, cfg, device="cpu")
    hd = tstream.split_frame_stream(blob)[0]
    assert hd.temporal and hd.log_domain
    for out in (et.decode(blob, device="cpu"), ebcc_tpu.decode(blob)):
        assert np.abs(out / frames - 1).max() <= 1e-3


def test_large_deltas_take_the_int32_upload(base_test_data):
    """Deltas far larger than the target (the adaptive scale's regime):
    kept values beyond int16, and the bound holds under both decoders."""
    crop = base_test_data[:64, :96]
    frames = np.stack([crop + 50.0 * k for k in range(4)])
    frames += (np.linspace(0, 1, 64 * 96, dtype=np.float32).reshape(
        1, 64, 96) * np.arange(4, dtype=np.float32)[:, None, None])
    _, cfg = _configs(frames.shape, error=0.01)
    out = tkernels.encode_batch_temporal(
        torch.from_numpy(frames[None]), 0.01, 1.0 - 1e-6)
    assert int(out["vals_comb"].abs().max()) >= 1 << 15
    blob = et.encode(frames, cfg, device="cpu")
    for dec in (et.decode(blob, device="cpu"), ebcc_tpu.decode(blob)):
        assert np.abs(dec - frames).max() <= 0.01


def test_mixed_temporal_and_intra_batch_raises(base_test_data):
    frames = _drifting(base_test_data, (2, 64, 96))
    _, cfg = _configs(frames.shape)
    temporal = et.encode(frames, cfg, device="cpu")
    intra = et.encode(frames, dataclasses.replace(cfg, temporal=False),
                      device="cpu")
    with pytest.raises(tstream.StreamError, match="temporal"):
        et.decode_frames_device([temporal, intra], device="cpu")


def test_delta_record_bytes_match_jax():
    kw = dict(rmin=-0.125, rmax=2.5, cut=7, top=3, entropy=1, comp_size=99)
    assert (tstream.DeltaRecord(**kw).pack()
            == jstream.DeltaRecord(**kw).pack())
