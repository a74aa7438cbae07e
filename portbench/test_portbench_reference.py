"""The reference decoder against containers the program writes on the CPU
at small shapes, and against broken containers."""

import struct

import numpy as np
import pytest
import torch

import ebcc_tpu_torch as et
from portbench import check, harness, reference, traffic

H, W = 64, 96


def _slab(seed, frames=3):
    return traffic.make_slabs(seed, 1, frames, H, W, "cpu")[0].numpy()


def _config(mode, error, base_cr, frames=3, chunk=(1, H, W)):
    return et.CodecConfig(dims=(frames, H, W), base_cr=base_cr,
                          residual_mode=mode, error=error, chunk_dims=chunk)


CASES = [(et.RESIDUAL_MAX_ERROR, "MAX_ERROR", 0.5, 30),
         (et.RESIDUAL_RELATIVE_ERROR, "RELATIVE_ERROR", 0.01, 200),
         (et.RESIDUAL_MAX_ERROR, "MAX_ERROR", 0.02, 30)]


@pytest.mark.parametrize("mode,name,error,base_cr", CASES)
def test_reference_decodes_program_containers(mode, name, error, base_cr):
    x = _slab(11)
    cfg = _config(mode, error, base_cr)
    blob = et.encode_chunked(x, cfg, device="cpu")
    port = torch.from_numpy(et.decode_chunked(blob, device="cpu"))
    ref, ranges = reference.decode_container(blob)
    assert ref.shape == port.shape == x.shape
    assert check.gap_over_range(port, ref, ranges, (1, H, W)) <= 1e-6
    bound = harness.bound_of(et, cfg)
    assert bound.kind == {"MAX_ERROR": "max_abs",
                          "RELATIVE_ERROR": "chunk_relative"}[name]
    assert check.err_over_bound(ref, torch.from_numpy(x), (1, H, W),
                                bound) <= 1.0


def test_reference_handles_multiframe_and_edge_chunks():
    """Chunks of 2 frames over 3 (an edge chunk padded and cropped)."""
    x = _slab(12)
    cfg = _config(et.RESIDUAL_MAX_ERROR, 0.5, 30, chunk=(2, H, W))
    blob = et.encode_chunked(x, cfg, device="cpu")
    port = torch.from_numpy(et.decode_chunked(blob, device="cpu"))
    ref, ranges = reference.decode_container(blob)
    assert check.gap_over_range(port, ref, ranges, (2, H, W)) <= 1e-6


def test_const_chunk():
    x = np.full((2, H, W), 3.25, np.float32)
    blob = et.encode_chunked(x, _config(et.RESIDUAL_MAX_ERROR, 0.5, 30, 2),
                             device="cpu")
    ref, _ = reference.decode_container(blob)
    assert torch.equal(ref, torch.from_numpy(x))


def _blob():
    return et.encode_chunked(_slab(13, 2), _config(et.RESIDUAL_MAX_ERROR,
                                                   0.5, 30, 2), device="cpu")


def _first_stream_offset():
    return reference.CONTAINER.size + 8


@pytest.mark.parametrize("breakage", [
    "magic", "trailing", "truncated", "stream_flags", "payload_byte",
    "num_chunks"])
def test_broken_containers_raise(breakage):
    b = bytearray(_blob())
    s0 = _first_stream_offset()
    if breakage == "magic":
        b[0:4] = b"EBCK"
    elif breakage == "trailing":
        b += b"\0"
    elif breakage == "truncated":
        b = b[:-1]
    elif breakage == "stream_flags":
        b[s0 + 5] |= 0x10            # temporal: outside the configurations
    elif breakage == "payload_byte":
        b[s0 + reference.FRAME.size + 20] ^= 0xFF   # inside the zstd frame
    elif breakage == "num_chunks":
        struct.pack_into("<Q", b, 64, 3)
    with pytest.raises(ValueError):
        reference.decode_container(bytes(b))


def test_lower_precision_decode_is_far():
    """The control's decode (bfloat16) lies far outside the decoders'
    permitted divergence."""
    blob = _blob()
    ref, ranges = reference.decode_container(blob)
    low, _ = reference.decode_container(blob, dtype=torch.bfloat16)
    assert check.gap_over_range(low, ref, ranges, (1, H, W)) > 100 * \
        check.DECODER_EPS_REL
