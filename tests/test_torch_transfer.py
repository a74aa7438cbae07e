"""The port's host<->device exchange against the JAX package's, on the CPU.

``ebcc_tpu_torch.core.transfer`` against ``ebcc_tpu.core.transfer``: the
host packers and size ladders give the same arrays, the device packers the
same words word for word, the plain unpackers the same (position, value)
pairs, on the same seeded inputs (n in {0, 1, 127, 128, 129, 5000}, at a
small scale and at one that forces every escape).  The port's native Rice
coders invert its device packers.  Through the codec: streams are
byte-identical across the encode forms and decodes bit-equal across the
two upload forms (blocked Rice, index) in MAX_ERROR, rate and temporal
mode, with ``LINK_STATS`` showing the Rice forms moving fewer bytes, and a
decode above the compaction cap taking the index form; the routing
decisions against the JAX package's.  X1's chunked lane offsets equal the
JAX package's.  Cases marked ``cuda`` hold the X1 kernels against their
plain version on the card.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ebcc_tpu.core import routing as jrouting
from ebcc_tpu.core import transfer as jt

import ebcc_tpu_torch as et
from ebcc_tpu_torch import native as tnative
from ebcc_tpu_torch.core import codec as tcodec
from ebcc_tpu_torch.core import routing as trouting
from ebcc_tpu_torch.core import transfer as tt

torch.set_num_threads(2)

NS = [0, 1, 127, 128, 129, 5000]
SCALES = {"small": 300, "escape": 1 << 28}
CASES = [(n, s) for n in NS for s in SCALES]
IDS = [f"n{n}-{s}" for n, s in CASES]
GRID = (2, 2, 1, 64, 64)           # (layers, B, D0, Hp, Wp)
# One capacity for every case (cap >= n; entries past n are masked), so
# the JAX package's programs compile once per variant.
CAP = jt.bucket_count(max(NS))


def pairs(n, scale, space=1 << 24, seed=0):
    """n sorted distinct positions in [0, space) and signed values of
    magnitude 1..scale, from a seed."""
    rng = np.random.default_rng([seed, n, scale])
    idx = np.sort(rng.choice(space, n, replace=False)).astype(np.int64)
    vals = (rng.integers(1, scale + 1, n)
            * rng.choice([-1, 1], n)).astype(np.int32)
    return idx, vals


def grid_values(n, scale):
    """A flat int32 coefficient vector over GRID with min(n, size)
    significant entries, and its packed significance."""
    size = int(np.prod(GRID))
    idx, vals = pairs(min(n, size), scale, space=size)
    flat = np.zeros(size, np.int32)
    flat[idx] = vals
    return flat, np.packbits(flat != 0)


def as_u32(t):
    return t.numpy().view(np.uint32)


def t_of(a):
    """numpy -> tensor, uint16 as its int16 bits (as the codec uploads)."""
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def test_ladders_equal_reference():
    for n in list(range(0, 300)) + list(range(300, 200000, 977)):
        assert tt.bucket_count(n) == jt.bucket_count(n)
        assert tt.rice_block_bucket(n) == jt.rice_block_bucket(n)
    for name in ("RICE_ESC", "RICE_HEADER_WORDS", "RICE_PAIR_HEADER_WORDS",
                 "RICE_NUM_CLASSES", "COMPACT_CAP_LIMIT", "RICE_BLOCK"):
        assert getattr(tt, name) == getattr(jt, name), name


@pytest.mark.parametrize("n,scale", CASES, ids=IDS)
def test_host_packers_equal_reference(n, scale):
    idx, vals = pairs(n, SCALES[scale])
    cap = jt.bucket_count(max(n, 1))
    for a, b in zip(tt.rice_block_pack_host(idx, vals),
                    jt.rice_block_pack_host(idx, vals)):
        np.testing.assert_array_equal(a, b)
    pos = idx[idx < int(np.prod(GRID))].astype(np.int32)
    np.testing.assert_array_equal(tt.pad_index(pos, cap, -1),
                                  jt.pad_index(pos, cap, -1))
    np.testing.assert_array_equal(tt.coeff_class_host(pos, 64, 64),
                                  jt.coeff_class_host(pos, 64, 64))
    word = int(np.random.default_rng(n).integers(0, 1 << 32))
    np.testing.assert_array_equal(tt.unpack_rice_ks(word),
                                  jt.unpack_rice_ks(word))


@pytest.mark.parametrize("n,scale", CASES, ids=IDS)
def test_device_packers_equal_reference(n, scale):
    """rice_pack, rice_pack_pair (classed and not) and
    compact_rice_exchange (classed and not): words and words_needed word
    for word; the packed bitmap."""
    _, vals = pairs(n, SCALES[scale])
    cap = CAP
    v = np.zeros(cap, np.int32)
    v[:n] = vals
    a = np.zeros(cap, np.int32)
    a[:n] = np.abs(vals) // 3
    np.testing.assert_array_equal(
        as_u32(tt.rice_pack(torch.from_numpy(v), n, cap=cap)),
        np.asarray(jt.rice_pack(jnp.asarray(v), np.int32(n), cap=cap)))
    cls = (np.arange(cap) * 7 % 8).astype(np.int32)
    for c in (None, cls):
        tc = None if c is None else torch.from_numpy(c)
        jc = None if c is None else jnp.asarray(c)
        tw, tn = tt.rice_pack_pair(torch.from_numpy(a), torch.from_numpy(v),
                                   n, cap=cap, a_cls=tc, b_cls=tc)
        jw, jn = jt.rice_pack_pair(jnp.asarray(a), jnp.asarray(v),
                                   np.int32(n), cap=cap, a_cls=jc, b_cls=jc)
        np.testing.assert_array_equal(as_u32(tw), np.asarray(jw))
        assert int(tn) == int(jn)

    flat, sig = grid_values(n, SCALES[scale])
    bits = flat.reshape(*GRID[:-1], -1) != 0
    sig_t = tt.pack_bitmap(torch.from_numpy(bits))
    np.testing.assert_array_equal(
        sig_t.numpy(), np.asarray(jt.pack_bitmap(jnp.asarray(bits))))
    np.testing.assert_array_equal(sig_t.numpy().reshape(-1), sig)
    cap2 = CAP
    assert int((flat != 0).sum()) <= cap2
    for hw in (None, GRID[-2:]):
        tw, tn = tt.compact_rice_exchange(torch.from_numpy(flat),
                                          torch.from_numpy(sig), cap=cap2,
                                          hw=hw)
        jw, jn = jt.compact_rice_exchange(jnp.asarray(flat), jnp.asarray(sig),
                                          cap=cap2, hw=hw)
        np.testing.assert_array_equal(as_u32(tw), np.asarray(jw))
        assert int(tn) == int(jn)


@pytest.mark.parametrize("n,scale", CASES, ids=IDS)
def test_native_rice_coders_invert_device_packers(n, scale):
    """The port's C++ Rice readers expand the port's device words; its
    blocked packer writes the numpy twins' arrays (the JAX package's and
    the port's)."""
    idx, vals = pairs(n, SCALES[scale])
    got = tnative.rice_block_pack(idx, vals)
    want = tt.rice_block_pack_host(idx, vals)
    np.testing.assert_array_equal(got[0][:want[0].size], want[0])
    assert not got[0][want[0].size:].any()
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    cap = tt.bucket_count(max(n, 1))
    v = np.zeros(cap, np.int32)
    v[:n] = vals
    words = as_u32(tt.rice_pack(torch.from_numpy(v), n, cap=cap))
    np.testing.assert_array_equal(tnative.rice_decode(words, n), vals)

    flat, sig = grid_values(n, SCALES[scale])
    nnz = int((flat != 0).sum())
    hp, wp = GRID[-2:]
    tw, need = tt.compact_rice_exchange(
        torch.from_numpy(flat), torch.from_numpy(sig),
        cap=tt.bucket_count(max(nnz, 1)), hw=(hp, wp))
    head = as_u32(tw)[:int(need)]
    ga, vb = tt.split_rice_pair(head, nnz)
    pos = tnative.rice_decode_gaps_classed(ga, nnz, hp, wp,
                                           tt.unpack_rice_ks(ga[1]))
    np.testing.assert_array_equal(pos, np.flatnonzero(flat))
    got_v = tnative.rice_decode_classed(
        vb, nnz, tt.coeff_class_host(pos, hp, wp), tt.unpack_rice_ks(vb[1]))
    np.testing.assert_array_equal(got_v, flat[pos])


def _pad(a, n, dtype):
    out = np.zeros(n, dtype)
    out[:a.size] = a
    return out


@pytest.mark.parametrize("n,scale", CASES, ids=IDS)
def test_plain_unpackers_equal_reference(n, scale):
    """rice_block_unpack (the plain twin of X1) against the JAX package's,
    on the padded buffers the codec uploads: it returns the packed
    pairs."""
    idx, vals = pairs(n, SCALES[scale])
    w, lg, lv, kp, bp, nb = jt.rice_block_pack_host(idx, vals)
    nbk, nwk = jt.rice_block_bucket(nb), jt.rice_block_bucket(w.size)
    up = (_pad(w, nwk, np.uint32), _pad(lg, nbk, np.uint16),
          _pad(lv, nbk, np.uint16), _pad(kp, nbk, np.uint8),
          _pad(bp, nbk, np.int32))
    ti, tv = tt.rice_block_unpack(
        torch.from_numpy(up[0].view(np.int32)), *map(t_of, up[1:]), n,
        n_blocks=nbk)
    ji, jv = jax.jit(jt.rice_block_unpack, static_argnames=("n_blocks",))(
        *map(jnp.asarray, up), np.int32(n), n_blocks=nbk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy()[:n], np.asarray(jv)[:n])
    np.testing.assert_array_equal(ti.numpy()[:n], idx)
    np.testing.assert_array_equal(tv.numpy()[:n], vals)


# ---------------------------------------------------------------------------
# Through the codec
# ---------------------------------------------------------------------------

def smooth_frames(n, h=64, w=128, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = [20 * np.sin(yy / 9 + i) * np.cos(xx / 13)
           + 0.3 * rng.normal(size=(h, w)) for i in range(n)]
    return np.stack(out).astype(np.float32)


MODES = {
    "max_error": (dict(residual_mode=et.RESIDUAL_MAX_ERROR, error=0.5), 1),
    "rate": (dict(base_cr=8), 1),
    "temporal": (dict(residual_mode=et.RESIDUAL_MAX_ERROR, error=0.05,
                      temporal=True), 2),
}


def mode_setup(mode):
    kw, t = MODES[mode]
    x = smooth_frames(4).reshape(-1, t, 64, 128)
    cfg = et.CodecConfig(dims=(4, 64, 128), chunk_dims=(t, 64, 128),
                         zstd_level=3, **kw)
    return x, cfg


def link_bytes(fn):
    tt.reset_link_stats()
    out = fn()
    return out, dict(tt.LINK_STATS)


@pytest.fixture(scope="module")
def mode_streams():
    """mode -> (frames, config, default-form streams)."""
    out = {}
    for mode in MODES:
        x, cfg = mode_setup(mode)
        out[mode] = (x, cfg, et.encode_frames_device(x, cfg, max_batch=2,
                                                     device="cpu"))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_encode_forms_byte_identical(monkeypatch, mode_streams, mode):
    """The compact Rice fetch, its hinted single-copy form (a second call
    of the same shape) and the ``torch.nonzero`` fetch (the host library
    taken away) write the same streams; the Rice forms bring fewer bytes
    down."""
    x, cfg, _ = mode_streams[mode]
    tcodec._EXCH_HINTS.clear()
    enc = lambda: et.encode_frames_device(x, cfg, max_batch=2, device="cpu")
    s_rice, l_rice = link_bytes(enc)
    assert tcodec._EXCH_HINTS                 # the second call is hinted
    s_fused, l_fused = link_bytes(enc)
    monkeypatch.setattr(tcodec, "_rice_enabled", lambda: False)
    s_plain, l_plain = link_bytes(enc)
    assert s_rice == s_fused == s_plain == mode_streams[mode][2]
    assert l_rice["up"] == l_fused["up"] == l_plain["up"] == x.nbytes
    assert l_rice["down"] < l_plain["down"]
    assert l_fused["down"] < l_plain["down"]


def uploads_taken(monkeypatch):
    """-> the list that each decode upload's form name is appended to."""
    taken = []

    def spy(form):
        real = getattr(tcodec, f"_upload_{form}")

        def upload(*a):
            taken.append(form)
            return real(*a)
        monkeypatch.setattr(tcodec, f"_upload_{form}", upload)

    spy("rice")
    spy("index")
    return taken


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_forms_bit_equal(monkeypatch, mode_streams, mode):
    """The index upload rebuilds the Rice upload's batch bit for bit, within
    the bound; the Rice form, the one taken below the cap, uploads fewer
    bytes."""
    x, cfg, streams = mode_streams[mode]
    taken = uploads_taken(monkeypatch)
    decode = lambda: et.decode_frames_device(streams, device="cpu")
    got_rice, l_rice = link_bytes(decode)
    assert taken == ["rice"]
    monkeypatch.setattr(tcodec, "_upload_rice", tcodec._upload_index)
    got_index, l_index = link_bytes(decode)
    assert torch.equal(got_rice, got_index)
    assert l_rice["up"] < l_index["up"]
    if cfg.residual_mode != et.RESIDUAL_NONE:
        assert np.abs(got_rice.numpy() - x).max() <= cfg.error


@pytest.mark.parametrize("mode", list(MODES))
def test_above_cap_decode_takes_the_index_form(monkeypatch, mode_streams,
                                              mode):
    """With the compaction cap below a batch's pairs, the decode uploads
    the index form, and its batch equals the Rice decode's bit for bit."""
    x, cfg, streams = mode_streams[mode]
    want = et.decode_frames_device(streams, device="cpu")
    taken = uploads_taken(monkeypatch)
    monkeypatch.setattr(tt, "COMPACT_CAP_LIMIT", tt.bucket_count(1) - 1)
    got = et.decode_frames_device(streams, device="cpu")
    assert taken == ["index"]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", ["", "auto", "native", "host", "device",
                                   "jax", "tpu", "accel", "bogus"])
def test_routing_explicit_equal_reference(monkeypatch, value):
    for kind in ("encode", "decode"):
        monkeypatch.setenv(f"EBCC_{kind.upper()}_BACKEND", value)
        assert trouting.explicit(kind) == jrouting.explicit(kind)


@pytest.mark.parametrize("mbps", ["0.01", "1", "1000000"])
@pytest.mark.parametrize("available", [True, False])
def test_routing_choice_equal_reference(monkeypatch, mbps, available):
    """backend_choice under a forced link rate and a forced availability of
    the host codec decides as the JAX package's does."""
    monkeypatch.setenv("EBCC_LINK_MBPS", mbps)
    for kind in ("encode", "decode"):
        monkeypatch.delenv(f"EBCC_{kind.upper()}_BACKEND", raising=False)
    for mod in (trouting, jrouting):
        monkeypatch.setattr(mod, "_cache", {"native_ok": available})
    for kind in ("encode", "decode"):
        assert (trouting.backend_choice(kind, "cpu")
                == jrouting.backend_choice(kind))
    assert trouting.link_mbps("cpu") == (float(mbps), float(mbps))


def test_new_entry_points_default_to_the_card(monkeypatch):
    for fn in (trouting.link_mbps, trouting.backend_choice):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = smooth_frames(2)
    cfg = et.CodecConfig(dims=(2, 64, 128),
                         residual_mode=et.RESIDUAL_MAX_ERROR, error=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        et.encode(x, cfg, et.EncodeOptions())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    return torch.device("cuda")


def lane_inputs(case):
    """Blocked-Rice upload arrays of an edge case, padded as the codec pads
    them: -> (arrays, nnz, n_blocks, s)."""
    s = 1 << 23
    if case == "escape_every_block":
        idx, vals = pairs(1024, 1 << 28)
        vals[::128] = np.int32(-(1 << 30))
    elif case == "k_clamp":
        idx, vals = pairs(1024, 1 << 14)
        vals[:] = np.int32(1 << 13)           # block means put k at 11
    elif case == "escape_block":
        idx = (np.arange(128, dtype=np.int64) + 1) * 100000
        _, vals = pairs(128, 1 << 30)
        vals = np.where(vals < 0, -1, 1).astype(np.int32) * (1 << 29)
    elif case == "cap":
        s = 4 * 736 * 1440
        idx, vals = pairs(tt.COMPACT_CAP_LIMIT, 3000, space=2 * s)
    else:
        n = {"last_words": 3000, "clipped": 3000, "multiple_of_128": 1024}
        idx, vals = pairs(n.get(case) or int(case), 300)
    w, lg, lv, kp, bp, nb = tnative.rice_block_pack(idx, vals)
    if case == "k_clamp":
        assert ((kp >> 4) == 11).all()
    if case == "escape_block":
        assert lg[0] == lv[0] == 128 * 52
    nbk, nwk = tt.rice_block_bucket(nb), tt.rice_block_bucket(w.size)
    # The stream ends at its last code's 3-word window, or 2 words before
    # it (the windows there clip to nw - 3).
    nwk = {"last_words": w.size, "clipped": w.size - 2}.get(case, nwk)
    up = (_pad(w[:nwk], nwk, np.uint32).view(np.int32),
          _pad(lg, nbk, np.uint16), _pad(lv, nbk, np.uint16),
          _pad(kp, nbk, np.uint8), _pad(bp, nbk, np.int32))
    return up, idx.size, nbk, s


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["0", "1", "127", "128", "129", "5000",
                                  "escape_every_block", "k_clamp",
                                  "last_words", "clipped", "escape_block",
                                  "multiple_of_128", "cap"])
def test_card_rice_lanes_equal_plain(card, case):
    """X1 on the card: qflat bit-equal to the plain version's; one call
    launches the offset scan and the decode (the clearing is a memset)."""
    from ebcc_tpu_torch.ops import exchange_hopper as xh
    up, nnz, nbk, s = lane_inputs(case)
    args = [t_of(a).to(card) for a in up]
    before = xh.cuda_kernels_launched()
    got = xh.rice_unpack_qflat(*args, nnz, n_blocks=nbk, s=s)
    torch.cuda.synchronize()
    assert xh.cuda_kernels_launched() - before == 2
    want = xh.rice_unpack_qflat_plain(*args, nnz, n_blocks=nbk, s=s)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nb", [1, 31, 32, 33, 96, 1000])
def test_chunk_offsets_equal_reference(nb):
    """X1's offset scan (the chunk starts of ``rice_chunk_offsets_plain``,
    then the lengths before a lane in its chunk of 32) gives the JAX
    package's lane offsets (``ebcc_tpu/core/transfer.py:858-861``) and
    ``transfer.rice_lane_offsets``."""
    from ebcc_tpu_torch.ops import exchange_hopper as xh
    rng = np.random.default_rng(nb)
    lg, lv = (rng.integers(0, 1 << 16, nb).astype(np.uint16)
              for _ in range(2))
    co = xh.rice_chunk_offsets_plain(t_of(lg), t_of(lv)).numpy()
    nc, c = -(-nb // 32), np.arange(nb) // 32

    def within(lens):
        x = _pad(lens.astype(np.int64), 32 * nc, np.int64).reshape(nc, 32)
        return (np.cumsum(x, 1) - x).reshape(-1)[:nb]

    got = np.concatenate([co[c] + within(lg),
                          co[2 * nc] + co[nc + c] + within(lv)])
    jg, jv = jnp.asarray(lg).astype(jnp.int32), jnp.asarray(lv).astype(
        jnp.int32)
    cg = jnp.cumsum(jg)
    want = np.concatenate([np.asarray(cg - jg),
                           np.asarray(cg[-1] + jnp.cumsum(jv) - jv)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tt.rice_lane_offsets(t_of(lg), t_of(lv)).numpy())
