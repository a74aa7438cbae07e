"""The port's fused wavelet wrappers (``ebcc_tpu_torch.ops.dwt_hopper``)
against the JAX package's (``ebcc_tpu.ops.dwt_pallas``).

On the CPU both take their plain paths: the port's plain PyTorch version and
the JAX package's XLA path, which its docstring states is bit-exact with the
Pallas kernels on the TPU (``dwt_pallas.py:315-322``).  Integer outputs may
differ only at truncation boundaries (a float coefficient a rounding away
from an integer): the mismatches are counted, must stay under 1e-4 of the
coefficients, and none may exceed 1.  The inputs are at their natural scale:
XLA's CPU code contracts the lifting multiply-adds into FMAs where the port
rounds each op, and at the base layer's [0, 65535] scale that moves about
0.5% of the truncated integers by one.  Float outputs agree to
``1e-5 * max|x|``.  The CUDA kernels themselves are compared with the plain
versions by the ``cuda``-marked test, which skips without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ebcc_tpu.ops import dwt as jdwt
from ebcc_tpu.ops import dwt_pallas as jp

from ebcc_tpu_torch.ops import dwt as tdwt
from ebcc_tpu_torch.ops import dwt_hopper as th

torch.set_num_threads(2)


def _inputs(kind, fixture):
    """Random data or fixture crops at their natural scale."""
    if kind == "random":
        x = np.random.default_rng(1).normal(size=(2, 1, 96, 128)) * 100.0
        return x.astype(np.float32)
    crops = [fixture[:128, :256], fixture[300:428, 1000:1256]]
    return np.stack(crops)[:, None].astype(np.float32)


def _assert_ints_close(got, ref, coeffs=None, tol=None):
    """Integers equal except at truncation boundaries: few mismatches,
    none above 1, and (given the float coefficients) each mismatch within
    ``tol`` of an integer."""
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    mis = diff > 0
    assert int(mis.sum()) <= 1e-4 * ref.size
    assert int(diff.max()) <= 1
    if coeffs is not None and mis.any():
        near = np.abs(coeffs[mis] - np.round(coeffs[mis]))
        assert near.max() <= tol


@pytest.mark.parametrize("kind", ["random", "fixture"])
@pytest.mark.parametrize("levels", [3, 5])
def test_dwt2d_quantize_plain_matches_jax(kind, levels, base_test_data):
    x = _inputs(kind, base_test_data)
    ref = np.asarray(jp.dwt2d_quantize(jnp.asarray(x), levels))
    got = th.dwt2d_quantize(torch.from_numpy(x), levels)
    assert got.dtype == torch.int32 and got.shape == x.shape
    coeffs = np.asarray(jdwt.dwt2d(jnp.asarray(x), levels))
    _assert_ints_close(got.numpy(), ref, coeffs, 1e-5 * np.abs(x).max())


@pytest.mark.parametrize("kind", ["random", "fixture"])
@pytest.mark.parametrize("levels", [3, 5])
def test_idwt2d_dequant_plain_matches_jax(kind, levels, base_test_data):
    x = _inputs(kind, base_test_data)
    q = np.asarray(jp.dwt2d_quantize(jnp.asarray(x), levels))
    cut = np.array([levels + 2, 0], np.int32)
    ref = np.asarray(jp.idwt2d_dequant(jnp.asarray(q), jnp.asarray(cut),
                                       levels))
    got = th.idwt2d_dequant(torch.from_numpy(q), torch.from_numpy(cut),
                            levels).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(x).max()
    # A scalar cut broadcasts over the batch, as in the reference.
    got_s = th.idwt2d_dequant(torch.from_numpy(q), 3, levels).numpy()
    ref_s = np.asarray(jp.idwt2d_dequant(jnp.asarray(q), 3, levels))
    assert np.abs(got_s - ref_s).max() <= 1e-5 * np.abs(x).max()


TALL_NARROW = [((1, 1, 1856, 64), 5), ((2, 1, 1824, 32), 3)]


def _tall(shape):
    return (np.random.default_rng(4).normal(size=shape) * 100.0).astype(
        np.float32)


@pytest.mark.parametrize("shape,levels", TALL_NARROW)
def test_tall_frame_quantize_plain_matches_jax(shape, levels):
    """A padded height above 1816 rows (the port's old column-pass limit),
    on a narrow frame: the plain forward against the XLA path."""
    x = _tall(shape)
    ref = np.asarray(jp.dwt2d_quantize(jnp.asarray(x), levels))
    got = th.dwt2d_quantize(torch.from_numpy(x), levels)
    coeffs = np.asarray(jdwt.dwt2d(jnp.asarray(x), levels))
    _assert_ints_close(got.numpy(), ref, coeffs, 1e-5 * np.abs(x).max())


@pytest.mark.parametrize("shape,levels", TALL_NARROW)
def test_tall_frame_dequant_plain_matches_jax(shape, levels):
    x = _tall(shape)
    q = np.asarray(jp.dwt2d_quantize(jnp.asarray(x), levels))
    cut = np.arange(shape[0], dtype=np.int32) + 2
    ref = np.asarray(jp.idwt2d_dequant(jnp.asarray(q), jnp.asarray(cut),
                                       levels))
    got = th.idwt2d_dequant(torch.from_numpy(q), torch.from_numpy(cut),
                            levels).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(x).max()


def test_dwt2d_transform_plain_is_the_plain_dwt():
    x = np.random.default_rng(2).normal(size=(1, 2, 64, 96)).astype(
        np.float32)
    got = th.dwt2d_transform(torch.from_numpy(x), 3)
    torch.testing.assert_close(got, tdwt.dwt2d(torch.from_numpy(x), 3),
                               rtol=0, atol=0)


def test_cpu_tensors_do_not_count_as_kernel_launches():
    th.reset_launch_counts()
    x = torch.zeros(1, 1, 64, 64)
    q = th.dwt2d_quantize(x, 3)
    th.dwt2d_transform(x, 3)
    th.idwt2d_dequant(q, 0, 3)
    one = torch.ones(1)
    th.curve_stats(q, x, one, one, one, levels=3, cut_grid=(3, 0),
                   valid_hw=(60, 60))
    assert th.launch_counts() == {"dwt2d_quantize": 0, "dwt2d_transform": 0,
                                  "idwt2d_dequant": 0, "curve_stats": 0}


def _curve_inputs(shape):
    """The inputs of ``tests/test_dwt.py``'s K3 contract test."""
    rng = np.random.default_rng(3)
    b = shape[0]
    q = rng.integers(-5000, 5000, size=shape).astype(np.int32)
    t = rng.normal(size=shape).astype(np.float32) * 50
    scale = rng.uniform(0.5, 2.0, b).astype(np.float32)
    off = rng.uniform(-3, 3, b).astype(np.float32)
    target = rng.uniform(5, 40, b).astype(np.float32)
    return q, t, scale, off, target


RES_CUTS = tuple(range(12, -1, -3))          # 12, 9, 6, 3, 0
BASE_CUTS = tuple(range(21, -1, -3))         # 21, 18, ..., 3, 0
UNORDERED_CUTS = (0, 6, 6, 12)


@pytest.mark.parametrize("shape,levels,hw,cuts", [
    pytest.param((2, 1, 64, 64), 3, (50, 60), RES_CUTS, id="shape0-3-hw0"),
    pytest.param((1, 2, 32, 64), 2, (32, 64), RES_CUTS, id="shape1-2-hw1"),
    pytest.param((2, 1, 64, 64), 3, (50, 60), (7,), id="one-cut"),
    pytest.param((2, 1, 64, 64), 3, (50, 60), tuple(range(12, -1, -1)),
                 id="every-residual-plane"),
    pytest.param((1, 2, 32, 64), 2, (32, 64), UNORDERED_CUTS,
                 id="unordered-with-repeat"),
    pytest.param((1, 1, 64, 96), 5, (60, 90), BASE_CUTS, id="base-grid-L5"),
])
def test_curve_stats_plain_matches_pallas_interpret(shape, levels, hw, cuts):
    """K3's plain version against ``curve_stats_pallas`` run in interpret
    mode, at the shapes of ``tests/test_dwt.py`` and the grids the kernel
    must take: one cut, every residual plane, a grid in no order with a
    repeated cut, the base call's grid at 5 levels.  Tolerance ``tol`` is the
    one this file holds K2 to, ``1e-5`` of the largest reconstruction
    magnitude (XLA contracts the lifting multiply-adds into FMAs): max and
    min agree within ``tol``; counts are equal except for samples whose
    |err| lies within ``tol`` of the target; the Pallas kernel sums in
    float32, so sums agree within ``tol`` times the sample count plus
    ``1e-5`` of the sum of |err|."""
    q, t, scale, off, target = _curve_inputs(shape)
    ref = np.asarray(jp.curve_stats_pallas(
        jnp.asarray(q), jnp.asarray(t), scale, off, target, levels=levels,
        cut_grid=cuts, valid_hw=hw, interpret=True))
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    ts, to, tg = (torch.from_numpy(v) for v in (scale, off, target))
    got = th.curve_stats(tq, tt, ts, to, tg, levels=levels, cut_grid=cuts,
                         valid_hw=hw)
    assert got.dtype == torch.float64
    assert got.shape == (len(cuts),) + shape[:2] + (4,)
    got = got.numpy()
    h, w = hw
    b4 = lambda v: v[:, None, None, None]
    for k, cut in enumerate(cuts):
        rec = th.idwt2d_dequant_plain(tq, cut, levels)[..., :h, :w]
        err = (tt[..., :h, :w] - (rec * b4(ts) + b4(to))).numpy()
        tol = 1e-5 * np.abs((rec * b4(ts)).numpy()).max()
        np.testing.assert_allclose(got[k, ..., 1], ref[k, ..., 1], rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(got[k, ..., 2], ref[k, ..., 2], rtol=0,
                                   atol=tol)
        near = (np.abs(np.abs(err) - target[:, None, None, None])
                <= tol).sum(axis=(2, 3))
        assert np.all(np.abs(got[k, ..., 3] - ref[k, ..., 3]) <= near)
        abs_sum = np.abs(err).sum(axis=(2, 3), dtype=np.float64)
        assert np.all(np.abs(got[k, ..., 0] - ref[k, ..., 0])
                      <= tol * h * w + 1e-5 * abs_sum)


@pytest.mark.parametrize("levels", [3, 5])
@pytest.mark.parametrize("cuts", [RES_CUTS, UNORDERED_CUTS, (21, 0, 21)],
                         ids=["descending", "unordered", "repeat-ends"])
def test_curve_stats_rows_independent_of_grid_and_batch(levels, cuts):
    """The contract the kernel is held to on the card, on the plain path:
    each row of a grid equals a one-cut call's row at that cut, and a
    frame's rows do not depend on the other frames of the batch (max, min
    and count exactly; PyTorch's CPU float64 sum may split its reduction
    otherwise for another batch, so the sum within 1e-12 of n * max|err|)."""
    q, t, scale, off, target = (torch.from_numpy(v) for v in
                                _curve_inputs((3, 1, 64, 96)))
    kw = dict(levels=levels, valid_hw=(61, 90))
    got = th.curve_stats(q, t, scale, off, target, cut_grid=cuts, **kw)
    assert got.shape == (len(cuts), 3, 1, 4)
    for k, cut in enumerate(cuts):
        one = th.curve_stats(q, t, scale, off, target, cut_grid=(cut,), **kw)
        torch.testing.assert_close(got[k], one[0], rtol=0, atol=0)
    alone = th.curve_stats(q[1:2], t[1:2], scale[1:2], off[1:2], target[1:2],
                           cut_grid=cuts, **kw)
    torch.testing.assert_close(got[:, 1:2, ..., 1:], alone[..., 1:], rtol=0,
                               atol=0)
    n_maxabs = 61 * 90 * float(alone[..., 1:3].abs().max())
    assert float((got[:, 1:2, ..., 0] - alone[..., 0]).abs().max()) <= \
        1e-12 * n_maxabs


def test_cut_vector_must_match_batch():
    with pytest.raises(ValueError):
        th.idwt2d_dequant(torch.zeros(3, 1, 32, 32, dtype=torch.int32),
                          torch.tensor([1, 2], dtype=torch.int32), 3)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(base_test_data):
    """K1, K2 and K3 on the card against their plain versions on the same
    card: bit-equal by construction (no FMA contraction in the kernels);
    K1's integers may differ only at truncation boundaries; K3's float64
    sums only by their summation order, within 1e-12 of the sum of |err|
    bound n * max|err|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    dev = torch.device("cuda")
    x = torch.from_numpy(_inputs("fixture", base_test_data)).to(dev)
    x = (x - x.amin()) / (x.amax() - x.amin()) * 65535.0
    th.reset_launch_counts()
    for levels in (3, 5):
        qk = th.dwt2d_quantize(x, levels)
        qp = th.dwt2d_quantize_plain(x, levels)
        _assert_ints_close(qk.cpu().numpy(), qp.cpu().numpy())
        torch.testing.assert_close(th.dwt2d_transform(x, levels),
                                   th.dwt2d_transform_plain(x, levels),
                                   rtol=0, atol=0)
        cut = torch.tensor([levels + 2, 0], dtype=torch.int32, device=dev)
        torch.testing.assert_close(th.idwt2d_dequant(qp, cut, levels),
                                   th.idwt2d_dequant_plain(qp, cut, levels),
                                   rtol=0, atol=0)
    q, t, scale, off, target = (torch.from_numpy(v).to(dev)
                                for v in _curve_inputs((2, 1, 64, 64)))
    kw = dict(levels=3, cut_grid=(12, 9, 6, 3, 0), valid_hw=(50, 60))
    got = th.curve_stats(q, t, scale, off, target, **kw)
    want = th.curve_stats_plain(q, t, scale, off, target, **kw)
    torch.testing.assert_close(got[..., 1:], want[..., 1:], rtol=0, atol=0)
    n_maxabs = 50 * 60 * float(want[..., 1:3].abs().max())
    assert float((got[..., 0] - want[..., 0]).abs().max()) <= 1e-12 * n_maxabs
    assert th.launch_counts() == {"dwt2d_quantize": 2, "dwt2d_transform": 2,
                                  "idwt2d_dequant": 2, "curve_stats": 1}
    with pytest.raises(ValueError):
        th.dwt2d_quantize(x[..., :, :100].contiguous(), 5)


@pytest.mark.cuda
def test_cuda_kernels_launched_counts_each_launch():
    """The library's own launch count at the main path's frame size: K1 and
    K2 at 5 levels are 4 launches (3 tiled levels and one coarse launch),
    at 3 levels 3; K3 is 4 per group of 8 cuts (3 inverse levels and the
    level-0 statistics) plus one reduction; a refused call launches none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(0, 65535, (1, 1, 736, 1440)).astype(
        np.float32)).to(dev)
    q = th.dwt2d_quantize_plain(x, 5)
    cut = torch.tensor([12], dtype=torch.int32, device=dev)
    one = torch.ones(1, device=dev)

    def launched(fn):
        torch.cuda.synchronize()
        before = th.cuda_kernels_launched()
        fn()
        torch.cuda.synchronize()
        return th.cuda_kernels_launched() - before

    assert launched(lambda: th.dwt2d_quantize(x, 5)) == 4
    assert launched(lambda: th.dwt2d_transform(x, 3)) == 3
    assert launched(lambda: th.idwt2d_dequant(q, cut, 5)) == 4
    for grid, want in ((tuple(range(21, -1, -3)), 5),
                       (tuple(range(21, -1, -1)), 13)):
        assert launched(lambda grid=grid: th.curve_stats(
            q, x, one, 0 * one, 0.5 * one, levels=5, cut_grid=grid,
            valid_hw=(721, 1440))) == want
    before = th.cuda_kernels_launched()
    with pytest.raises(ValueError):
        th.dwt2d_quantize(x[..., :100].contiguous(), 5)
    assert th.cuda_kernels_launched() == before


EDGE_SHAPES = [
    (2, 1, 96, 160),      # not a multiple of the 64x64 tile
    (1, 2, 224, 416),
    (1, 1, 32, 64),       # levels shrink to 1-2 samples per half
    (4, 1, 1824, 3616),   # a 1801x3600 grid, padded: taller than 1816 rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_cuda_kernels_match_plain_at_edge_shapes(shape):
    """The kernels at tile and level edges, with the rules of
    ``test_cuda_kernels_match_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(5).random(shape) * 65535.0)
    x = x.to(torch.float32).to(dev)
    r = (x % 255.0).contiguous()
    b = shape[0]
    for levels in (3, 5):
        qk = th.dwt2d_quantize(x, levels)
        qp = th.dwt2d_quantize_plain(x, levels)
        _assert_ints_close(qk.cpu().numpy(), qp.cpu().numpy())
        torch.testing.assert_close(th.dwt2d_transform(r, levels),
                                   th.dwt2d_transform_plain(r, levels),
                                   rtol=0, atol=0)
        cut = torch.arange(b, dtype=torch.int32, device=dev) + levels
        torch.testing.assert_close(th.idwt2d_dequant(qp, cut, levels),
                                   th.idwt2d_dequant_plain(qp, cut, levels),
                                   rtol=0, atol=0)
        ones = torch.ones(b, device=dev)
        args = (qp, x, ones, 0 * ones, 0.5 * ones)
        kw = dict(levels=levels, cut_grid=(12, 9, 6, 3, 0),
                  valid_hw=(shape[2] - 3, shape[3] - 5))
        got = th.curve_stats(*args, **kw)
        want = th.curve_stats_plain(*args, **kw)
        torch.testing.assert_close(got[..., 1:], want[..., 1:], rtol=0,
                                   atol=0)
        n_maxabs = (shape[2] - 3) * (shape[3] - 5) * float(
            want[..., 1:3].abs().max())
        assert float((got[..., 0] - want[..., 0]).abs().max()) <= \
            1e-12 * n_maxabs


def _edge_curve_inputs(shape, levels):
    """K3's inputs at an edge shape on the card: the frame as its own
    target, unit scale, a valid region short of the padding."""
    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(6).random(shape) * 65535.0)
    x = x.to(torch.float32).to(dev)
    ones = torch.ones(shape[0], device=dev)
    args = (th.dwt2d_quantize_plain(x, levels), x, ones, 0 * ones,
            0.5 * ones)
    return args, (shape[2] - 3, shape[3] - 5)


CURVE_GRIDS = {"1-cut": (9,), "5-cuts": RES_CUTS, "8-cuts": BASE_CUTS,
               "22-cuts": tuple(range(21, -1, -1))}


@pytest.mark.cuda
@pytest.mark.parametrize("grid", list(CURVE_GRIDS))
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_cuda_curve_stats_grids(shape, grid):
    """K3 over grids of 1, 5, 8 and 22 cuts (the last crosses cut groups)
    at 3 and 5 levels, with the rules of ``test_cuda_kernels_match_plain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    cuts = CURVE_GRIDS[grid]
    if grid == "22-cuts":
        assert len(cuts) > th.curve_cut_group()
    for levels in (3, 5):
        args, hw = _edge_curve_inputs(shape, levels)
        kw = dict(levels=levels, cut_grid=cuts, valid_hw=hw)
        got = th.curve_stats(*args, **kw)
        want = th.curve_stats_plain(*args, **kw)
        assert got.shape == (len(cuts),) + shape[:2] + (4,)
        torch.testing.assert_close(got[..., 1:], want[..., 1:], rtol=0,
                                   atol=0)
        n_maxabs = hw[0] * hw[1] * float(want[..., 1:3].abs().max())
        assert float((got[..., 0] - want[..., 0]).abs().max()) <= \
            1e-12 * n_maxabs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_cuda_curve_stats_rows_independent_of_grid(shape):
    """Each row of an unordered grid with a repeated cut, and of a grid one
    cut longer than a cut group, equals bit for bit the row of a one-cut
    call at that cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    crossing = tuple(range(th.curve_cut_group(), -1, -1))
    for levels, cuts in ((5, UNORDERED_CUTS), (3, crossing)):
        args, hw = _edge_curve_inputs(shape, levels)
        kw = dict(levels=levels, valid_hw=hw)
        got = th.curve_stats(*args, cut_grid=cuts, **kw)
        for k, cut in enumerate(cuts):
            one = th.curve_stats(*args, cut_grid=(cut,), **kw)
            torch.testing.assert_close(got[k], one[0], rtol=0, atol=0)


def _delta_magnitude_input(b, shape_hw, seed):
    """(b, 1, h, w) int32 at temporal-delta magnitudes: |q| spread over
    every bit length up to DELTA_NUM_PLANES (22), both extremes present."""
    rng = np.random.default_rng(seed)
    h, w = shape_hw
    mag = rng.integers(0, 1 << 22, size=(b, 1, h, w), dtype=np.int64)
    mag >>= rng.integers(0, 22, size=mag.shape)
    q = np.where(rng.random(mag.shape) < 0.5, -mag, mag).astype(np.int32)
    q[0, 0, 0, 0] = (1 << 22) - 1
    q[-1, 0, 1, 1] = -((1 << 22) - 1)
    return q


@pytest.mark.parametrize("levels", [3, 5])
def test_dequant_plain_at_delta_magnitudes_matches_jax(levels):
    """The temporal deltas' integers (|q| < 2^22) at every cut 0-22 (one
    per chunk): the plain version against the JAX package's, to float
    tolerance."""
    q = _delta_magnitude_input(23, (64, 96), 7)
    cut = np.arange(23, dtype=np.int32)
    ref = np.asarray(jp.idwt2d_dequant(jnp.asarray(q), jnp.asarray(cut),
                                       levels))
    got = th.idwt2d_dequant(torch.from_numpy(q), torch.from_numpy(cut),
                            levels).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [3, 5])
def test_cuda_dequant_at_delta_magnitudes(levels):
    """K2 on the temporal deltas' integers (|q| < 2^22) at every cut 0-22
    (one per chunk), bit-equal to its plain version on the card: the one
    add of the per-cut constant stays exact there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    dev = torch.device("cuda")
    q = torch.from_numpy(_delta_magnitude_input(23, (96, 160), 8)).to(dev)
    cut = torch.arange(23, dtype=torch.int32, device=dev)
    torch.testing.assert_close(th.idwt2d_dequant(q, cut, levels),
                               th.idwt2d_dequant_plain(q, cut, levels),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 128, 256)] + EDGE_SHAPES[:3])
def test_cuda_quantize_is_truncated_transform(shape):
    """Rate mode's route: K1's integers are the truncation of its float
    variant's coefficients, bit for bit, at 5 and 3 levels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    x = torch.from_numpy(np.random.default_rng(9).random(shape) * 65535.0)
    x = x.to(torch.float32).cuda()
    for levels in (3, 5):
        want = torch.trunc(th.dwt2d_transform(x, levels)).to(torch.int32)
        assert torch.equal(th.dwt2d_quantize(x, levels), want)
