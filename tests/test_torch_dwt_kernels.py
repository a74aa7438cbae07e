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
    assert th.launch_counts() == {"dwt2d_quantize": 0, "dwt2d_transform": 0,
                                  "idwt2d_dequant": 0}


def test_cut_vector_must_match_batch():
    with pytest.raises(ValueError):
        th.idwt2d_dequant(torch.zeros(3, 1, 32, 32, dtype=torch.int32),
                          torch.tensor([1, 2], dtype=torch.int32), 3)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(base_test_data):
    """K1 and K2 on the card against their plain versions on the same
    card: bit-equal by construction (no FMA contraction in the kernels);
    K1's integers may differ only at truncation boundaries."""
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
    assert th.launch_counts() == {"dwt2d_quantize": 2, "dwt2d_transform": 2,
                                  "idwt2d_dequant": 2}
    with pytest.raises(ValueError):
        th.dwt2d_quantize(x[..., :, :100].contiguous(), 5)
