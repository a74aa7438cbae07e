"""The coded-size estimate's kernel (``ops.bitplane_hopper``, csrc/bitplane.cu)
against its plain twin, ``ops.bitplane.estimated_code_bytes_plain``.

On the CPU: a CPU tensor takes the plain twin and launches nothing, and a
numpy model of the kernel's contract gives the plain twin's table bit for
bit.  The contract: per group of the trailing two axes, the 1-bits of each
magnitude plane (the word |q|) and the coefficients with ``|q| >> c``
nonzero (the word with every bit at and below |q|'s top bit set), counted
as exact integers; then the float32 steps of the plain version as PyTorch
runs them on the tensor's device, in its order.  The one step whose last
bit belongs to a library is log2, which the model takes from torch on the
same (P, G) layout; PyTorch divides by the Python int N on the CPU and, on
the card, multiplies by its float reciprocal.

Cases marked ``cuda`` run on the card: the kernel's table bit-equal to the
plain twin's on the same CUDA tensor at the encode's shapes and at edge
values, containers byte-identical with the estimate forced to the plain
twin, and the launches of one residual batch.  This file imports no JAX:
the card's machine has none.
"""

import numpy as np
import pytest
import torch

import ebcc_tpu_torch as et
from ebcc_tpu_torch.core import graphs
from ebcc_tpu_torch.ops import bitplane
from ebcc_tpu_torch.ops import bitplane_hopper as bh

KINDS = ["random", "zeros", "single_plane", "at_and_above_2p", "negative",
         "int_min"]
INT_MIN, INT_MAX = -2**31, 2**31 - 1


def values(kind, shape, planes, seed=0, device="cpu"):
    """int32 q of one kind of values, made from ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi):
        return torch.randint(lo, hi, shape, generator=g, device=device,
                             dtype=torch.int64)

    if kind == "random":   # magnitudes spread over every plane, and zeros
        scale = torch.exp2(torch.rand(shape, generator=g, device=device)
                           * planes)
        q = torch.randn(shape, generator=g, device=device) * scale
        return q.trunc().to(torch.int32)
    if kind == "zeros":
        return torch.zeros(shape, dtype=torch.int32, device=device)
    if kind == "single_plane":
        return (ints(-1, 2) << (planes // 2)).to(torch.int32)
    if kind == "at_and_above_2p":
        return (ints((1 << planes) - 2, 1 << (planes + 2))
                * (ints(0, 2) * 2 - 1)).to(torch.int32)
    if kind == "negative":
        return (-ints(1, 1 << planes)).to(torch.int32)
    if kind == "int_min":
        q = ints(-5, 5)
        flat = q.view(-1)
        flat[::7] = INT_MIN
        flat[3::11] = INT_MAX
        return q.to(torch.int32)
    raise ValueError(kind)


def model_counts(q, planes):
    """(G, planes) bits and sig of the contract, in numpy: column counts of
    the words a = |q| (int32 abs, which wraps at INT_MIN) and t."""
    q = np.asarray(q, dtype=np.int32)
    n = q.shape[-1] * q.shape[-2]
    a = np.abs(q.reshape(-1, n)).view(np.uint32)
    t = a.copy()
    for s in (1, 2, 4, 8, 16):
        t |= t >> s
    cols = lambda w: np.stack([((w >> c) & 1).sum(axis=1, dtype=np.int64)
                               for c in range(planes)], axis=1)
    return cols(a), cols(t)


def model_tail(bits, sig, n, planes, log2, device_division,
               zstd_efficiency=1.35):
    """(planes + 1, G) float32 table from the counts, one float32 step at a
    time in the plain version's order; ``log2`` maps a (planes, G) float32
    array."""
    f32 = np.float32
    nf = f32(n)
    cnt = np.ascontiguousarray(bits[:, ::-1].T).astype(f32)  # MSB first
    dens = cnt * (f32(1) / nf) if device_division else cnt / nf
    eps = f32(1e-12)
    one_minus = f32(1) - dens
    ent = -(dens * log2(dens + eps) + one_minus * log2(one_minus + eps))
    plane_bits = ent * nf
    prefix = [np.zeros(bits.shape[0], f32)]
    for p in range(planes):
        prefix.append(prefix[-1] + plane_bits[p])
    rows = [(prefix[planes - c] + sig[:, c].astype(f32)) / f32(8)
            * f32(zstd_efficiency) for c in range(planes)]
    rows.append(np.zeros(bits.shape[0], f32) / f32(8) * f32(zstd_efficiency))
    return np.stack(rows)


def plain_counts(q, planes):
    """(G, 2, planes) int64 by the plain version's own shifts."""
    mag = q.abs().reshape(-1, q.shape[-1] * q.shape[-2])
    bits = torch.stack([((mag >> p) & 1).sum(1) for p in range(planes)], 1)
    sig = torch.stack([(mag >> c).to(torch.bool).sum(1)
                       for c in range(planes)], 1)
    return torch.stack([bits, sig], 1)


# ---- CPU: the plain twin and the kernel's contract -------------------------

@pytest.mark.parametrize("planes", [13, 22])
def test_cpu_tensor_takes_plain_twin(planes):
    q = values("random", (3, 48, 64), planes, seed=planes)
    bh.reset_launch_counts()
    got = bitplane.estimated_code_bytes(q, planes)
    assert torch.equal(got, bitplane.estimated_code_bytes_plain(q, planes))
    assert got.shape == (planes + 1, 3) and got.dtype == torch.float32
    assert bh.launch_counts() == {"code_size_stats": 0}


def test_kernel_wrapper_refuses_cpu_tensor():
    """The kernel's wrapper takes CUDA tensors only, and says so before it
    builds anything."""
    with pytest.raises(ValueError, match="CUDA"):
        bh.estimated_code_bytes(torch.zeros(2, 8, 8, dtype=torch.int32), 13)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("planes", [13, 22])
def test_contract_model_equals_plain(kind, planes):
    q = values(kind, (4, 40, 72), planes, seed=7)
    bits, sig = model_counts(q.numpy(), planes)
    want = plain_counts(q, planes).numpy()
    np.testing.assert_array_equal(bits, want[:, 0])
    np.testing.assert_array_equal(sig, want[:, 1])
    cpu_log2 = lambda x: torch.log2(torch.from_numpy(x)).numpy()
    table = model_tail(bits, sig, 40 * 72, planes, cpu_log2,
                       device_division=False)
    np.testing.assert_array_equal(
        table, bitplane.estimated_code_bytes(q, planes).numpy())


def test_contract_model_with_leading_axes():
    """Groups are the product of the leading axes; the table keeps them."""
    q = values("random", (2, 3, 16, 24), 22, seed=3)
    bits, sig = model_counts(q.numpy(), 22)
    cpu_log2 = lambda x: torch.log2(torch.from_numpy(x)).numpy()
    table = model_tail(bits, sig, 16 * 24, 22, cpu_log2,
                       device_division=False)
    got = bitplane.estimated_code_bytes(q, 22)
    assert got.shape == (23, 2, 3)
    np.testing.assert_array_equal(table, got.reshape(23, 6).numpy())


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build with nvcc)")
    return torch.device("cuda")


def _misaligned(card, shape, planes, kind, seed):
    """q with N a multiple of 4 at an address off 16 bytes: the kernel's
    scalar loads, as for an odd N."""
    q = values(kind, shape, planes, seed=seed, device=card)
    buf = torch.empty(q.numel() + 1, dtype=torch.int32, device=card)
    view = buf[1:].view(shape)
    view.copy_(q)
    return view


SHAPES = [(1, 736, 1440), (8, 736, 1440), (32, 736, 1440),
          (5, 24 * 736, 1440), (3, 721, 1439), (2, 736, 1440)]
SHAPE_IDS = ["1x736x1440", "8x736x1440", "32x736x1440", "5x17664x1440",
             "odd_n", "misaligned"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("planes", [13, 22])
def test_card_table_bit_equal_to_plain(card, shape, planes):
    """Every kind of value: the kernel's table equals the plain twin's on
    the same CUDA tensor (``torch.equal``), and one call is two launches;
    at (8, 736, 1440) it also equals the contract's float tail on the
    plain shifts' counts."""
    for seed, kind in enumerate(KINDS):
        if shape == (2, 736, 1440):
            q = _misaligned(card, shape, planes, kind, seed)
            assert q.data_ptr() % 16 and q.is_contiguous()
        else:
            q = values(kind, shape, planes, seed=seed, device=card)
        torch.cuda.synchronize()
        before = bh.cuda_kernels_launched()
        got = bitplane.estimated_code_bytes(q, planes)
        torch.cuda.synchronize()
        assert bh.cuda_kernels_launched() - before == 2, kind
        want = bitplane.estimated_code_bytes_plain(q, planes)
        assert got.shape == want.shape == (planes + 1, shape[0]), kind
        assert torch.equal(got, want), (kind, (got - want).abs().max())
        if shape == (8, 736, 1440):
            c = plain_counts(q, planes).cpu().numpy()
            card_log2 = lambda x: torch.log2(
                torch.from_numpy(x).to(card)).cpu().numpy()
            table = model_tail(c[:, 0], c[:, 1], shape[1] * shape[2],
                               planes, card_log2, device_division=True)
            np.testing.assert_array_equal(table, got.cpu().numpy())


@pytest.mark.cuda
def test_card_refuses_what_the_kernel_does_not_take(card):
    q = torch.zeros((2, 64, 64), dtype=torch.int32, device=card)
    before = bh.cuda_kernels_launched()
    for bad, err in ((q.to(torch.int64), TypeError),
                     (q.transpose(1, 2), ValueError),
                     (q.reshape(-1), ValueError),
                     (q[:, :0], ValueError)):
        with pytest.raises(err):
            bh.estimated_code_bytes(bad, 13)
    with pytest.raises(ValueError):
        bh.estimated_code_bytes(q, 33)
    assert bh.cuda_kernels_launched() == before


def _slab(config_name, frames, seed):
    """One slab of a benchmark configuration as the harness makes it, on
    the host, with the configuration's codec settings."""
    from portbench import harness, traffic
    config = traffic.load_json("configs", config_name)
    dep = harness.deployment(et, config, frames)
    slab = traffic.make_slabs(seed, 1, frames, *dep.grid, "cuda",
                              dep.field)[0]
    return slab.cpu().numpy(), dep.codec, config["env"]


@pytest.mark.cuda
@pytest.mark.parametrize("config_name, frames", [
    ("era5_max0.5_cr30", 8), ("era5_rel0.01_cr200", 8),
    ("era5_geopotential37_max10_cr30", 37)])
def test_card_containers_identical_to_plain_twin(card, monkeypatch,
                                                 config_name, frames):
    data, cfg, env = _slab(config_name, frames, 2**31 + 23)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    bh.reset_launch_counts()
    blob = et.encode_chunked(data, cfg, device="cuda")
    calls = bh.launch_counts()["code_size_stats"]
    assert calls >= 8
    monkeypatch.setattr(bitplane, "estimated_code_bytes",
                        bitplane.estimated_code_bytes_plain)
    graphs.clear()          # a replay would run the kernel's graph again
    twin = et.encode_chunked(data, cfg, device="cuda")
    assert bh.launch_counts()["code_size_stats"] == calls
    assert blob == twin


@pytest.mark.cuda
def test_card_residual_batch_calls_the_kernel_eight_times(card, monkeypatch):
    """A batch that takes the residual sweep estimates the base once, each
    of the 4 residual scales once and each of the 3 refine ratios once,
    every time through the kernel (two launches each)."""
    data, cfg, env = _slab("era5_rel0.01_cr200", 8, 2**31 + 8)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    et.encode_chunked(data, cfg, device="cuda")   # builds the kernels
    torch.cuda.synchronize()
    bh.reset_launch_counts()
    before = bh.cuda_kernels_launched()
    et.encode_chunked(data, cfg, device="cuda")
    torch.cuda.synchronize()
    assert bh.launch_counts() == {"code_size_stats": 8}
    assert bh.cuda_kernels_launched() - before == 16
