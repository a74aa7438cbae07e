"""The generator: the same seed gives the same slabs, another seed others,
every seed the same shapes; large seeds are taken."""

import torch

from portbench import traffic


def test_same_seed_same_slabs():
    a = traffic.make_slabs(2**31 + 7, 2, 3, 40, 64, "cpu")
    b = traffic.make_slabs(2**31 + 7, 2, 3, 40, 64, "cpu")
    assert a.shape == (2, 3, 40, 64) and a.dtype == torch.float32
    assert torch.equal(a, b)


def test_other_seed_other_slabs():
    a = traffic.make_slabs(5, 2, 3, 40, 64, "cpu")
    b = traffic.make_slabs(6, 2, 3, 40, 64, "cpu")
    assert a.shape == b.shape
    assert not torch.equal(a, b)


def test_slabs_distinct_and_in_range():
    a = traffic.make_slabs(3 * 2**40 + 1, 3, 2, 40, 64, "cpu")
    assert not torch.equal(a[0], a[1])
    assert bool(torch.isfinite(a).all())
    assert 200 < float(a.min()) and float(a.max()) < 320


def test_field_shape_follows_bench_generator():
    """Frame i of a slab drifts by 0.3 * i over the smooth base."""
    a = traffic.make_slabs(9, 1, 4, 40, 64, "cpu")[0]
    base = traffic.base_field(40, 64, "cpu")
    drift = (a - base).mean(dim=(1, 2))
    assert torch.allclose(drift[1:] - drift[:-1], torch.full((3,), 0.3),
                          atol=1.0)


def test_a_pool_begins_with_the_smaller_pool_of_its_seed():
    """The control reads the first slabs of the pool that a run of the
    same seed cycles through."""
    a = traffic.make_slabs(2**31 + 3, 2, 2, 40, 64, "cpu")
    b = traffic.make_slabs(2**31 + 3, 5, 2, 40, 64, "cpu")
    assert torch.equal(a, b[:2])
