"""The control (bfloat16 in place of float32, see control.py) fails the
comparison; the sound program passes it.  On the CPU at a small shape, and
on the card at the cells' own size on three seeds."""

import pytest
import torch

from portbench import check, control

CELLS = ["max0.5_cr30.write8", "rel0.01_cr200.write8", "max0.5_cr30.read8"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_sound_passes_cpu(workload):
    r = control.readings(workload, 2**31 + 5, 2, device="cpu",
                         grid=(64, 96))
    assert control.fails(r["control"], r["limits"])
    assert not control.fails(r["sound"], r["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_card_at_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        r = control.readings(workload, seed, 2)
        assert control.fails(r["control"], r["limits"]), r
        assert not control.fails(r["sound"], r["limits"]), r
        assert r["limits"] == check.LIMITS
