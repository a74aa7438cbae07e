"""Share of its roofline of K1, the forward transform
(``dwt2d_quantize`` and its float variant ``dwt2d_transform``; kernels
``fwd_tile``, ``fwd_coarse``), over the traced stretch."""

from portbench.metrics import _roofline


def read(run):
    return _roofline.share(run, "k1")
