"""Share of its roofline of K2, the dequantizing inverse transform
(``idwt2d_dequant``; kernels ``inv_tile``, ``inv_coarse``), over the traced
stretch."""

from portbench.metrics import _roofline


def read(run):
    return _roofline.share(run, "k2")
