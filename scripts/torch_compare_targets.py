#!/usr/bin/env python3
"""Error-target sweep table of the PyTorch port (``scripts/compare_targets.py``
on a CUDA card; the reference's ``compress_and_compare.py`` tables): bytes,
CR, max error, RMSE and encode seconds of one 721x1440 frame at absolute
targets 2, 0.5, 0.1 and 0.02 with the zstd, CAB and auto backends.

Run from the root of a checkout::

    python3 scripts/torch_compare_targets.py [--device cuda]

The frame is ``EBCC_ERA5_FRAME`` (a 721x1440 ``.npy``) where it names one,
else the synthetic smooth field of the JAX script.  Each target's first
encode includes the kernel and host builds; the table is printed after a
warm-up encode, so no row pays them.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


H, W = 721, 1440


def load_frame():
    path = os.environ.get("EBCC_ERA5_FRAME")
    if (H, W) == (721, 1440) and path and os.path.exists(path):
        return np.load(path).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return (260 + 25 * np.sin(yy / H * np.pi)
            * np.cos(xx / W * 2 * np.pi)).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ebcc_tpu_torch import CodecConfig, RESIDUAL_MAX_ERROR, decode, encode
    from ebcc_tpu_torch import bench
    from ebcc_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    x = load_frame()
    data = x[None]
    rng = float(x.max() - x.min())

    def config(target, backend):
        return CodecConfig(dims=data.shape, base_cr=30,
                           residual_mode=RESIDUAL_MAX_ERROR, error=target,
                           entropy_backend=backend)

    encode(data, config(0.5, "cab"), device=dev)      # builds
    print(f"# {bench.device_line(dev)}")
    print(f"# frame {x.shape[0]}x{x.shape[1]}, range {rng:.2f} K")
    print("| abs target | rel target | backend | bytes | CR | max err | "
          "rmse | encode s |")
    print("|---|---|---|---|---|---|---|---|")
    for target in [2.0, 0.5, 0.1, 0.02]:
        for backend in ["zstd", "cab", "auto"]:
            t0 = time.perf_counter()
            blob = encode(data, config(target, backend), device=dev)
            dt = time.perf_counter() - t0
            out = decode(blob, device=dev).reshape(x.shape)
            err = np.abs(out - x)
            print(f"| {target} | {target / rng:.1e} | {backend} | "
                  f"{len(blob)} | {x.nbytes / len(blob):.1f} | "
                  f"{err.max():.4f} | {np.sqrt((err ** 2).mean()):.4f} | "
                  f"{dt:.2f} |")
            if err.max() > target:
                raise AssertionError((target, backend, float(err.max())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
