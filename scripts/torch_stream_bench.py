#!/usr/bin/env python3
"""Streamed-cube throughput of the PyTorch port (``scripts/stream_bench.py``
on a CUDA card): a pressure-level ERA5-shaped cube (37 levels x 24 hours x
721x1440 float32, 3.7 GB) compressed through ``io.pipeline.compress_stream``
from a disk-backed npy memmap, the slab reader overlapping the encode, as a
Zarr-backed pipeline reads its store.

Reports the streamed wall and points/s beside the same data encoded in
memory (``encode_chunked``): their ratio is the I/O-overlap efficiency (1.0
= the disk reads are hidden under the encode).  The container is decoded
and held to the bound.

Run from the root of a checkout::

    python3 scripts/torch_stream_bench.py [--levels 37] [--hours 24] \
        [--error 0.5] [--keep] [--device cuda]

The cube and the container go to a new temporary directory (under
``TMPDIR``), removed at the end unless ``--keep``.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ebcc_tpu_torch import bench  # noqa: E402


def build_cube(path: str, levels: int, hours: int) -> np.memmap:
    """Disk-backed cube: the bench's frames (smooth evolution over the hour
    axis) scaled to per-level amplitudes and means, as
    ``scripts/stream_bench.py`` builds it."""
    h, w = bench.H, bench.W
    n = levels * hours
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                   shape=(n, h, w))
    base_hours = bench.load_frames(hours, h, w)
    level_mean = np.linspace(200.0, 290.0, levels).astype(np.float32)
    level_amp = np.linspace(0.4, 1.6, levels).astype(np.float32)
    mean0 = float(base_hours.mean())
    for li in range(levels):
        sl = (base_hours - mean0) * level_amp[li] + level_mean[li]
        mm[li * hours:(li + 1) * hours] = sl
    mm.flush()
    del mm
    return np.lib.format.open_memmap(path, mode="r")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--levels", type=int, default=37)
    ap.add_argument("--hours", type=int, default=24)
    ap.add_argument("--error", type=float, default=0.5)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ebcc_tpu_torch import (CodecConfig, RESIDUAL_MAX_ERROR,
                                decode_chunked, encode_chunked)
    from ebcc_tpu_torch.device import resolve_device
    from ebcc_tpu_torch.io import pipeline

    dev = resolve_device(args.device)
    tmpdir = tempfile.mkdtemp(prefix="ebcc_stream_")
    try:
        cube_path = os.path.join(tmpdir, "cube.npy")
        out_path = os.path.join(tmpdir, "cube.etpk")
        data = build_cube(cube_path, args.levels, args.hours)
        n, h, w = data.shape
        config = CodecConfig(dims=data.shape, base_cr=30,
                             residual_mode=RESIDUAL_MAX_ERROR,
                             error=args.error, chunk_dims=(1, h, w))

        # Warm-up (kernel and host builds) on a prefix, so the timed runs
        # measure steady state.
        small = np.asarray(data[:8])
        encode_chunked(small, CodecConfig(
            dims=small.shape, base_cr=30, residual_mode=RESIDUAL_MAX_ERROR,
            error=args.error, chunk_dims=(1, h, w)), device=dev)

        # Streamed: disk memmap -> compress_stream -> container on disk.
        t0 = time.perf_counter()
        with open(out_path, "wb") as f:
            nbytes = pipeline.compress_stream(data, config, f, device=dev)
        t_stream = time.perf_counter() - t0

        # In memory: the same chunks, no read or write legs.
        ram = np.asarray(data)
        t0 = time.perf_counter()
        blob = encode_chunked(ram, config, device=dev)
        t_mem = time.perf_counter() - t0

        with open(out_path, "rb") as f:
            streamed = f.read()
        if streamed != blob:
            raise AssertionError("streamed container differs from "
                                 "encode_chunked's")
        dec = decode_chunked(streamed, device=dev)
        maxerr = float(np.abs(dec - ram).max())
        if maxerr > args.error or len(streamed) != nbytes:
            raise AssertionError((maxerr, len(streamed), nbytes))

        pts = data.size
        print(json.dumps({
            "cube": [n, h, w],
            "streamed_seconds": round(t_stream, 2),
            "streamed_pts_per_s": round(pts / t_stream, 1),
            "in_memory_seconds": round(t_mem, 2),
            "in_memory_pts_per_s": round(pts / t_mem, 1),
            "overlap_efficiency": round(t_mem / t_stream, 3),
            "compression_ratio": round(data.nbytes / nbytes, 2),
            "max_error": maxerr,
            "container_bytes": nbytes,
            "device": bench.device_line(dev),
        }))
    finally:
        if not args.keep:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
