#!/usr/bin/env python3
"""Scaling efficiency of the PyTorch port's sharded encode
(``scripts/scaling_bench.py`` over CUDA devices).

Encodes a fixed workload per device (weak scaling) through
``parallel.sharded.encode_chunked_sharded`` on meshes of 1, 2, 4, ..., N
devices and reports

    efficiency(N) = throughput(N) / (N * throughput(1))

Chunks are independent (no halos, no cross-chunk state), so the loss terms
are the device-to-host gather of the exchange and the host's stream
assembly.  Each container is checked byte for byte: on one device against
``encode_chunked``, on N devices its first chunks against the one-device
container (the frames of a larger workload start with the smaller one's).

Run from the root of a checkout, on every visible card::

    python3 scripts/torch_scaling_bench.py

or on a mesh of N CPU "devices" (``make_mesh(device="cpu", n=N)``; they
share the machine's cores, so the efficiency there understates a real
mesh's, and the run checks the harness and the byte identity)::

    python3 scripts/torch_scaling_bench.py --cpu-mesh 8

``EBCC_SCALE_FRAMES_PER_DEV`` (8), ``EBCC_SCALE_H`` (721), ``EBCC_SCALE_W``
(1440) and ``EBCC_SCALE_REPS`` (3) set the workload, as in the JAX script.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES_PER_DEVICE = int(os.environ.get("EBCC_SCALE_FRAMES_PER_DEV", "8"))
H = int(os.environ.get("EBCC_SCALE_H", "721"))
W = int(os.environ.get("EBCC_SCALE_W", "1440"))
REPS = int(os.environ.get("EBCC_SCALE_REPS", "3"))


def frames(n):
    """``scripts/scaling_bench.py``'s frames: a smooth field plus 0.3 per
    frame and 0.5 white noise, seed 0."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 260 + 25 * np.sin(yy / H * np.pi) * np.cos(xx / W * 2 * np.pi)
    return np.stack([
        (base + 0.3 * i + rng.normal(scale=0.5, size=(H, W))).astype(
            np.float32) for i in range(n)])


def config_for(data):
    from ebcc_tpu_torch import CodecConfig, RESIDUAL_MAX_ERROR
    return CodecConfig(dims=data.shape, base_cr=30,
                       residual_mode=RESIDUAL_MAX_ERROR, error=0.5,
                       chunk_dims=(1, H, W))


def run(n_dev, devices):
    """Best-of-REPS points/s of the sharded encode on the first ``n_dev``
    devices, and its container."""
    from ebcc_tpu_torch.parallel import make_mesh, sharded
    data = frames(FRAMES_PER_DEVICE * n_dev)
    config = config_for(data)
    m = make_mesh(devices[:n_dev], shape=(1, n_dev))
    blob = sharded.encode_chunked_sharded(data, config, mesh=m)  # warm-up
    best = None
    for _ in range(REPS):
        t0 = time.perf_counter()
        blob = sharded.encode_chunked_sharded(data, config, mesh=m)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return data.size / best, blob


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-mesh", type=int, metavar="N",
                    help="N CPU devices in place of the CUDA cards")
    args = ap.parse_args(argv)

    import torch
    from ebcc_tpu_torch import encode_chunked
    from ebcc_tpu_torch.core import stream
    from ebcc_tpu_torch.device import resolve_device

    if args.cpu_mesh:
        devices = [torch.device("cpu")] * args.cpu_mesh
        platform = "cpu"
    else:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        platform = "cuda"
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    base = base_records = None
    rows = []
    for n in sizes:
        pts, blob = run(n, devices)
        records = stream.iter_chunked(blob)[1]
        if base is None:
            base, base_records = pts, records
            data = frames(FRAMES_PER_DEVICE)
            want = encode_chunked(data, config_for(data), device=devices[0])
            identical = blob == want
        else:
            identical = records[:len(base_records)] == base_records
        if not identical:
            raise AssertionError(f"the {n}-device container differs")
        eff = pts / (n * base)
        rows.append({"devices": n, "pts_per_s": round(pts, 1),
                     "efficiency_vs_1dev": round(eff, 3),
                     "byte_identical": identical})
        print(json.dumps(rows[-1]))
    if platform == "cuda":
        from ebcc_tpu_torch import bench
        platform = bench.device_line(devices[0])
    print(json.dumps({"metric": "weak-scaling encode efficiency",
                      "platform": platform, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
