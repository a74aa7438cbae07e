"""The control of ``correct``: readings that the comparison must fail.

The configurations state float32 data and an error bound.  The control
computes one step in the next precision below, bfloat16, where a later
change could be tempted to:

* write cells: the program encodes the slab rounded to bfloat16 (the
  upload a change might halve), and the reference decodes its container;
  ``err_over_bound`` against the float32 slab;
* read cells: the reference, in the program's place, decodes the program's
  containers in bfloat16; ``gap_over_range`` against the float32 reference
  and ``err_over_bound`` against the slab.

The configuration is read as a run reads it (``harness.deployment``): its
codec settings, field profile, bound and decoder file.

Beside each control reading the sound one of the same slabs is printed
(the program itself).  The program's own lower-precision upload, the u16
upload (``EBCC_U16_UPLOAD``), takes its quantization slack off the target,
so it keeps the bound and is no control.

Run from the root of a checkout, at the cell's own size on the card::

    python3 portbench/control.py --workload <cell> --seeds S1 S2 S3 \
        [--slabs 4]

It reads the first ``--slabs`` slabs of the pool that a run of the cell
with that seed cycles through, and prints one JSON line per seed
and a last line with the largest sound and the smallest control reading of
each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import check, harness, traffic  # noqa: E402


def readings(workload: str, seed: int, slabs: int, device="cuda",
             grid=None) -> dict:
    """{"sound": {number: worst}, "control": {number: worst}, "limits":
    {number: limit}} over ``slabs`` slabs of the cell's mix at the cell's
    size (or ``grid``), with the configuration's codec settings, field
    profile, bound and decoder (``harness.deployment``)."""
    import numpy as np
    import torch
    bench = harness.load_benchmark()
    cell = next(c for c in bench["workloads"] if c["name"] == workload)
    config = traffic.load_json("configs", cell["config"])
    mix = traffic.load_json("mixes", cell["traffic"])
    os.environ.update(config.get("env", {}))
    import ebcc_tpu_torch as et
    dev = torch.device(device)
    dep = harness.deployment(et, config, mix["frames"], grid)
    h, w = dep.grid
    cfg, bound, decoder = dep.codec, dep.bound, dep.decoder
    cdims = cfg.chunk_dims
    pool = traffic.make_slabs(seed, slabs, mix["frames"], h, w, dev,
                              dep.field)
    out = {"sound": {}, "control": {}, "limits": bound.limits}

    def keep(side, name, value):
        out[side][name] = max(out[side].get(name, 0.0), value)

    for slab in pool:
        host = np.ascontiguousarray(slab.cpu().numpy())
        blob = et.encode_chunked(host, cfg, device=dev)
        ref, ranges = decoder.decode_container(blob, dev)
        if mix["op"] == "write":
            keep("sound", "err_over_bound",
                 check.err_over_bound(ref, slab, cdims, bound))
            low = slab.to(torch.bfloat16).to(torch.float32)
            blob_c = et.encode_chunked(np.ascontiguousarray(
                low.cpu().numpy()), cfg, device=dev)
            dec_c, _ = decoder.decode_container(blob_c, dev)
            keep("control", "err_over_bound",
                 check.err_over_bound(dec_c, slab, cdims, bound))
        else:
            port = torch.from_numpy(et.decode_chunked(blob, device=dev)).to(
                dev)
            keep("sound", "gap_over_range",
                 check.gap_over_range(port, ref, ranges, cdims))
            keep("sound", "err_over_bound",
                 check.err_over_bound(port, slab, cdims, bound))
            low, _ = decoder.decode_container(blob, dev, torch.bfloat16)
            keep("control", "gap_over_range",
                 check.gap_over_range(low, ref, ranges, cdims))
            keep("control", "err_over_bound",
                 check.err_over_bound(low, slab, cdims, bound))
    return out


def fails(values: dict, limits: dict) -> bool:
    """Whether a reading fails at least one of the limits."""
    return any(not v <= limits[n] for n, v in values.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--slabs", type=int, default=4)
    args = ap.parse_args(argv)
    sound, control, limits = {}, {}, {}
    for seed in args.seeds:
        r = readings(args.workload, seed, args.slabs)
        limits = r["limits"]
        print(json.dumps({"workload": args.workload, "seed": seed, **r}),
              flush=True)
        for n, v in r["sound"].items():
            sound[n] = max(sound.get(n, 0.0), v)
        for n, v in r["control"].items():
            control[n] = min(control.get(n, float("inf")), v)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "largest_sound": sound, "smallest_control": control,
                      "limits": limits,
                      "control_fails": fails(control, limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
