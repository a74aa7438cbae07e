"""The spread of a cell's runs: the readings behind ``BENCHMARK.json``'s
bounds, the lower readings of ``correct`` and the control, in one call.

Runs ``portbench/run.py`` as a check runs it, one process at a time, from
the root of a checkout on the card's machine::

    python3 portbench/spread.py --out DIR --seconds 40 --base-seed N CELL...

For each cell: two sets of ``--runs`` runs with the same seeds in both
(``N + 1000 k + 1`` ... for the k-th cell), ``--traced`` runs with
``--trace 1``, ``--quick`` short runs on further seeds, and the control
(``portbench/control.py``) on the first ``--control-seeds`` seeds of the
sets, so that it reads slabs that the sets' runs cycle through.  ``--repeat R
--seed S`` instead runs each cell ``R`` times on one seed, alternating
the plain environment with each ``--variant NAME:KEY=VALUE[,KEY=VALUE]``.

Every run's standard output and error go to ``DIR``; ``DIR/summary.json``
holds, per cell and end-to-end metric, each set's median and spread (the
distance between the quartiles of ``statistics.quantiles(values, n=4)``
over the median), the tight reading (the mean of the two sets' spreads,
each set without its run farthest from its median), the loose reading
(the spread of all runs of both sets) and five times the wider set
spread; the largest reading of each number of ``correct`` over the runs;
and, beside each run, what the process took from its host in the window
(``host`` in the harness's window line), a timing of a fixed copy and a
fixed loop made just before the run, and the host's CPU shares over the
run from ``/proc/stat``, so that a slow run can be told from a slow host.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STAT_FIELDS = ("user", "nice", "system", "idle", "iowait", "irq",
               "softirq", "steal")


def spread(values: list) -> float | None:
    """Quartile distance over the median (``statistics.quantiles``)."""
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med) if med else None


def without_farthest(values: list) -> list:
    med = statistics.median(values)
    drop = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != drop]


def metric_summary(set1: list, set2: list) -> dict:
    s1, s2 = spread(set1), spread(set2)
    wider = max(s for s in (s1, s2, 0.0) if s is not None)
    t1, t2 = spread(without_farthest(set1)), spread(without_farthest(set2))
    tight = [t for t in (t1, t2) if t is not None]
    return {"set1": set1, "set2": set2,
            "median1": statistics.median(set1),
            "median2": statistics.median(set2),
            "spread1": s1, "spread2": s2,
            "tight": sum(tight) / len(tight) if tight else None,
            "loose": spread(set1 + set2),
            "five_times_wider": 5 * wider}


def proc_stat() -> list:
    try:
        with open("/proc/stat") as f:
            first = f.readline().split()
        return [int(x) for x in first[1:1 + len(STAT_FIELDS)]]
    except (OSError, ValueError):
        return []


def stat_shares(a: list, b: list) -> dict:
    if not a or len(a) != len(b):
        return {}
    d = [y - x for x, y in zip(a, b)]
    total = sum(d) or 1
    return {k: v / total for k, v in zip(STAT_FIELDS, d)}


class Probe:
    """A fixed copy of one slab's bytes between buffers made once, and a
    fixed loop of the interpreter: the host's speed just before a run."""

    def __init__(self):
        import numpy as np
        self.a = np.ones(8 * 721 * 1440, np.float32)
        self.b = np.zeros_like(self.a)

    def __call__(self) -> dict:
        import numpy as np
        t = time.perf_counter()
        for _ in range(10):
            np.copyto(self.b, self.a)
        copy_ms = (time.perf_counter() - t) * 100
        t = time.perf_counter()
        x = 0
        for i in range(1_000_000):
            x += i
        return {"copy_ms": copy_ms,
                "loop_ms": (time.perf_counter() - t) * 1e3}


def last_json(text: str, key=None):
    for line in reversed(text.strip().splitlines()):
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and (key is None or key in obj):
            return obj
    return None


def run_once(out: str, probe: Probe, cell: str, seed: int, seconds: float,
             trace: int, label: str, env: dict) -> dict:
    base = os.path.join(out, f"{cell}.{label}")
    before = probe()
    s0 = proc_stat()
    t = time.perf_counter()
    with open(base + ".out", "w") as fo, open(base + ".err", "w") as fe:
        rc = subprocess.call(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload",
             cell, "--seed", str(seed), "--seconds", str(seconds),
             "--trace", str(trace)], stdout=fo, stderr=fe, cwd=ROOT,
            env={**os.environ, **env})
    wall = time.perf_counter() - t
    text = open(base + ".out").read()
    rec = {"cell": cell, "label": label, "seed": seed, "seconds": seconds,
           "trace": trace, "env": env, "rc": rc, "wall_s": wall,
           "probe": before, "host_shares": stat_shares(s0, proc_stat()),
           "window": last_json(text, "portbench"),
           "result": last_json(text, "correct") if rc == 0 else None}
    r = rec["result"] or {}
    short = {k: v["value"] for k, v in r.get("metrics", {}).items()}
    print(json.dumps({"run": f"{cell}.{label}", "seed": seed, "rc": rc,
                      "wall_s": round(wall, 2), "correct": r.get("correct"),
                      "metrics": short, "probe": before,
                      "host": (rec["window"] or {}).get("host"),
                      "steal": rec["host_shares"].get("steal")}),
          flush=True)
    return rec


def summarise(cell: str, runs: list, n_sets: int) -> dict:
    sets = [[r for r in runs if r["label"].startswith(f"s{k}.")]
            for k in (1, 2)]
    ok = [r for r in runs if r["result"]]
    out = {"runs": len(runs), "results": len(ok),
           "correct": sum(bool(r["result"]["correct"]) for r in ok),
           "seeds_correct": sorted({r["seed"] for r in ok
                                    if r["result"]["correct"]}),
           "checks_largest": {}, "metrics": {}}
    for r in ok:
        for name, c in r["result"].get("checks", {}).items():
            if isinstance(c.get("value"), (int, float)):
                out["checks_largest"][name] = max(
                    out["checks_largest"].get(name, 0.0), c["value"])
    if n_sets and all(len(s) == n_sets for s in sets) and all(
            r["result"] for s in sets for r in s):
        names = sets[0][0]["result"]["metrics"]
        for name in names:
            v1 = [r["result"]["metrics"][name]["value"] for r in sets[0]]
            v2 = [r["result"]["metrics"][name]["value"] for r in sets[1]]
            out["metrics"][name] = metric_summary(v1, v2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--base-seed", type=int, default=3_900_000_000)
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--traced", type=int, default=3)
    ap.add_argument("--quick", type=int, default=0)
    ap.add_argument("--quick-seconds", type=float, default=10)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--control-slabs", type=int, default=4)
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    probe = Probe()
    variants = [("plain", {})]
    for v in args.variant:
        name, _, pairs = v.partition(":")
        variants.append((name, dict(p.split("=", 1)
                                    for p in pairs.split(",") if p)))
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    except OSError:
        card = "nvidia-smi unavailable"
    summary = {"card": card, "cells": {}}
    records = []
    for k, cell in enumerate(args.cells, 1):
        runs = []
        b = args.base_seed + 1000 * k
        if args.repeat:
            seed = args.seed if args.seed is not None else b
            for j in range(args.repeat):
                name, env = variants[j % len(variants)]
                runs.append(run_once(args.out, probe, cell, seed,
                                     args.seconds, 0, f"r{j}.{name}", env))
        else:
            for s in (1, 2):
                for j in range(1, args.runs + 1):
                    runs.append(run_once(args.out, probe, cell, b + j,
                                         args.seconds, 0, f"s{s}.{j}", {}))
            for j in range(args.traced):
                seed = b + args.runs + 1 + j
                runs.append(run_once(args.out, probe, cell, seed,
                                     args.seconds, 1, f"t.{j}", {}))
            for j in range(args.quick):
                seed = b + args.runs + args.traced + 1 + j
                runs.append(run_once(args.out, probe, cell, seed,
                                     args.quick_seconds, 0, f"q.{j}", {}))
        summary["cells"][cell] = summarise(
            cell, runs, 0 if args.repeat else args.runs)
        if args.control_seeds and not args.repeat:
            seeds = [str(b + 1 + j) for j in range(args.control_seeds)]
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.join(HERE, "control.py"),
                 "--workload", cell, "--slabs", str(args.control_slabs),
                 "--seeds", *seeds], capture_output=True, text=True,
                cwd=ROOT)
            with open(os.path.join(args.out, f"{cell}.control.out"),
                      "w") as f:
                f.write(proc.stdout + proc.stderr)
            summary["cells"][cell]["control"] = {
                "rc": proc.returncode, "wall_s": time.perf_counter() - t,
                "last": last_json(proc.stdout, "smallest_control")}
            print(json.dumps({"control": cell,
                              **summary["cells"][cell]["control"]}),
                  flush=True)
        records += runs
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump({**summary, "records": records}, f, indent=1)
    print(json.dumps({c: {n: {k: m[k] for k in ("median1", "median2",
                                                  "spread1", "spread2",
                                                  "tight", "loose")}
                          for n, m in s["metrics"].items()}
                      for c, s in summary["cells"].items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
