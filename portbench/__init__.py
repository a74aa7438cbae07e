"""portbench: the benchmark of ``ebcc_tpu_torch`` on an NVIDIA card.

Run from the root of a checkout::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json``; each configuration is ``configs/<name>.json``, each
traffic mix ``mixes/<name>.json`` and each metric ``metrics/<name>.py``, so
a cell or a metric is added with files and entries alone.  The yardstick is
frozen here: the traffic generator (:mod:`portbench.traffic`), the plain
decoder that decides ``correct`` (:mod:`portbench.reference`, with its own
``libzstd`` binding), the comparison (:mod:`portbench.check`), the table of
peaks and the roofline arithmetic (:mod:`portbench.roofline`) and the
reading of the profiler's trace (:mod:`portbench.tracing`).  Nothing here
imports ``jax`` or the JAX package, and the reference imports nothing of
``ebcc_tpu_torch``.
"""
