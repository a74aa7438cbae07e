"""portbench: the benchmark of ``ebcc_tpu_torch`` on an NVIDIA card.

Run from the root of a checkout::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json``; each configuration is ``configs/<name>.json``, each
traffic mix ``mixes/<name>.json`` and each metric ``metrics/<name>.py``, so
a cell, a configuration or a metric is added with files and entries alone.

A configuration states the deployment, and ``harness.deployment`` is the
one place that reads it, for runs and for the control: ``grid`` and
``chunk`` (each axis within the slab's, kept as stated); ``base_cr``,
``error`` and ``residual_mode`` (the name of one of the program's
``RESIDUAL_*`` constants); ``codec``, further ``CodecConfig`` keywords
(``temporal``, ``zstd_level``, ``base_levels``, ``residual_levels``,
``entropy_backend``, ``allow_nan``); ``field``, a per-frame ``mean`` and
``std`` laid on the generator's texture (:mod:`portbench.traffic`);
``reference``, the path of the plain decoder file inside this folder
(``decode_container(buf, device, dtype)`` -> ``(array, ranges)``, and
``FormatError``; it imports nothing of the program); ``env``, the
program's environment; and ``name``, ``source``, ``deployment``,
``guarantee`` and ``assumed``, which document it.  The bound that decides
``correct`` is not a key: ``harness.bound_of`` derives it from the codec
settings as docs/FORMAT.md states it (MAX_ERROR and RELATIVE_ERROR; the
decoders' gap 4e-6 of the range, 2 * T * 4e-6 in a temporal chunk of T
frames).  Every key but ``grid``, ``chunk``, ``base_cr`` and
``residual_mode`` is optional; an unknown key, ``codec`` key or mode name,
a mode whose guarantee has no check yet, a chunk that does not fit, or a
``field`` list of the wrong length, stops the run (exit 2).

The yardstick is frozen here: the traffic generator
(:mod:`portbench.traffic`), the plain decoder that decides ``correct``
(:mod:`portbench.reference`, with its own ``libzstd`` binding), the
comparison (:mod:`portbench.check`), the table of peaks and the roofline
arithmetic (:mod:`portbench.roofline`) and the reading of the profiler's
trace (:mod:`portbench.tracing`); a configuration whose streams the
reference refuses brings a decoder file of its own.  Nothing here imports
``jax`` or the JAX package, and the reference imports nothing of
``ebcc_tpu_torch``.
"""
