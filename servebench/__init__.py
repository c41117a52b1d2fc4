"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 servebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``cells/<cell>.json``
and ``metrics/<metric>.py``.  The yardstick (traffic generation, FLOP and
byte counts, peaks, percentiles, the trace's reduction and the plain
reference that decides ``correct``) lives here, so that the program
cannot move it.  Nothing here imports ``jax`` or the JAX package.
"""
