"""kbench: the benchmark of kmdiff_tpu_torch on one NVIDIA H100.

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout:

    python3 -B -m kbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

and prints one JSON line: whether every job of the window wrote what the
plain reference (``kbench.reference``) computes from the same reads, and
the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``). Everything is found by name: a configuration is
``configs/<config>.json``, a traffic mix ``traffic/<mix>.json`` and a
metric ``metrics/<metric>.py``. See README.md.

Nothing here imports JAX or the JAX package; ``reference`` imports nothing
of the port either.
"""
