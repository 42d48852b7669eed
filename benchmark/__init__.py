"""The benchmark of the PyTorch and CUDA port (``spotlight_tpu_torch``).

One command runs one cell of ``BENCHMARK.json``::

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The harness is driven by data: a cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``); the
configuration names its model family (``models/<family>.py``) and the
traffic the entry point it drives (``entries/<entry>.py``); every metric is
read by ``metrics/<name>.py`` and every compared number is held to
``limits/<workload>.json``.  The plain reference (``reference/``) imports
nothing of the port, and nothing here imports JAX or the JAX package.
"""
