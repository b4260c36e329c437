"""Benchmark of the PyTorch and CUDA port (``alphazero_tpu_torch``) on an
NVIDIA H100: one command runs one cell of ``BENCHMARK.json`` once.

    python -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, cell, traffic kind or
per-layer metric lives in a file of its own, found by name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<kind>.py`` and ``metrics/<metric>.py``.  ``reference/`` holds
the plain PyTorch reference that decides ``correct``; it imports nothing
of the program."""
