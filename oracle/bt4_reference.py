"""Leela Chess Zero's BT4 encoder transformer over Splendor boards in plain
PyTorch and float32 (TF32 off), the reference that ``SplendorNet`` version 3
is held to in the CPU tests.  It is the benchmark's reference,
``h100bench/reference/bt4.py``, which imports neither the program nor JAX;
its docstring gives the equations and the departures from Lc0."""

from h100bench.reference.bt4 import BT4, full_fp32  # noqa: F401
