"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The program's build and kernel caches
stay inside the checkout, at fixed paths."""

import time

T0 = time.time()          # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parents[1] / ".h100bench_cache"


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m h100bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    from h100bench import core
    return core.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
