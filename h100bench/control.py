"""Readings that the check's limits are set from, for one cell, in one
process: for every seed a fresh set-up and a window of one call (or one
request), then the check's numbers for the program; for the control seeds
also the same numbers with the reference computed in TF32 put in the
program's place (the control, which has to fail), and where the cell has
it, the fault of half of the batch left out.  One JSON line per seed.

    python -m h100bench.control --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--seconds 0]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from h100bench import core


def readings(name: str, seed: int, seconds: float, control: bool,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    cell, cfg = core.cell_and_config(name, overrides)
    ctx = core.Context(cell, cfg, seed, core.cuda_device(device), core.ROOT)
    runner = core.module("traffic", cell["kind"]).Cell(ctx)
    t = time.time()
    runner.setup()
    runner.window(seconds)
    t_window = time.time() - t
    runner.release()
    checks, attempted, failed = runner.check()
    out = {"seed": seed, "program": {n: v for n, v, _ in checks},
           "attempted": attempted, "failed": failed,
           "seconds": {"setup_window": t_window,
                       "check": time.time() - t - t_window}}
    if control:
        t = time.time()
        out["control"] = runner.control()
        if hasattr(runner, "half_batch"):
            out["half_batch"] = runner.half_batch()
        out["seconds"]["control"] = time.time() - t
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m h100bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    core.require_devices(int(core.workload(args.workload)["chips"]))
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(args.workload, s, args.seconds, s in ctl)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
