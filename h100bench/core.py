"""The harness: finds a cell's files by name, runs its set-up, its window
and its check, and prints the result line.

A cell is ``workloads/<cell>.json``: its configuration (``config``, the
name of ``configs/<config>.json``), its traffic kind (``kind``, the module
``traffic/<kind>.py``), the traffic's parameters (``params``), the
check's limits (``limits``), ``chips``, ``why`` and ``reduced``.  The
metrics a run prints are the entries of ``BENCHMARK.json`` that apply to
the cell: with ``--trace 0`` its end-to-end metrics, which the traffic
module measures; with ``--trace 1`` its per-layer metrics, each read by
``metrics/<metric>.py`` from the traced slice and the cell's counts.

A traffic module defines ``Cell(ctx)`` with ``setup()``, ``window(seconds)
-> {metric: value}``, ``traced() -> (trace reduction, counts)``,
``release()`` and ``check() -> (checks, attempted, failed)``, where each
check is ``(name, value, limit)`` and holds when ``value <= limit``.  A
metric module defines ``read(data) -> float | None``; ``data`` holds
``trace`` (``trace.reduce``'s dict), ``counts`` (the cell's counts of the
traced slice and the window) and ``cell`` (the workload file)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BANNED = ("jax", "jaxlib", "flax", "alphazero_tpu")


class NoResult(RuntimeError):
    """The run prints no result line and exits with another code than 0."""


@dataclasses.dataclass
class Context:
    """What a traffic module's ``Cell`` is built from: the cell's file, its
    configuration's, the run's seed, the device and the checkout's root."""
    cell: dict
    config: dict
    seed: int
    device: object
    root: Path


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def workload(name: str) -> dict:
    path = PKG / "workloads" / f"{name}.json"
    if not path.is_file():
        raise NoResult(f"no cell {name!r}: {path} does not exist")
    return read_json(path)


def config(name: str) -> dict:
    path = PKG / "configs" / f"{name}.json"
    if not path.is_file():
        raise NoResult(f"no configuration {name!r}: {path} does not exist")
    return read_json(path)


def module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark, loaded from its path (names
    may hold dots and dashes)."""
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise NoResult(f"no {kind} module {name!r}: {path} does not exist")
    key = f"h100bench.{kind}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def cell_and_config(name: str, overrides: dict | None = None):
    """The cell's file and its configuration's, with ``overrides`` merged
    into the cell's ``params`` and ``limits`` and into its ``config`` (the
    tests' small sizes)."""
    cell = workload(name)
    overrides = overrides or {}
    cell = {**cell, **{k: {**cell[k], **v} for k, v in overrides.items()
                       if k in ("params", "limits")}}
    return cell, {**config(cell["config"]), **overrides.get("config", {})}


def cuda_device(device: str):
    """``device`` as a torch device, a CUDA one with its index."""
    import torch
    dev = torch.device(device)
    return torch.device("cuda", dev.index or 0) if dev.type == "cuda" else dev


def metrics_for(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metric entries a run of ``cell`` prints."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if "workloads" not in m
            or cell in m["workloads"]]


def seed_entropy(seed: int) -> int:
    """Any whole number as the non-negative entropy of a seed sequence."""
    return seed % (1 << 64)


def derived_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for a torch generator, from ``seed`` and a stream
    path (the same path gives the same seed)."""
    import numpy as np
    words = np.random.SeedSequence([seed_entropy(seed), *path]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def require_devices(chips: int):
    """Raise ``NoResult`` unless CUDA is there with ``chips`` cards."""
    import torch
    if not torch.cuda.is_available():
        raise NoResult("torch.cuda.is_available() is False: this benchmark "
                       "measures the program on a CUDA device and has no "
                       "other path")
    if torch.cuda.device_count() < chips:
        raise NoResult(f"the cell needs {chips} CUDA devices, "
                       f"torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}")


def loaded_banned() -> list[str]:
    """Top-level names of loaded modules that the benchmark's runs may not
    load, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED))


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def device_info(dev, chips: int) -> dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", require: bool = True,
             overrides: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line as a dict (the
    check's numbers last, under ``checks``).  ``require`` makes a run
    without the cell's CUDA devices raise ``NoResult``; the tests turn it
    off to drive the rest of a run on the CPU, with ``overrides`` merged
    into the cell's ``params`` and ``limits`` and into its ``config``."""
    import torch
    bench = benchmark()
    cell, cfg = cell_and_config(name, overrides)
    chips = int(cell["chips"])
    if require:
        require_devices(chips)
    dev = cuda_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ctx = Context(cell, cfg, seed, dev, ROOT)
    runner = module("traffic", cell["kind"]).Cell(ctx)
    runner.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - t0
    t_win = time.time()
    e2e = runner.window(seconds)
    t_win = time.time() - t_win
    wanted = metrics_for(bench, name, trace)
    metrics, breakdown, device_extra = {}, None, {}
    t_trace = time.time()
    if trace:
        reduced, counts = runner.traced()
        data = {"trace": reduced, "counts": {**counts, **e2e}, "cell": cell}
        for m in wanted:
            value = module("metrics", m["name"]).read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": reduced["device_ops"],
                     "idle_gaps": reduced["idle_gaps"]}
        device_extra = {"busy_s": reduced["busy_s"],
                        "window_s": reduced["window_s"]}
    else:
        values = {**e2e, "setup_s": setup_s}
        for m in wanted:
            if m["name"] not in values:
                raise NoResult(f"the cell measured no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    info = {**device_info(dev, chips), **device_extra}
    t_trace = time.time() - t_trace
    runner.release()
    t_check = time.time()
    checks, attempted, failed = runner.check()
    print(f"h100bench: set-up {setup_s:.1f} s, window {t_win:.1f} s, "
          f"trace {t_trace:.1f} s, check {time.time() - t_check:.1f} s",
          file=sys.stderr)
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks) \
        and bool(checks)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    limit = power_limit() if dev.type == "cuda" else None
    if limit:
        out["card"] = limit
    # a number that is not finite fails its check and prints as null
    out["checks"] = {n: {"value": v if math.isfinite(v) else None,
                         "limit": lim} for n, v, lim in checks}
    return out


def main(args, t0: float) -> int:
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t0)
    except NoResult as e:
        print(f"h100bench: {e}", file=sys.stderr)
        return 2
    found = loaded_banned()
    if found:
        print(f"h100bench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for n, c in out["checks"].items():
        ok = ("ok" if c["value"] is not None and c["value"] <= c["limit"]
              else "FAILED")
        print(f"check {n}: {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
