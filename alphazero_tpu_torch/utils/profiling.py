"""Structured tracing/profiling on ``torch.profiler`` (reference uses
cProfile dumps, main.py:82-100 / pit.py:205-221).

Port of ``alphazero_tpu/utils/profiling.py``, whose ``jax.profiler`` trace
and xprof op tables become a ``torch.profiler`` trace and the profiler's
own event records: no xprof is needed.

    with profiling.trace("./torch-trace"):
        run_one_iteration()
    profiling.print_top_ops("./torch-trace")
    print(profiling.counters())

The program's own instrumentation lives here too, and costs one flag check
while no profiler records:

- ``span(name)``: a host span (``record_function``), on the profiler's
  clock beside the device's kernels.  The program's spans are leaves, never
  nested, so each host interval belongs to at most one.
- ``count(name, n)``: a host counter (searches, simulations, plies,
  requests, the net's graph replays, captures and eager calls).
- ``path_counter(device)``: the buffer in which the search's backup counts
  its live path levels and its child installs (``mcts.path_levels``,
  ``mcts.installs``), on the device, with no launch of its own.

``counters()`` returns what every profiled region of the process counted.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os

import torch
from torch.autograd import DeviceType
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

log = logging.getLogger(__name__)

TRACE_FILE = "trace.json"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_NO_SPAN = contextlib.nullcontext()
_counts: dict[str, int] = {}
# device -> int64 [1]: live path levels in the low 32 bits, child installs
# above them (one atomic add per board); emptied into _counts by counters()
_path_counters: dict[torch.device, torch.Tensor] = {}
PATH_LEVEL_BITS = 32


def span(name: str):
    """A host span named ``name`` while a profiler records (a
    ``record_function``), else a shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


def recording() -> bool:
    """Whether a profiler records."""
    return _autograd_profiler._is_profiler_enabled


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to counter ``name`` while a profiler
    records."""
    if _autograd_profiler._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


def path_counter(device) -> torch.Tensor | None:
    """The int64 ``[1]`` buffer that the backup on ``device`` adds its
    live levels and installs to, ``levels + installs << 32`` per board,
    while a profiler records; else None.  Made once per device by a copy
    from the host, so it launches no kernel."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    device = torch.device(device)
    buf = _path_counters.get(device)
    if buf is None:
        buf = _path_counters[device] = torch.tensor([0], dtype=torch.int64,
                                                    device=device)
    return buf


def counters() -> dict[str, int]:
    """Every counter the process's profiled regions counted, the devices'
    path counts included (reading them waits for each device once)."""
    mask = (1 << PATH_LEVEL_BITS) - 1
    for buf in _path_counters.values():
        v = int(buf.item())
        if v:
            buf.sub_(v)
            for name, n in (("mcts.path_levels", v & mask),
                            ("mcts.installs", v >> PATH_LEVEL_BITS)):
                _counts[name] = _counts.get(name, 0) + n
    return dict(_counts)


@contextlib.contextmanager
def trace(trace_dir: str, activities=None):
    """Profile the block and write its Chrome trace (viewable in Perfetto,
    ``chrome://tracing`` or TensorBoard) to ``trace_dir/trace.json``;
    yields the ``torch.profiler.profile``.  ``activities`` defaults to the
    host's ops and spans, and the CUDA kernels beside them when a GPU is
    present."""
    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("trace written to %s", path)


def _device_events(src):
    """``(name, duration_us, type)`` of every device op in ``src``: a
    ``torch.profiler.profile`` or a directory holding a trace file.  The
    device ops are the GPU kernels, copies and memsets (user annotations
    are host spans, not ops); a trace with none (a CPU run) gives its CPU
    ops instead."""
    if isinstance(src, profile):
        raw = src.events()
        # annotations (record_function ranges) also show on the device
        # timeline, under the name of their host range
        spans = {e.name for e in raw if e.device_type == DeviceType.CPU
                 and getattr(e, "is_user_annotation", False)}
        events = [(e.name, e.time_range.elapsed_us(),
                   "kernel" if e.device_type == DeviceType.CUDA else "cpu_op")
                  for e in raw if e.name not in spans
                  and not getattr(e, "is_user_annotation", False)]
    else:
        files = sorted(glob.glob(os.path.join(src, "*.json")),
                       key=os.path.getmtime)
        if not files:
            log.warning("no trace under %s", src)
            return []
        with open(files[-1]) as f:
            events = [(e["name"], float(e["dur"]), e.get("cat", ""))
                      for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e[2] in _DEVICE_CATS]
    return device or [e for e in events if e[2] == "cpu_op"]


def top_ops(src, n: int | None = 20):
    """Top device ops by total time from a profile or a trace directory:
    list of ``(total_us, occurrences, op_type, name)``, largest first
    (``n=None``: all of them)."""
    agg: dict[tuple[str, str], list] = {}
    for name, us, typ in _device_events(src):
        row = agg.setdefault((typ, name), [0.0, 0])
        row[0] += us
        row[1] += 1
    out = sorted(((tot, cnt, typ, name)
                  for (typ, name), (tot, cnt) in agg.items()), reverse=True)
    return out if n is None else out[:n]


def print_top_ops(src, n: int = 20):
    ops = top_ops(src, n)
    if ops:
        print(f"{'total_us':>12} {'count':>7}  type / op")
    for tot, occ, typ, name in ops:
        print(f"{tot:>12,.0f} {occ:>7}  {typ:<22} {name[:90]}")
