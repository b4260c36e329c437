"""Reduction of a ``torch.profiler`` trace of the traced slice to the
numbers the per-layer metrics read.

The slice runs inside the annotation ``h100bench.window``; its interval on
the profiler's clock is the traced window.  Device operations are the
events whose activity is a kernel, a copy or a memset; host spans are the
program's ``record_function`` annotations (``mcts.descent``,
``mcts.env_step``, ``mcts.evaluate``, ``mcts.backup``)."""

from __future__ import annotations

import bisect
import contextlib

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "h100bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class NoDeviceWork(RuntimeError):
    """The profiler saw no device kernel in the traced window."""


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the block, host ops and (on a GPU) device ops, inside the
    window annotation; yields the profiler."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield prof
            if device.type == "cuda":
                torch.cuda.synchronize(device)


def events(prof):
    """``(window (start, end), device ops [(start, end, name, kind)], host
    spans [(start, end, name)])`` in seconds on the profiler's clock.  A
    device op is a CUDA event that is no annotation; copies and memsets go
    by their names."""
    raw = prof.events()
    spans = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
             for e in raw if e.device_type == DeviceType.CPU
             and getattr(e, "is_user_annotation", False)]
    names = {n for _, _, n in spans}
    dev = []
    for e in raw:
        if e.device_type != DeviceType.CUDA or e.name in names \
                or getattr(e, "is_user_annotation", False):
            continue
        kind = ("gpu_memcpy" if e.name.startswith("Memcpy") else
                "gpu_memset" if e.name.startswith("Memset") else "kernel")
        dev.append((e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                    e.name, kind))
    window = [(s, t) for s, t, n in spans if n == WINDOW]
    if not window:
        raise RuntimeError("the profiler kept no window annotation")
    return window[0], dev, [sp for sp in spans if sp[2] != WINDOW]


def reduce(window, dev, spans) -> dict:
    """The traced window's numbers: ``window_s``; ``busy_s`` (the union of
    the device ops' intervals inside it); ``kernels`` (kernel launches, not
    copies or memsets); ``kernel_s`` {name: (seconds, count)};
    ``span_s`` {name: host seconds}; ``device_ops`` (the ten ops with the
    most device time) and ``idle_gaps`` (device idle time by the host span
    it fell in, the ten largest).  Spans must not overlap one another.  Raises ``NoDeviceWork`` when no kernel
    ran in the window."""
    w0, w1 = window
    ops = sorted((max(s, w0), min(t, w1), n, k) for s, t, n, k in dev
                 if t > w0 and s < w1)
    n_kernels = sum(1 for *_, k in ops if k == "kernel")
    if n_kernels == 0:
        raise NoDeviceWork("no device kernel ran in the traced window")
    kernel_s: dict[str, list] = {}
    for s, t, n, _ in ops:
        row = kernel_s.setdefault(n, [0.0, 0])
        row[0] += t - s
        row[1] += 1
    busy, gaps, cur = 0.0, [], w0
    for s, t, _, _ in ops:
        if s > cur:
            gaps.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if w1 > cur:
        gaps.append((cur, w1))
    spans = sorted(sp for sp in spans if sp[1] > w0 and sp[0] < w1)
    span_s: dict[str, float] = {}
    for s, t, n in spans:
        span_s[n] = span_s.get(n, 0.0) + min(t, w1) - max(s, w0)
    # the program's spans follow one another; a gap's time goes to the
    # spans it overlaps, and the rest of it to the time outside them
    starts = [s for s, _, _ in spans]
    idle: dict[str, float] = {}

    def add(name, secs):
        idle[name] = idle.get(name, 0.0) + secs
    for g0, g1 in gaps:
        i, cur = max(bisect.bisect_right(starts, g0) - 1, 0), g0
        while cur < g1:
            if i >= len(spans) or spans[i][0] >= g1:
                add("outside the spans", g1 - cur)
                cur = g1
            elif spans[i][1] <= cur:
                i += 1
            elif spans[i][0] > cur:
                add("outside the spans", spans[i][0] - cur)
                cur = spans[i][0]
            else:
                end = min(spans[i][1], g1)
                add(spans[i][2], end - cur)
                cur, i = end, i + 1
    top_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "window_s": w1 - w0, "busy_s": busy, "kernels": n_kernels,
        "kernel_s": {n: tuple(v) for n, v in kernel_s.items()},
        "span_s": span_s,
        "device_ops": [[n[:120], v[0]] for n, v in top_ops],
        "idle_gaps": [[n, s] for n, s in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def kernel_time(reduced: dict, fragment: str) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds
    ``fragment``."""
    secs = n = 0
    for name, (s, c) in reduced["kernel_s"].items():
        if fragment in name:
            secs += s
            n += c
    return secs, n
