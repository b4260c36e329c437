"""The program's counters of the traced slice, for the per-layer metric
readers: what ``alphazero_tpu_torch.utils.profiling.counters()`` returns
after the slice (the only region the run profiles), read once per run and
kept in ``data["counters"]``.  A program without them gives no counters,
and the readers then return None."""

from __future__ import annotations


def counters(data) -> dict:
    if "counters" not in data:
        from alphazero_tpu_torch.utils import profiling
        read = getattr(profiling, "counters", None)
        data["counters"] = read() if read is not None else {}
    return data["counters"]


def span_ms_per(data, names, counter: str) -> float | None:
    """Host milliseconds inside the spans ``names`` per unit of the
    program's counter ``counter``."""
    n = counters(data).get(counter)
    spans = data["trace"]["span_s"]
    if not n or not any(s in spans for s in names):
        return None
    return sum(spans.get(s, 0.0) for s in names) * 1e3 / n
