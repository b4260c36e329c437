"""The share of the traced slice's leaf evaluations on the card that
replayed a CUDA graph of the net: the program's counters
``net.graph_replays`` over those plus ``net.eager_calls``.  A program
without them (no graphed evaluator) gives None."""

from __future__ import annotations

from h100bench.metrics import _counters as C


def graph_share(data) -> float | None:
    c = C.counters(data)
    replays, eager = c.get("net.graph_replays", 0), c.get("net.eager_calls", 0)
    if not replays + eager:
        return None
    return replays / (replays + eager)
