"""Arithmetic the per-layer metric readers share.  Each reader returns
None where its cell's data holds nothing to read."""

from __future__ import annotations

SEARCH_SPANS = ("mcts.descent", "mcts.env_step", "mcts.evaluate",
                "mcts.backup")


def idle_share(data) -> float:
    t = data["trace"]
    return 1.0 - t["busy_s"] / t["window_s"]


def kernels_per_sim(data) -> float | None:
    sims = data["counts"].get("sims")
    return data["trace"]["kernels"] / sims if sims else None


def span_ms_per_sim(data, names) -> float | None:
    sims = data["counts"].get("sims")
    spans = data["trace"]["span_s"]
    if not sims or not any(n in spans for n in names):
        return None
    return sum(spans.get(n, 0.0) for n in names) * 1e3 / sims


def search_share(data) -> float | None:
    spans = data["trace"]["span_s"]
    if not any(n in spans for n in SEARCH_SPANS):
        return None
    return sum(spans.get(n, 0.0) for n in SEARCH_SPANS) \
        / data["trace"]["window_s"]
