"""The readers of the net's graph share, ``net.graph_share.selfplay`` and
``net.graph_share.move``: on hand-made counters (replays and eager calls,
only one of them, none, a program whose profiling module has no
counters), and (on a card) a warmed search under the profiler, whose
every leaf evaluation replays a graph."""

from __future__ import annotations

import pytest
import torch

from h100bench import core

CELLS = {"net.graph_share.selfplay": "splendor-2p-r6.selfplay",
         "net.graph_share.move": "splendor-4p-r12.move-b1"}


def _read(name, counters):
    data = {"trace": {"span_s": {}, "kernel_s": {}}, "counts": {"sims": 10},
            "cell": core.workload(CELLS[name])}
    if counters is not None:
        data["counters"] = counters
    return core.module("metrics", name).read(data)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_graph_share_readers(name, monkeypatch):
    other = {"mcts.searches": 3, "net.graph_captures": 0}
    assert _read(name, {"net.graph_replays": 990, "net.eager_calls": 10,
                        **other}) == pytest.approx(0.99)
    assert _read(name, {"net.graph_replays": 7}) == 1.0
    assert _read(name, {"net.eager_calls": 7}) == 0.0
    # the parent program: counters, but none of the net's
    assert _read(name, other) is None
    assert _read(name, {}) is None
    # a program whose profiling module has no counters
    from alphazero_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "counters")
    assert _read(name, None) is None


@pytest.mark.card
def test_warmed_search_replays_every_evaluation(card):
    from torch.profiler import ProfilerActivity, profile

    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.models import splendor_net as N
    from alphazero_tpu_torch.search import mcts as M
    from alphazero_tpu_torch.utils import profiling
    cfg = E.SplendorConfig(num_players=2)
    net = N.build_net(A.net_config_for(cfg), card)
    search = M.build_search(M.MCTSConfig(num_sims=8), 2,
                            A.make_eval_fn(net.cfg),
                            A.make_search_step_fn(cfg), A.make_valid_fn(cfg),
                            card)
    roots = E.initial_state(cfg, 16, torch.Generator(device=card)
                            .manual_seed(1), card)
    search(net, roots)                      # captured on the second sim
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        search(net, roots)
    got = {k: v - before.get(k, 0) for k, v in profiling.counters().items()}
    assert got.get("net.graph_replays") == 9
    assert got.get("net.eager_calls", 0) == 0
    assert got.get("net.graph_captures", 0) == 0
    assert _read("net.graph_share.selfplay", got) == 1.0
