"""The port's own instrumentation (``utils/profiling.py``) on the CPU:

- ``span`` records nothing while no profiler records, and its name under
  a CPU profile;
- the spans of the search, the self-play actor and ``MCTSPlayer.play``
  are leaves that never overlap, and cover the paths they name;
- the backup's path counters equal the live levels and the installs of
  the launches' own inputs (a search's, and made-up ones);
- the host counters equal the searches, simulations, plies and requests
  run, and nothing counts without a profiler;
- ``cli/main.py --profile`` writes its trace through ``profiling.trace``
  and prints the counters.
"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from alphazero_tpu_torch.cli import main as MAIN
from alphazero_tpu_torch.cli import pit as PIT
from alphazero_tpu_torch.games.game_api import SplendorGame
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.ops import fused_backup as FB
from alphazero_tpu_torch.search import mcts as M
from alphazero_tpu_torch.train import selfplay as SP
from alphazero_tpu_torch.utils import profiling as PROF

CFG = E.SplendorConfig()
SEARCH_SPANS = {"mcts.root", "mcts.descent", "mcts.env_step",
                "mcts.evaluate", "mcts.store", "mcts.backup", "mcts.result"}


def _spans(prof):
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if getattr(e, "is_user_annotation", False))


def _engine(sims=4, batch=8, plies=2):
    sp = SP.SelfPlayConfig(batch_size=batch, num_sims=sims, ratio_full=2,
                           prob_full=0.5, max_moves=plies, chunk_moves=plies)
    return SP.SelfPlayEngine(CFG, A.make_uniform_eval_fn(CFG), sp,
                             device="cpu")


def _player(sims=4):
    game = SplendorGame(2, device="cpu")
    net = N.build_net(A.net_config_for(game.cfg), "cpu").eval()
    return game, PIT.MCTSPlayer(game, net, sims)


def _recorded(search, sims, log):
    """``search`` of ``sims`` simulations, each call's boards and
    simulations logged."""
    def run(params, roots, generator=None, noise_gamma=None):
        log.append((roots.shape[0], sims))
        return search(params, roots, generator=generator,
                      noise_gamma=noise_gamma)
    return run


class Counted:
    """What the profiled regions counted since the block began."""

    def __enter__(self):
        self.before = PROF.counters()
        return self

    def __exit__(self, *exc):
        after = PROF.counters()
        self.got = {k: v - self.before.get(k, 0) for k, v in after.items()
                    if v != self.before.get(k, 0)}


def test_span_records_only_under_a_profiler():
    assert PROF.span("a") is PROF.span("b")
    with PROF.span("test.outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with PROF.span("test.inside"):
            torch.ones(3).sum()
    names = [n for *_, n in _spans(prof)]
    assert names == ["test.inside"]
    with PROF.span("test.after"):
        pass
    assert PROF.span("c") is PROF.span("d")


@pytest.mark.parametrize("path", ["selfplay", "player"])
def test_spans_are_disjoint_leaves(path):
    if path == "selfplay":
        eng = _engine()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.run_games(None, torch.Generator().manual_seed(1))
        want = SEARCH_SPANS | {"selfplay.split", "selfplay.move",
                               "selfplay.host"}
    else:
        game, player = _player()
        boards = E.initial_state(game.cfg, 2, torch.Generator().manual_seed(2),
                                 "cpu").numpy()
        player.play(boards[0])                 # builds the search
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for b in boards:
                player.play(b)
        want = SEARCH_SPANS | {"player.upload", "player.answer"}
    spans = _spans(prof)
    assert {n for *_, n in spans} == want
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        assert start >= end, f"{b} starts inside {a}"


def _levels_installs(args):
    """Live levels and installs of ``backprop_packed``'s arguments."""
    path_p, depth, fresh, slot = args[0], args[3], args[8], args[9]
    levels = int(depth.long().clamp(0, path_p.shape[1]).sum())
    return levels, int((fresh & (slot != 0)).sum())


def _made_up_args(B=6, M_=9, A_=12, S1=5, P=3, seed=0):
    g = torch.Generator().manual_seed(seed)

    def ri(lo, hi, *shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g).to(dtype)
    stats = torch.randn((B, M_, 4, A_ + 2), generator=g)
    slot = ri(0, M_, B, dtype=torch.int32)
    slot[0] = 0                                    # fresh, but no install
    depth = ri(0, S1 + 4, B, dtype=torch.int32)    # some past the buffer
    fresh = ri(0, 2, B).bool()
    fresh[0] = True
    return stats, (ri(0, M_, B, S1, dtype=torch.int32),
                   ri(0, A_, B, S1, dtype=torch.int32),
                   ri(0, P, B, S1, dtype=torch.int32), depth,
                   torch.randn((B, P), generator=g), ri(0, P, B),
                   ri(0, M_, B), ri(0, A_, B), fresh, slot,
                   torch.rand((B, A_), generator=g), ri(0, 2, B).bool(),
                   ri(0, P, B), torch.randn(B, generator=g),
                   torch.randn((B, P), generator=g))


@pytest.mark.parametrize("case", ["search", "made_up"])
def test_path_counters_equal_the_launches_inputs(case, monkeypatch):
    calls = []
    if case == "search":
        def backup(stats, *args):
            calls.append(_levels_installs(args))
            return FB.backprop_packed(stats, *args)
        monkeypatch.setattr(M, "backprop_packed", backup)
        search = M.build_search(
            M.MCTSConfig(num_sims=24, max_depth=3, forced_playouts=True),
            2, A.make_uniform_eval_fn(CFG), A.make_search_step_fn(CFG),
            A.make_valid_fn(CFG), "cpu")
        roots = E.initial_state(CFG, 3, torch.Generator().manual_seed(0),
                                "cpu")
        with Counted() as c, profile(activities=[ProfilerActivity.CPU]):
            search(None, roots)
        assert len(calls) == 24
    else:
        with Counted() as c, profile(activities=[ProfilerActivity.CPU]):
            for seed in range(3):
                stats, args = _made_up_args(seed=seed)
                calls.append(_levels_installs(args))
                FB.backprop_packed(stats, *args)
    got = c.got
    levels = sum(c[0] for c in calls)
    installs = sum(c[1] for c in calls)
    assert installs > 0 and levels >= installs
    assert (got["mcts.path_levels"], got["mcts.installs"]) == \
        (levels, installs)


def test_host_counters_equal_the_work_run():
    eng = _engine(sims=4, batch=8, plies=2)
    log = []
    eng.search_full = _recorded(eng.search_full, 4, log)
    eng.search_fast = _recorded(eng.search_fast, eng.fast_sims, log)
    with Counted() as c, profile(activities=[ProfilerActivity.CPU]):
        eng.run_games(None, torch.Generator().manual_seed(1))
    got = c.got
    assert got["selfplay.plies"] == 2 and got["mcts.searches"] == len(log)
    assert got["mcts.board_sims"] == sum(b * s for b, s in log)
    # the path buffer is as wide as the tree's capacity less the root
    # (max_depth 64 is wider)
    assert got["mcts.path_cells"] == sum(b * s * s for b, s in log)
    assert "player.requests" not in got

    game, player = _player(sims=3)
    boards = E.initial_state(game.cfg, 2, torch.Generator().manual_seed(2),
                             "cpu").numpy()
    with Counted() as c, profile(activities=[ProfilerActivity.CPU]):
        for b in boards:
            player.play(b)
    got = c.got
    assert (got["player.requests"], got["mcts.searches"],
            got["mcts.board_sims"], got["mcts.path_cells"]) == (2, 2, 6, 18)


def test_nothing_counts_without_a_profiler():
    with Counted() as c:
        eng = _engine()
        eng.run_games(None, torch.Generator().manual_seed(1))
        game, player = _player(sims=2)
        player.play(E.initial_state(
            game.cfg, 1, torch.Generator().manual_seed(2), "cpu").numpy()[0])
        stats, args = _made_up_args()
        FB.backprop_packed(stats, *args)
        assert PROF.path_counter("cpu") is None
    assert c.got == {}


def test_main_profile_goes_through_trace(tmp_path, monkeypatch, capsys):
    """``--profile`` runs one iteration inside ``profiling.trace`` (the
    coach stood in for by one small search) and prints the counters."""
    traced = []
    real_trace = PROF.trace

    def trace(trace_dir, activities=None):
        traced.append(trace_dir)
        return real_trace(str(tmp_path / "torch-trace"), activities)
    monkeypatch.setattr(PROF, "trace", trace)

    class Coach:
        def __init__(self, cfg, device):
            self.cfg = cfg

        def learn(self, start_iter=1):
            search = M.build_search(
                M.MCTSConfig(num_sims=2), 2, A.make_uniform_eval_fn(CFG),
                A.make_search_step_fn(CFG), A.make_valid_fn(CFG), "cpu")
            search(None, E.initial_state(
                CFG, 2, torch.Generator().manual_seed(0), "cpu"))
    monkeypatch.setattr(MAIN, "Coach", Coach)
    with Counted() as c:
        MAIN._run(MAIN.build_parser().parse_args(
            ["--profile", "-C", str(tmp_path / "ckpt"), "--device", "cpu"]))
    assert (c.got["mcts.searches"], c.got["mcts.board_sims"]) == (1, 4)
    assert traced == ["./torch-trace"]
    assert os.path.getsize(tmp_path / "torch-trace" / PROF.TRACE_FILE) > 0
    with open(tmp_path / "torch-trace" / PROF.TRACE_FILE) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert SEARCH_SPANS <= names
    counters = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert counters == PROF.counters()
    assert counters["mcts.searches"] >= 1
    assert counters["mcts.board_sims"] >= 4
