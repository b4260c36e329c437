"""The benchmark's plain reference against the program's plain versions on
the CPU, at tiny sizes, on the same inputs: the env step with chance
draws, the in-tree step, the v1 net read from a checkpoint, the search,
and the actor of a whole ``run_games`` call."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from h100bench import core, program
from h100bench.reference import env as RE
from h100bench.reference import search as RS

from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.ops import env_step as ES
from alphazero_tpu_torch.search import mcts as M

CPU = torch.device("cpu")


def _playout_states(players: int, n: int, plies: int, seed: int):
    """States of seeded random legal play (with chance), from the
    program's env."""
    cfg = E.SplendorConfig(num_players=players)
    g = torch.Generator().manual_seed(seed)
    s = E.initial_state(cfg, n, g, "cpu")
    out = [s]
    for _ in range(plies):
        v = E.valid_moves(cfg, s, 0)
        a = torch.where(v, torch.rand(v.shape, generator=g), -1.0).argmax(-1)
        s, _ = E.step(cfg, s, a, 0, torch.rand(n, 2, generator=g), False)
        s = E.swap_players(cfg, s, 1)
        out.append(s)
    return cfg, torch.cat(out)


@pytest.mark.parametrize("players", [2, 3, 4])
def test_env_step_with_chance_equal(players):
    cfg, states = _playout_states(players, 8, 12, players)
    rcfg = RE.SplendorConfig(num_players=players)
    g = torch.Generator().manual_seed(7)
    valid = E.valid_moves(cfg, states, 0)
    assert torch.equal(valid, RE.valid_moves(rcfg, states, 0))
    a = torch.where(valid, torch.rand(valid.shape, generator=g), -1.0) \
        .argmax(-1)
    u = torch.rand(len(states), 2, generator=g)
    s_p, n_p = E.step(cfg, states, a, 0, u, False)
    s_r, n_r = RE.step(rcfg, states, a, 0, u, False)
    assert torch.equal(s_p, s_r) and torch.equal(n_p, n_r)
    assert torch.equal(E.check_end_game(cfg, s_p),
                       RE.check_end_game(rcfg, s_r))
    assert torch.equal(E.swap_players(cfg, s_p, 1),
                       RE.swap_players(rcfg, s_r, 1))


@pytest.mark.parametrize("players", [2, 4])
def test_in_tree_step_equal_over_every_action(players):
    cfg, states = _playout_states(players, 3, 8, 10 + players)
    rcfg = RE.SplendorConfig(num_players=players)
    s = states.repeat_interleave(409, 0)
    a = torch.arange(409).repeat(len(states))
    got = ES.search_step_plain(cfg, s, a)
    want = RS.search_step(rcfg, s, a)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def r6():
    cfg = core.config("splendor-2p-r6")
    ck = program.checkpoint(core.ROOT, cfg)
    net, net_cfg = program.build_net(cfg, ck, CPU)
    return cfg, ck, net, net_cfg


def test_net_equal(r6):
    cfg, ck, net, net_cfg = r6
    ecfg, states = _playout_states(2, 16, 20, 3)
    valid = E.valid_moves(ecfg, states, 0)
    probs, v = A.make_eval_fn(net_cfg)(net, states.float(), valid)
    rp, rv = program.ref_net(cfg, ck, CPU)(states.float(), valid)
    assert torch.allclose(probs, rp, rtol=1e-5, atol=1e-6)
    assert torch.allclose(v, rv, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("noise", [False, True])
def test_search_equal(r6, noise):
    cfg, ck, net, net_cfg = r6
    ecfg, states = _playout_states(2, 3, 10, 5)
    roots = states[-3:]
    mc = M.MCTSConfig(num_sims=24, cpuct=1.0, fpu=0.0, forced_playouts=noise,
                      add_noise=noise, prior_temp=1.25 if noise else 1.0,
                      max_depth=64)
    search = M.build_search(mc, 2, A.make_eval_fn(net_cfg),
                            A.make_search_step_fn(ecfg), A.make_valid_fn(ecfg),
                            "cpu")
    gamma = torch._standard_gamma(
        torch.full((3, 409), 0.2), generator=torch.Generator().manual_seed(1))
    res = search(net, roots, noise_gamma=gamma if noise else None)
    rc = RS.SearchConfig(num_sims=24, forced_playouts=noise, add_noise=noise,
                         prior_temp=1.25 if noise else 1.0, max_depth=64)
    ref = RS.run(rc, RE.SplendorConfig(), program.ref_net(cfg, ck, CPU),
                 roots, gamma if noise else None)
    assert torch.equal(res.raw_counts, ref["raw_counts"])
    assert torch.equal(res.counts, ref["counts"])
    for k in ("q", "root_value", "root_prior"):
        assert torch.allclose(getattr(res, k), ref[k], rtol=1e-5, atol=1e-6)


def test_actor_replay_agrees_with_run_games():
    """A whole tiny self-play run on the CPU: the reference actor's replay
    finds no difference, and the searches agree with the reference."""
    out = core.run_cell(
        "splendor-2p-r6.selfplay", 2 ** 33 + 1, 0.0, False, 0.0,
        device="cpu", require=False,
        overrides={"config": {"selfplay_batch": 6, "num_sims": 8},
                   "params": {"plies": 3, "check_plies": 2}})
    assert out["correct"], out["checks"]
    assert out["checks"]["actor_diffs"]["value"] == 0
    assert out["checks"]["visits_tv"]["value"] == 0


def test_position_pool_mid_game():
    from h100bench.traffic.move_b1 import position_pool
    cfg = RE.SplendorConfig(num_players=4)
    pool = position_pool(cfg, 12, (3, 6), 11, "cpu")
    # the env's counter ticks once a ply; a round is one ply of each seat
    rounds = RE.get_round(cfg, pool) // cfg.num_players
    assert pool.shape == (12, cfg.rows, 7)
    assert bool(((rounds >= 3) & (rounds <= 6)).all()), rounds
    assert not bool(RE.check_end_game(cfg, pool).abs().sum(-1).gt(0).any())
    again = position_pool(cfg, 12, (3, 6), 11, "cpu")
    assert torch.equal(pool, again)
    assert np.unique(pool.reshape(12, -1).numpy(), axis=0).shape[0] == 12
