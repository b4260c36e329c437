"""The port's Splendor env against the numpy rules oracle, and its
invariants.

``tests/test_env_parity.py`` plays random games on the JAX env and on
``oracle/splendor_oracle.py`` with the same injected uniforms; here the
port's env (``alphazero_tpu_torch/games/splendor/env.py``) plays them, on
the same seeds: 2, 3 and 4 players, the deterministic mode, a handicap token
limit and seat swaps, every state byte-equal to the oracle's after every
move, every valid-move mask and end-of-game vector equal.  Then the seven
invariants of ``tests/test_env_properties.py`` on the port's env: gem and
card conservation, the token limit, pass only as a fallback, the initial
state's structure, a batched step and the deterministic mode's empty
slots."""

import numpy as np
import pytest
import torch

from alphazero_tpu_torch.games.splendor import env as E
from oracle.splendor_oracle import OracleBoard


def _init(cfg, u24, nobles):
    return E.init_with_uniforms(cfg, torch.from_numpy(u24[None]),
                                torch.from_numpy(np.asarray(nobles)[None]))


def _step(cfg, state, action, player, u, deterministic):
    s2, nxt = E.step(cfg, state, torch.tensor([int(action)]), player,
                     torch.from_numpy(u[None]), deterministic)
    return s2, int(nxt[0])


def _play_parity_game(num_players, seed, max_steps=400, deterministic=False,
                      token_limit=10):
    """One random game on the port's env (one board) and on the oracle, as
    ``tests/test_env_parity.py`` plays it on the JAX env."""
    rng = np.random.default_rng(seed)
    cfg = E.SplendorConfig(num_players=num_players, token_limit=token_limit)
    u24 = rng.random(24).astype(np.float32)
    nobles = rng.choice(10, size=cfg.num_nobles, replace=False)

    state = _init(cfg, u24, nobles)
    ob = OracleBoard(num_players, token_limit=token_limit)
    ob.init_with(u24, nobles)
    np.testing.assert_array_equal(state[0].numpy(), ob.state,
                                  err_msg="init mismatch")

    player = 0
    for step_i in range(max_steps):
        vt = E.valid_moves(cfg, state, player)[0].numpy()
        vo = ob.valid_moves(player)
        np.testing.assert_array_equal(
            vt, vo, err_msg=f"valid mismatch at step {step_i}\n"
                            f"port={np.flatnonzero(vt)}\n"
                            f"oracle={np.flatnonzero(vo)}")
        assert vt.any(), "no valid action (pass must be a fallback)"

        action = rng.choice(np.flatnonzero(vo))
        u = rng.random(2).astype(np.float32)
        state, nxt = _step(cfg, state, action, player, u, deterministic)
        nxt_o = ob.make_move(action, player, deterministic, u[0], u[1])
        np.testing.assert_array_equal(
            state[0].numpy(), ob.state,
            err_msg=f"state mismatch after action {action} at step {step_i}")
        assert nxt == nxt_o

        et = E.check_end_game(cfg, state)[0].numpy()
        np.testing.assert_allclose(et, ob.check_end_game(),
                                   err_msg=f"end mismatch step {step_i}")
        player = nxt
        if et.any():
            return step_i + 1
    return max_steps


@pytest.mark.parametrize("num_players,seed",
                         [(2, s) for s in range(6)]
                         + [(3, 100 + s) for s in range(3)]
                         + [(4, 200 + s) for s in range(2)])
def test_random_game_parity(num_players, seed):
    assert _play_parity_game(num_players, seed) > 10


def test_random_game_parity_deterministic_mode():
    # deterministic=True collapses chance: slots empty out, still must agree
    _play_parity_game(2, 42, max_steps=60, deterministic=True)


def test_handicap_token_limit_parity():
    _play_parity_game(2, 7, token_limit=8)


def test_swap_players_parity():
    rng = np.random.default_rng(3)
    for n in (2, 3, 4):
        cfg = E.SplendorConfig(num_players=n)
        u24 = rng.random(24).astype(np.float32)
        nobles = rng.choice(10, size=cfg.num_nobles, replace=False)
        state = _init(cfg, u24, nobles)
        ob = OracleBoard(n)
        ob.init_with(u24, nobles)
        # a few random moves, so that the players' areas differ
        player = 0
        for _ in range(8):
            a = rng.choice(np.flatnonzero(ob.valid_moves(player)))
            u = rng.random(2).astype(np.float32)
            ob.make_move(a, player, False, u[0], u[1])
            state, player = _step(cfg, state, a, player, u, False)
        for k in range(n):
            ob2 = OracleBoard(n)
            ob2.state = ob.state.copy()
            ob2.swap_players(k)
            np.testing.assert_array_equal(
                E.swap_players(cfg, state, k)[0].numpy(), ob2.state,
                err_msg=f"n={n} k={k}")


# ------------------------------------------------------------- invariants
def _random_rollout(cfg, seed, steps=120, deterministic=False):
    rng = np.random.default_rng(seed)
    u24 = rng.random(24).astype(np.float32)
    nobles = rng.choice(10, size=cfg.num_nobles, replace=False)
    state = _init(cfg, u24, nobles)
    player = 0
    trace = [state[0].numpy()]
    for _ in range(steps):
        v = E.valid_moves(cfg, state, player)[0].numpy()
        if not v.any():
            break
        a = rng.choice(np.flatnonzero(v))
        u = rng.random(2).astype(np.float32)
        state, player = _step(cfg, state, a, player, u, deterministic)
        trace.append(state[0].numpy())
        if E.check_end_game(cfg, state)[0].numpy().any():
            break
    return trace


@pytest.mark.parametrize("n", [2, 3, 4])
def test_gem_conservation(n):
    cfg = E.SplendorConfig(num_players=n)
    for seed in range(3):
        for st in _random_rollout(cfg, seed):
            bank = st[0, :6].astype(np.int64)
            pg = st[cfg.row_pgems:cfg.row_pgems + n, :6].astype(np.int64)
            total = bank + pg.sum(0)
            assert (total[:5] == cfg.num_gems_in_play).all(), total
            assert total[5] == 5
            assert (bank >= 0).all()
            assert (pg >= 0).all()


@pytest.mark.parametrize("n", [2, 3])
def test_card_conservation(n):
    """All 90 cards are accounted for: decks, visible (gain rows), reserved
    and bought."""
    cfg = E.SplendorConfig(num_players=n)
    for st in _random_rollout(cfg, 11, steps=200):
        decks = st[cfg.row_decks:cfg.row_decks + 6:2, :5].astype(
            np.int64).sum()
        visible = (st[2:25:2, :5].astype(np.int64).sum(1) > 0).sum()
        rsv = st[cfg.row_prsv:cfg.row_prsv + 6 * n]
        reserved = (rsv[1::2, :5].astype(np.int64).sum(1) > 0).sum()
        bought = st[cfg.row_pcards:cfg.row_pcards + n, :5].astype(
            np.int64).sum()
        assert decks + visible + reserved + bought == 90


def test_token_limit_never_exceeded():
    cfg = E.SplendorConfig(num_players=2)
    for seed in range(4):
        for st in _random_rollout(cfg, 40 + seed):
            pg = st[cfg.row_pgems:cfg.row_pgems + 2, :6].astype(np.int64)
            assert (pg.sum(1) <= cfg.token_limit + 1).all()


def test_pass_only_when_nothing_else():
    cfg = E.SplendorConfig(num_players=2)
    st = E.initial_state(cfg, 1, torch.Generator().manual_seed(0), "cpu")
    v = E.valid_moves(cfg, st, 0)[0].numpy()
    assert v[:408].any() and not v[408]


def test_initial_state_structure():
    cfg = E.SplendorConfig(num_players=2)
    st = E.initial_state(cfg, 1, torch.Generator().manual_seed(1),
                         "cpu")[0].numpy()
    assert st.shape == (56, 7)
    assert (st[0, :5] == 4).all() and st[0, 5] == 5
    assert (st[2:25:2, :5].sum(1) > 0).all()          # 12 visible cards
    # deck counts: 8*5-4, 6*5-4, 4*5-4 remaining
    decks = st[25:31:2, :5].astype(np.int64).sum(1)
    np.testing.assert_array_equal(decks, [36, 26, 16])
    assert (st[31:34, 6] == 3).all()                  # 3 nobles of 3 points


def test_batched_step():
    cfg = E.SplendorConfig(num_players=2)
    B = 32
    g = torch.Generator().manual_seed(0)
    states = E.initial_state(cfg, B, g, "cpu")
    assert states.shape == (B, 56, 7)
    valids = E.valid_moves(cfg, states, 0)
    assert valids.shape == (B, 409)
    # the first valid action of every board, all stepped at once
    actions = valids.to(torch.int8).argmax(1)
    states2, nxt = E.step(cfg, states, actions, 0, torch.rand(B, 2,
                                                              generator=g),
                          False)
    assert states2.shape == (B, 56, 7)
    assert (nxt == 1).all()
    assert (states2[:, 0, 6] == 1).all()              # the round counter


def test_deterministic_mode_no_refill():
    """Take gems until a buy is affordable, then check that a deterministic
    buy leaves the board slot empty (no chance refill)."""
    cfg = E.SplendorConfig(num_players=2)
    st = E.initial_state(cfg, 1, torch.Generator().manual_seed(2), "cpu")
    player, zeros = 0, np.zeros(2, np.float32)
    for _ in range(40):
        v = E.valid_moves(cfg, st, player)[0].numpy()
        buys = np.flatnonzero(v[:12])
        if len(buys):
            a = int(buys[0])
            st2, _ = _step(cfg, st, a, player, zeros, True)
            assert st2[0, 1 + 2 * a:3 + 2 * a].sum() == 0   # slot left empty
            return
        takes = np.flatnonzero(v[30:60]) + 30
        a = int(takes[0]) if len(takes) else int(np.flatnonzero(v)[0])
        st, player = _step(cfg, st, a, player, zeros, True)
    pytest.fail("no buy became affordable within 40 moves")
