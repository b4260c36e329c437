"""Port parity: the host Game API, move strings, board rendering and the
board DSL against the JAX package.

- ``SplendorGame`` (2/3/4 players): every method's result is byte-equal to
  the JAX API's on the same boards, over a 30-move game that both APIs
  drive from the same numpy seed (moves drawn from ``default_rng(seed)``,
  chance uniforms from each API's own ``default_rng(seed)``), the
  deterministic step of every move's candidate included.
- The games start from boards that the port's ``env.init_with_uniforms``
  builds from numpy uniforms: ``getInitBoard`` and ``getSymmetries`` draw
  from JAX keys in the JAX API, which the port cannot reproduce.  Each
  API's 8 symmetry draws are held to the group itself, enumerated with the
  port's ``symmetry.apply_symmetry`` over every choice.
- ``move_to_str`` and ``row_to_str`` are equal for every action and row,
  and ``print_board`` prints the same text.
- ``spec_to_state`` / ``state_to_spec`` are equal on the JAX tests' demo
  spec in both seats' frames; unknown codes raise in both.
"""

import contextlib
import io
import itertools

import numpy as np
import pytest
import torch

from alphazero_tpu.games import game_api as JAPI
from alphazero_tpu.games.splendor import board_dsl as JD
from alphazero_tpu.games.splendor import render as JRENDER
from alphazero_tpu.games.splendor import strings as JS
from alphazero_tpu_torch.games import game_api as API
from alphazero_tpu_torch.games.splendor import board_dsl as D
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.games.splendor import render as RENDER
from alphazero_tpu_torch.games.splendor import strings as S
from alphazero_tpu_torch.games.splendor import symmetry as SYM
from tests.test_board_dsl import _demo_spec
from tests.test_torch_port_train import _one_thread  # noqa: F401

PLAYERS = [2, 3, 4]


def init_board(num_players, seed):
    """One initial board from numpy uniforms (``tests/test_torch_port_env.py``
    holds ``init_with_uniforms`` byte-equal to the JAX env's)."""
    rng = np.random.default_rng(seed)
    u = rng.random(24, dtype=np.float32)
    nob = rng.permutation(10)[:{2: 3, 3: 4, 4: 5}[num_players]]
    cfg = E.SplendorConfig(num_players=num_players)
    return E.init_with_uniforms(cfg, torch.from_numpy(u)[None],
                                torch.from_numpy(nob)[None])[0].numpy()


def games(num_players, seed):
    return (JAPI.SplendorGame(num_players, seed=seed),
            API.SplendorGame(num_players, seed=seed, device="cpu"))


def assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("num_players", PLAYERS)
def test_game_api_equal_over_a_game(num_players):
    seed = 10 + num_players
    jg, g = games(num_players, seed)
    for name in ("getBoardSize", "getActionSize", "getMaxScoreDiff",
                 "getNumberOfPlayers"):
        assert getattr(g, name)() == getattr(jg, name)()
    board = init_board(num_players, seed)
    player = 0
    pick = np.random.default_rng(seed)
    for move in range(30):
        canon, jcanon = (g.getCanonicalForm(board, player),
                         jg.getCanonicalForm(board, player))
        assert_same(canon, jcanon)
        assert g.stringRepresentation(canon) == jg.stringRepresentation(jcanon)
        valids = g.getValidMoves(canon, 0)
        assert_same(valids, jg.getValidMoves(canon, 0))
        assert_same(g.getValidMoves(board, player),
                    jg.getValidMoves(board, player))
        assert_same(g.getGameEnded(board), jg.getGameEnded(board))
        assert g.getRound(board) == jg.getRound(board)
        for seat in range(num_players):
            assert g.getScore(board, seat) == jg.getScore(board, seat)
        a = int(pick.choice(np.flatnonzero(valids)))
        assert g.moveToString(a) == jg.moveToString(a)
        # a deterministic step from the mover's frame draws too (as the
        # greedy and alpha-beta players' candidates do)
        det, jdet = (g.getNextState(canon, 0, a, deterministic=True),
                     jg.getNextState(canon, 0, a, deterministic=True))
        assert_same(det[0], jdet[0])
        assert det[1] == jdet[1]
        nxt, jnxt = (g.getNextState(board, player, a),
                     jg.getNextState(board, player, a))
        assert_same(nxt[0], jnxt[0])
        assert nxt[1] == jnxt[1]
        board, player = nxt
    assert g.getRound(board) == 30
    g.disableReserve()
    jg.disableReserve()
    assert not g.cfg.enable_reserve
    assert_same(g.getValidMoves(board, player),
                jg.getValidMoves(board, player))
    g.enableReserve()
    assert g.cfg == E.SplendorConfig(num_players=num_players)


@pytest.mark.parametrize("num_players", PLAYERS)
def test_init_board_and_symmetries_of_the_group(num_players):
    jg, g = games(num_players, 3)
    init = g.getInitBoard()
    jinit = jg.getInitBoard()
    assert init.dtype == jinit.dtype == np.int8
    assert init.shape == jinit.shape == g.getBoardSize()
    cfg = g.cfg
    # 12 visible cards and the nobles are out, the bank is full
    assert_same(init[0], jinit[0])
    assert (init[cfg.row_cards:cfg.row_decks:2, :5].sum(1) > 0).all()
    assert (init[cfg.row_nobles:cfg.row_nobles + cfg.num_nobles, 6] > 0).all()
    assert g.getInitBoard().tobytes() != init.tobytes()

    # a mid-game board with reserved cards, its policy and valid moves
    board, player = init_board(num_players, 7), 0
    pick = np.random.default_rng(7)
    for _ in range(12):
        valids = g.getValidMoves(board, player)
        rsv = np.flatnonzero(valids[12:27]) + 12
        a = int(pick.choice(rsv if len(rsv) else np.flatnonzero(valids)))
        board, player = jg.getNextState(board, player, a)
    board = np.array(jg.getCanonicalForm(board, player))
    valids = g.getValidMoves(board, 0)
    pi = np.random.default_rng(8).random(409).astype(np.float32) * valids
    # the whole group: every tier choice and reserve choice
    choices = list(itertools.product(range(4), range(4), range(4),
                                     *[range(3)] * num_players))
    ch = torch.tensor(choices)
    k = len(choices)
    sb, sp, sv = SYM.apply_symmetry(
        cfg, torch.from_numpy(board)[None].repeat(k, 1, 1),
        torch.from_numpy(pi)[None].repeat(k, 1),
        torch.from_numpy(valids)[None].repeat(k, 1), ch[:, :3], ch[:, 3:])
    group = {(b.numpy().tobytes(), p.numpy().tobytes(), v.numpy().tobytes())
             for b, p, v in zip(sb, sp, sv)}
    assert len(group) > 4
    for api in (g, jg):
        draws = api.getSymmetries(board, pi, valids)
        assert len(draws) == 8
        for b, p, v in draws:
            assert b.dtype == np.int8 and p.dtype == np.float32
            key = (np.asarray(b).tobytes(), np.asarray(p).tobytes(),
                   np.asarray(v).tobytes())
            assert key in group


def test_move_and_row_strings_equal():
    for a in range(409):
        assert S.move_to_str(a) == JS.move_to_str(a)
    for n in PLAYERS:
        rows = E.SplendorConfig(num_players=n).rows
        for r in range(rows + 2):
            assert S.row_to_str(r, n) == JS.row_to_str(r, n)


@pytest.mark.parametrize("num_players", PLAYERS)
def test_print_board_equal(num_players):
    jg, g = games(num_players, 5)
    board, player = init_board(num_players, 5), 0
    pick = np.random.default_rng(5)
    for move in range(24):
        if move % 8 == 0:
            out, jout = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out):
                g.printBoard(board)
                RENDER.print_board(g.cfg, board)
            with contextlib.redirect_stdout(jout):
                jg.printBoard(board)
                JRENDER.print_board(jg.cfg, board)
            assert out.getvalue() == jout.getvalue()
            assert "Bank" in out.getvalue()
        a = int(pick.choice(np.flatnonzero(g.getValidMoves(board, player))))
        board, player = g.getNextState(board, player, a)


@pytest.mark.parametrize("cur_player", [0, 1])
def test_board_dsl_equal(cur_player):
    assert D.CODE_TO_CARD == JD.CODE_TO_CARD
    assert D.NOBLE_TO_ID == JD.NOBLE_TO_ID
    spec = _demo_spec()
    state = D.spec_to_state(spec, 2, cur_player=cur_player)
    assert_same(state, JD.spec_to_state(spec, 2, cur_player=cur_player))
    assert D.state_to_spec(state, 2) == JD.state_to_spec(state, 2)
    assert D.state_to_spec(state, 2)["Tier1"] == spec["Tier1"]
    # a spec read back from a played board
    jg, g = games(2, 1)
    board, player = init_board(2, 1), 0
    pick = np.random.default_rng(1)
    for _ in range(20):
        a = int(pick.choice(np.flatnonzero(g.getValidMoves(board, player))))
        board, player = g.getNextState(board, player, a)
    back = D.state_to_spec(board, 2)
    assert back == JD.state_to_spec(board, 2)
    assert_same(D.spec_to_state(back, 2, cur_player),
                JD.spec_to_state(back, 2, cur_player))


@pytest.mark.parametrize("call,exc", [
    (lambda M: M.lookup_card("W99"), KeyError),
    (lambda M: M.lookup_noble("ZZ"), KeyError),
    (lambda M: M.spec_to_state({"Tier1": ["W7"]}), ValueError),
    (lambda M: M.spec_to_state({"Reserve": [["Q1"], []]}), KeyError),
])
def test_board_dsl_unknown_codes_raise(call, exc):
    for module in (D, JD):
        with pytest.raises(exc) as info:
            call(module)
        if module is D:
            msg = str(info.value)
    assert msg == str(info.value)
