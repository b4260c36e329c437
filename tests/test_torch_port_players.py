"""Port parity: the baseline and alpha-beta players and the alpha-beta
worker pool against the JAX package.

- ``RandomPlayer`` and ``GreedyPlayer`` (2 and 3 players) make the same
  moves as JAX's over 24 moves of one game each, the games driven by both
  packages' ``SplendorGame`` from the same seed (the greedy player's
  candidate steps draw chance uniforms in the same order).
- ``AlphaBetaPlayer`` at depth 2 with a deadline of 1e9 s makes the same
  moves on 3 boards in 2 players and 3 in 3 players (boards without gold
  in the bank, where the search skips the reserves and stays small), with
  the heuristic value.  With a width-48 value head carried across by
  ``from_flax``, the values of the root's children agree within 1e-5, and
  the moves are equal except on boards where two children's values lie
  within 1e-4 (``NEAR_TIES`` names them; none so far).
- ``AlphaBetaPool(workers=2, depth=1)`` gives JAX's moves on a batch of
  boards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.eval import ab_pool as JAB
from alphazero_tpu.eval import players as JP
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.models import splendor_net as JN
from alphazero_tpu_torch.eval import ab_pool as AB
from alphazero_tpu_torch.eval import players as P
from alphazero_tpu_torch.games import game_api as API
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from tests.test_torch_port_game_api import games, init_board
from tests.test_torch_port_train import _one_thread  # noqa: F401
from tests.test_torch_port_train import jax_net

# (num_players, board index) where the moves may differ: two children's
# values within 1e-4 of each other under the value head
NEAR_TIES: set = set()


@pytest.mark.parametrize("num_players", [2, 3])
def test_random_and_greedy_make_jax_moves(num_players):
    jg, g = games(num_players, 20 + num_players)
    seats = [(JP.RandomPlayer(jg, seed=1), P.RandomPlayer(g, seed=1))] + [
        (JP.GreedyPlayer(jg, seed=2 + s), P.GreedyPlayer(g, seed=2 + s))
        for s in range(1, num_players)]
    board = init_board(num_players, 30 + num_players)
    jboard, player, moves = board, 0, []
    for _ in range(24):
        jplayer, port = seats[player]
        a = port.play(g.getCanonicalForm(board, player))
        assert a == jplayer.play(jg.getCanonicalForm(jboard, player))
        moves.append(a)
        board, nxt = g.getNextState(board, player, a)
        jboard, jnxt = jg.getNextState(jboard, player, a)
        assert np.array_equal(board, jboard) and nxt == jnxt
        player = nxt
        if g.getGameEnded(board).any():
            break
    assert len(set(moves)) > 5


def ab_boards(num_players):
    """Three canonical boards: 5 random reserves, which take the bank's
    gold (so alpha-beta skips the reserves, as the reference does,
    :286-290, and a depth-2 search stays small), then 0, 2 or 4 random
    moves."""
    g = API.SplendorGame(num_players, seed=40, device="cpu")
    rng = np.random.default_rng(40 + num_players)
    out = []
    for i, extra in enumerate((0, 2, 4)):
        board, player = init_board(num_players, 50 + 10 * num_players + i), 0
        for move in range(5 + extra):
            valid = np.flatnonzero(g.getValidMoves(board, player))
            if move < 5:
                valid = valid[(valid >= 12) & (valid < 27)]
            board, player = g.getNextState(board, player,
                                           int(rng.choice(valid)))
        assert board[0, 5] == 0
        out.append(g.getCanonicalForm(board, player))
    return out


def _root_values(player):
    """Record the values the root's children return to ``play``."""
    seen = []
    inner = player._alphabeta

    def wrapped(board, pl, depth, alpha, beta, deadline):
        v = inner(board, pl, depth, alpha, beta, deadline)
        if depth == player.depth - 1:
            seen.append(v)
        return v
    player._alphabeta = wrapped
    return seen


def value_fns(num_players):
    jcfg, params, bs, net = jax_net(1, 48, seed=num_players,
                                    num_players=num_players)
    env = JE.SplendorConfig(num_players=num_players)
    cfg = E.SplendorConfig(num_players=num_players)

    @jax.jit
    def jv(state):
        valid = JE.valid_moves(env, state, 0)
        _, v, _ = JN.apply_inference(jcfg, params, bs,
                                     state[None].astype(jnp.float32),
                                     valid[None])
        return v[0, 0]

    @torch.inference_mode()
    def tv(board):
        s = torch.as_tensor(np.asarray(board))[None]
        _, v, _ = N.apply_inference(net, s.to(torch.float32),
                                    E.valid_moves(cfg, s, 0))
        return float(v[0, 0])
    return (lambda b: float(jv(jnp.asarray(b)))), tv


@pytest.mark.parametrize("num_players", [2, 3])
def test_alphabeta_makes_jax_moves(num_players):
    jg, g = games(num_players, 0)
    jvalue, value = value_fns(num_players)
    for i, board in enumerate(ab_boards(num_players)):
        # the heuristic value
        jab = JP.AlphaBetaPlayer(jg, depth=2, deadline_s=1e9)
        ab = P.AlphaBetaPlayer(g, depth=2, deadline_s=1e9)
        jseen, seen = _root_values(jab), _root_values(ab)
        assert ab.play(board) == jab.play(board), (num_players, i)
        assert seen == jseen
        # the value head
        jab = JP.AlphaBetaPlayer(jg, depth=2, deadline_s=1e9, value_fn=jvalue)
        ab = P.AlphaBetaPlayer(g, depth=2, deadline_s=1e9, value_fn=value)
        jseen, seen = _root_values(jab), _root_values(ab)
        a, ja = ab.play(board), jab.play(board)
        assert len(seen) == len(jseen) > 1
        np.testing.assert_allclose(seen, jseen, rtol=0, atol=1e-5)
        top = np.sort(jseen)[-2:]
        if (num_players, i) in NEAR_TIES:
            assert top[1] - top[0] < 1e-4
        else:
            assert a == ja, (num_players, i, top)


def test_alphabeta_pool_makes_jax_moves():
    boards = np.stack(ab_boards(2))
    with JAB.AlphaBetaPool(2, depth=1, deadline_s=1e9, workers=2) as jpool, \
            AB.AlphaBetaPool(2, depth=1, deadline_s=1e9, workers=2) as pool:
        got = pool.agent(torch.from_numpy(boards), torch.Generator())
        want = np.asarray(jpool.agent(jnp.asarray(boards), None))
    assert got.dtype == torch.long and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
