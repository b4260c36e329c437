"""Port parity: the arena against the JAX package's.

- The greedy agent's gains and pools on real positions equal the JAX
  agent's computation, and both agents pick the same actions given the same
  Gumbel noise; the random agent likewise (exact).
- ``FusedMatch.play`` against the JAX match is in
  ``test_torch_port_match.py``.
- ``BatchArena.play`` settles every game, honours per-seat token limits
  and judges games still running at the move cap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.eval import arena as JAR
from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.search import mcts as JM
from alphazero_tpu_torch.eval import arena as AR
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.search import mcts as M
from tests.test_torch_port_train import _one_thread  # noqa: F401
from tests.test_torch_port_train import positions


def _jax_greedy_gains(jcfg, canon):
    """The JAX greedy agent's per-board computation (``make_greedy_agent``'s
    ``one_board``), batched."""
    cand = jnp.array(list(range(12)) + [27, 28, 29], jnp.int32)

    def one_board(s):
        valid = JE.valid_moves(jcfg, s, 0)
        s0 = JE.all_scores(jcfg, s)[0]
        gains = jax.vmap(lambda a: JE.all_scores(
            jcfg, JE.step(jcfg, s, a, 0, jnp.zeros(2), True)[0])[0])(cand) - s0
        gain = jnp.zeros((jcfg.num_actions,), gains.dtype).at[cand].set(gains)
        return valid, jnp.where(valid, gain, -(2 ** 14))
    return jax.jit(jax.vmap(one_board))(canon)


@pytest.mark.parametrize("num_players", [2, 3])
def test_greedy_agent_equal(num_players):
    cfg, s, _ = positions(num_players, 32, seed=num_players, moves=(20, 60))
    jcfg = JE.SplendorConfig(num_players=num_players)
    valid, gain = AR.greedy_gains(cfg, s)
    jvalid, jgain = _jax_greedy_gains(jcfg, jnp.asarray(s.numpy()))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(gain.numpy(), np.asarray(jgain))
    assert (gain.numpy() > 0).any()
    jagent = JAR.make_greedy_agent(jcfg)
    agent = AR.make_greedy_agent(cfg)
    for k in range(4):
        key = jax.random.PRNGKey(k)
        g = np.asarray(jax.random.gumbel(key, valid.shape))
        want = np.asarray(jagent(jnp.asarray(s.numpy()), key))
        got = agent(s, gumbel=torch.from_numpy(g)).numpy()
        np.testing.assert_array_equal(got, want)
        assert AR.greedy_pool(valid, gain).numpy()[np.arange(32), got].all()


def test_random_agent_equal():
    cfg, s, valid = positions(2, 32, seed=5)
    jcfg = JE.SplendorConfig()
    jagent = JAR.make_random_agent(
        jax.vmap(lambda x: JE.valid_moves(jcfg, x, 0)))
    agent = AR.make_random_agent(A.make_valid_fn(cfg))
    for k in range(4):
        key = jax.random.PRNGKey(k)
        g = np.asarray(jax.random.gumbel(key, valid.shape))
        got = agent(s, gumbel=torch.from_numpy(g)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jagent(jnp.asarray(s.numpy()), key)))
        assert valid.numpy()[np.arange(32), got].all()
    drawn = agent(s, torch.Generator().manual_seed(0))
    assert valid[torch.arange(32), drawn].all()


def test_batch_arena_play():
    cfg = E.SplendorConfig(score_win=3)
    arena = AR.BatchArena(cfg, 4, device="cpu")
    greedy = AR.make_greedy_agent(cfg)
    rand = AR.make_random_agent(arena.valids)
    res = arena.play([greedy, rand], torch.Generator().manual_seed(0))
    wins, draws = res.tally([0, 1])
    assert sum(wins) + draws == 4 and wins[0] >= wins[1]
    assert res.scores.max(1).min() >= 3 and res.moves <= cfg.max_moves + 1
    # the handicap: seat 1 may hold no gems beyond its limit
    h = AR.BatchArena(cfg, 4, token_limits=[10, 2], device="cpu")
    assert h.handicapped
    s = h.init(torch.Generator().manual_seed(1))
    v0, v1 = h.valids(s, 0), h.valids(s, 1)
    assert (v1 <= v0).all() and v1.sum() < v0.sum()
    # the move cap: a game that cannot end is judged
    capped = dataclasses.replace(cfg, score_win=99)
    res = AR.BatchArena(capped, 2, device="cpu").play(
        [rand, rand], torch.Generator().manual_seed(2))
    assert res.moves <= capped.max_moves + 1
    assert (np.abs(res.outcomes).sum(1) > 0).all()


def test_gates_tally():
    cfg = E.SplendorConfig(score_win=2)
    search = M.build_search(M.MCTSConfig(num_sims=2), 2,
                            A.make_uniform_eval_fn(cfg),
                            A.make_search_step_fn(cfg), A.make_valid_fn(cfg),
                            device="cpu")
    for gate in (AR.two_player_gate, AR.fused_two_player_gate):
        nw, ow, dr = gate(cfg, search, None, None, 4,
                          torch.Generator().manual_seed(3), device="cpu")
        assert nw + ow + dr == 4
