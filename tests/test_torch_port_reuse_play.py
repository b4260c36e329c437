"""Port parity: self-play with tree reuse and ``ReusingAgent``.

- ``ReusingAgent`` against the greedy agent in ``BatchArena.play``, fed
  the JAX arena's initial states, chance uniforms and Gumbel draws, plays
  the JAX arena's games exactly (outcomes, scores, moves, final tree).
- ``BatchArena.play`` calls ``on_move`` once per move per distinct
  observer, and a stateless agent plays the same games beside one.
- Self-play with reuse (PCR, forced playouts; 2 players, noble select, 3
  players) completes its games with clean policy targets, never masks
  root visits, and carries subtrees.
"""

import logging

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
from alphazero_tpu_torch.train import selfplay as SP
from tests.test_torch_port_reuse import _assert_tree_equal, _port_rs
from tests.test_torch_port_train import _one_thread  # noqa: F401


@pytest.mark.parametrize("num_players,noble_select,B,S,score_win", [
    (2, False, 8, 16, 3), (2, True, 4, 8, 4), (3, False, 4, 8, 4)])
def test_selfplay_with_reuse(num_players, noble_select, B, S, score_win,
                             caplog):
    """Uniform evaluator, PCR 4 / 0.5, forced playouts; games cut short by
    a low winning score."""
    cfg = E.SplendorConfig(num_players=num_players, score_win=score_win,
                           enable_noble_select=noble_select)
    sp = SP.SelfPlayConfig(batch_size=B, num_sims=S, ratio_full=4,
                           prob_full=0.5, temp_threshold=6,
                           forced_playouts=True, tree_reuse=True,
                           chunk_moves=4)
    eng = SP.SelfPlayEngine(cfg, A.make_uniform_eval_fn(cfg), sp,
                            device="cpu")
    assert eng.rs_fast.capacity == eng.rs_full.capacity == 2 * S + 1
    kept = []
    reroot = eng.rs_full.reroot

    def counting(*a):
        tree, n = reroot(*a)
        kept.append(n.clone())
        return tree, n
    eng.rs_full = eng.rs_full._replace(reroot=counting)
    with caplog.at_level(logging.WARNING):
        it, stats = eng.run_games(None, torch.Generator().manual_seed(1))
    assert not [r for r in caplog.records if "masking" in r.getMessage()]
    assert stats["games"] == B and stats["examples"] == len(it) > 0
    # every game ended before the cap
    assert stats["avg_moves"] < cfg.max_moves
    assert (np.abs(it.winner.astype(np.float32)).sum(1) > 0).all()
    pi = it.pi.astype(np.float32)
    assert float((pi * ~it.valids).sum()) == 0.0
    np.testing.assert_allclose(pi.sum(1), 1.0, atol=2e-3)
    assert bool((torch.stack(kept) > 1).any())


def _jax_arena_draws(key, B, A_, moves):
    """The JAX ``BatchArena.play`` key walk (noble select off): initial
    states, then each move's agent key's Gumbel draws and chance
    uniforms."""
    key, k0 = jax.random.split(key)

    def move(key, _):
        key, ka, ku = jax.random.split(key, 3)
        return key, (jax.random.gumbel(ka, (B, A_)),
                     jax.random.uniform(ku, (B, 2)))
    _, (g, u) = jax.jit(lambda k: jax.lax.scan(move, k, None, moves))(key)
    return k0, np.array(g), np.array(u)


def test_reusing_agent_in_arena_equals_jax():
    """``ReusingAgent`` (uniform evaluator, 8 sims) against the greedy agent
    in ``BatchArena.play``: fed the JAX arena's initial states, chance
    uniforms and Gumbel draws, the port plays the same games (outcomes,
    scores, move count, and the agent's final tree)."""
    B, S = 2, 8
    kw = dict(num_players=2, score_win=3)
    jcfg, cfg = JE.SplendorConfig(**kw), E.SplendorConfig(**kw)
    jrs = JM.build_reusing_search(JM.MCTSConfig(num_sims=S), 2,
                                  JA.make_uniform_eval_fn(jcfg),
                                  JA.make_search_step_fn(jcfg),
                                  JA.make_valid_fn(jcfg))
    jagent = JAR.ReusingAgent(jrs, None)
    jarena = JAR.BatchArena(jcfg, B)
    key = jax.random.PRNGKey(4)
    jres = jarena.play([jagent, JAR.make_greedy_agent(jcfg)], key)

    k0, gumbels, uniforms = _jax_arena_draws(key, B, 409, cfg.max_moves + 1)
    agent = AR.ReusingAgent(_port_rs(dict(num_sims=S), cfg=cfg), None)
    greedy = AR.make_greedy_agent(cfg)
    moves = []

    def replayed(canon, generator=None):
        t = len(moves)
        moves.append(t)
        return greedy(canon, gumbel=torch.from_numpy(gumbels[t]))

    def seat0(canon, generator=None):
        moves.append(len(moves))
        return agent(canon, generator)
    seat0.on_move = agent.on_move
    res = AR.BatchArena(cfg, B, device="cpu").play(
        [seat0, replayed], torch.Generator().manual_seed(0),
        start_states=np.asarray(jarena.init(k0)), uniforms=uniforms)
    np.testing.assert_array_equal(res.outcomes, jres.outcomes)
    np.testing.assert_array_equal(res.scores, jres.scores)
    assert res.moves == jres.moves == len(moves)
    _assert_tree_equal(jagent.tree, jagent.n, agent.tree, agent.n)
    assert int(agent.n.max()) >= 1


def test_on_move_called_once_per_move_per_observer():
    cfg = E.SplendorConfig(score_win=3)
    arena = AR.BatchArena(cfg, 3, device="cpu")
    greedy = AR.make_greedy_agent(cfg)
    rand = AR.make_random_agent(arena.valids)
    start = arena.init(torch.Generator().manual_seed(0)).numpy()
    uniforms = np.random.default_rng(0).random((cfg.max_moves + 1, 3, 2),
                                               dtype=np.float32)

    def play(agents):
        return arena.play(agents, torch.Generator().manual_seed(5),
                          start_states=start, uniforms=uniforms)
    plain = play([greedy, rand])

    class Observer:
        """``rand`` with an ``on_move`` that counts."""
        def __init__(self):
            self.seen = []

        def __call__(self, canon, generator=None):
            return rand(canon, generator)

        def on_move(self, actions, next_canon):
            self.seen.append((actions.clone(), next_canon.clone()))
    obs = Observer()
    watched = play([greedy, obs])
    # a stateless agent plays the same games with an observer beside it
    np.testing.assert_array_equal(watched.outcomes, plain.outcomes)
    np.testing.assert_array_equal(watched.scores, plain.scores)
    assert len(obs.seen) == watched.moves
    # one agent in both seats hears each move once
    both = Observer()
    twice = play([both, both])
    assert len(both.seen) == twice.moves




def _two_noble_boards(cfg, B):
    """Boards where seat 0 buying card 0 makes two nobles eligible at once,
    which leaves it a pending noble choice."""
    from alphazero_tpu_torch.games.splendor import tables as T
    rng = np.random.default_rng(1)
    s = E.init_with_uniforms(
        cfg, torch.from_numpy(rng.random((B, 24), dtype=np.float32)),
        torch.arange(3)[None].repeat(B, 1) + 3).numpy()
    rn = cfg.row_nobles
    s[:, rn], s[:, rn + 1] = T.ALL_NOBLES[0], T.ALL_NOBLES[1]
    s[:, cfg.row_pcards, :5] = [0, 0, 4, 3, 4]
    s[:, cfg.row_pgems, 5] = 5
    s[:, 1], s[:, 2] = [1, 0, 0, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0, 0]
    return s


def _noble_query_roots(ar, rs, cfg, play):
    """``play(agents)`` of a ``ReusingAgent`` holding both seats that buys
    card 0 on its first move and then moves as the greedy agent.  Returns,
    for the call that answers the pending noble choice, whether each
    board's tree root is the canon it was handed and whether it is the
    canon of the move before."""
    greedy = ar.make_greedy_agent(cfg)
    calls, queries = [], []

    class Logged(ar.ReusingAgent):
        def __call__(self, canon, rng=None):
            canon_np = np.asarray(canon)
            if calls and not calls[-1][1]:
                # a second call within one move: the noble query
                root, prev = np.asarray(self.tree.states)[:, 0], calls[-1][0]
                queries.append([(bool((r == c).all()), bool((r == p).all()))
                                for r, c, p in zip(root, canon_np, prev)])
            calls.append((canon_np, False))
            super().__call__(canon, rng)
            if len(calls) == 1:
                return 0 * greedy(canon, rng)
            return greedy(canon, rng)

        def on_move(self, actions, next_canon):
            calls[-1] = (calls[-1][0], True)
            super().on_move(actions, next_canon)
    agent = Logged(rs, None)
    play([agent, agent])
    return queries


def test_noble_query_precedes_reroot_as_in_jax():
    """With ``enable_noble_select``, ``BatchArena.play`` asks the mover's
    agent for the noble before ``on_move`` re-roots its tree, in both
    packages: a ``ReusingAgent`` answers the noble query from the tree of
    the move just played (its root is the pre-move canon, not the
    noble-pending board it is handed).  The port keeps this behaviour."""
    B, S = 2, 4
    kw = dict(num_players=2, enable_noble_select=True, score_win=3)
    jcfg, cfg = JE.SplendorConfig(**kw), E.SplendorConfig(**kw)
    start = _two_noble_boards(cfg, B)
    jrs = JM.build_reusing_search(JM.MCTSConfig(num_sims=S), 2,
                                  JA.make_uniform_eval_fn(jcfg),
                                  JA.make_search_step_fn(jcfg),
                                  JA.make_valid_fn(jcfg))
    jq = _noble_query_roots(
        JAR, jrs, jcfg, lambda agents: JAR.BatchArena(jcfg, B).play(
            agents, jax.random.PRNGKey(2), start_states=jnp.asarray(start)))
    q = _noble_query_roots(
        AR, _port_rs(dict(num_sims=S), cfg=cfg), cfg,
        lambda agents: AR.BatchArena(cfg, B, device="cpu").play(
            agents, torch.Generator().manual_seed(2), start_states=start))
    assert q == jq == [[(False, True)] * B]
