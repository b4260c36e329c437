"""Port parity: ``FusedMatch.play`` against the JAX package's.

With the uniform evaluator and fed the JAX match's initial states and
chance draws (its key splits, replayed here), the port's match gives the
same outcomes, scores and move count (exact): 2 players with noble select
off and on, and 3 players.  Each case compiles a JAX match, so they sit in
a file of their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphazero_tpu.eval import arena as JAR
from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.search import mcts as JM
from alphazero_tpu_torch.eval import arena as AR
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.search import mcts as M
from tests.test_torch_port_train import _one_thread  # noqa: F401


def _jax_match_draws(jmatch, key, B, chunk_moves, n_chunks):
    """The JAX ``FusedMatch.play`` key walk: initial states, then each
    move's chance uniforms and noble-choice uniforms."""
    key, k0 = jax.random.split(key)
    states = jmatch.init(k0)

    @jax.jit
    def chunk_draws(key):
        key, kc = jax.random.split(key)

        def move(key_t):
            _, ku, kn = jax.random.split(key_t, 3)
            _, ku2 = jax.random.split(kn)
            return (jax.random.uniform(ku, (B, 2)),
                    jax.random.uniform(ku2, (B, 2)))
        return key, jax.vmap(move)(jax.random.split(kc, chunk_moves))

    us, u2s = [], []
    for _ in range(n_chunks):
        key, (u, u2) = chunk_draws(key)
        us.extend(np.asarray(u))
        u2s.extend(np.asarray(u2))
    return np.asarray(states), us, u2s


@pytest.mark.parametrize("num_players,noble_select",
                         [(2, False), (2, True), (3, False)])
def test_fused_match_equal(num_players, noble_select):
    B, chunk, sims = 3, 8, 4
    kw = dict(num_players=num_players, enable_noble_select=noble_select,
              score_win=4)
    jcfg, cfg = JE.SplendorConfig(**kw), E.SplendorConfig(**kw)
    jsearch = JM.build_search(JM.MCTSConfig(num_sims=sims), num_players,
                              JA.make_uniform_eval_fn(jcfg),
                              JA.make_search_step_fn(jcfg),
                              JA.make_valid_fn(jcfg))
    key = jax.random.PRNGKey(num_players + 10 * noble_select)
    seats = [jnp.zeros(1) for _ in range(num_players)]
    jmatch = JAR.FusedMatch(jcfg, jsearch, B, chunk)
    want = jmatch.play(seats, key)
    n_chunks = want.moves // chunk
    states, us, u2s = _jax_match_draws(jmatch, key, B, chunk, n_chunks)
    search = M.build_search(M.MCTSConfig(num_sims=sims), num_players,
                            A.make_uniform_eval_fn(cfg),
                            A.make_search_step_fn(cfg), A.make_valid_fn(cfg),
                            device="cpu")
    got = AR.FusedMatch(cfg, search, B, chunk, device="cpu").play(
        [None] * num_players, start_states=states, uniforms=us,
        noble_uniforms=u2s)
    assert got.moves == want.moves
    np.testing.assert_array_equal(got.outcomes, want.outcomes)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert (np.abs(got.outcomes).sum(1) > 0).all()
    wins, draws = got.tally([0] + [1] * (num_players - 1))
    assert sum(wins) + draws == B
