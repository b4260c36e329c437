"""Port parity: the PyTorch self-play actor against the JAX one.

``finalize_examples`` and the PCR split sizes are exactly equal; Gumbel-max
action sampling is equal given the same Gumbel noise; a CPU ``run_games``
gives an ``Iteration`` with the actor's invariants."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.train import selfplay as JSP
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.train import selfplay as SP


def _jax_engine(jcfg, **kw):
    return JSP.SelfPlayEngine(jcfg, JA.make_uniform_eval_fn(jcfg),
                              JSP.SelfPlayConfig(**kw))


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_config_fields_equal():
    # the JAX actor's compile-only knobs have no counterpart in the port
    jax_only = {"donate_chunk", "reuse_barrier", "debug_outputs"}
    want = {k: v for k, v in _fields(JSP.SelfPlayConfig()).items()
            if k not in jax_only}
    assert _fields(SP.SelfPlayConfig()) == want


@pytest.mark.parametrize("num_players", [2, 3])
def test_finalize_examples_equal(num_players):
    rng = np.random.default_rng(num_players)
    B, A, R = 7, 409, E.SplendorConfig(num_players=num_players).rows
    collected = []
    for t in range(5):
        idx = np.flatnonzero(rng.random(B) < 0.6)
        e = len(idx)
        collected.append((rng.integers(-5, 9, (e, R, 7)).astype(np.int8),
                          rng.random((e, A)).astype(np.float16),
                          rng.random((e, A)) < 0.3,
                          rng.uniform(-1, 1, (e, num_players))
                          .astype(np.float32),
                          t % num_players, idx))
    results = rng.choice([-1.0, 0.01, 1.0], (B, num_players)).astype(np.float32)
    scores = rng.integers(0, 200, (B, num_players)).astype(np.int32)
    j = JSP.finalize_examples(collected, results, scores)
    t = SP.finalize_examples(collected, results, scores)
    for name in ("boards", "pi", "winner", "scdiff", "valids", "surprise"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert SP.finalize_examples([], results, scores) is None


def test_sample_actions_equal_given_gumbel():
    eng = _jax_engine(JE.SplendorConfig(), batch_size=4, num_sims=4)
    rng = np.random.default_rng(0)
    counts = (rng.integers(0, 4, (64, 409))
              * (rng.random((64, 409)) < 0.05)).astype(np.float32)
    counts[:, 7] += 1                        # every row has a visited action
    counts[0, :3] = 5.0                      # ties
    for i, temp in enumerate((2.0, 0.2, 0.0)):
        key = jax.random.PRNGKey(i)
        ja = np.asarray(eng.sample_actions(jnp.asarray(counts),
                                           jnp.float32(temp), key))
        g = np.array(jax.random.gumbel(key, counts.shape))
        ta = SP.sample_actions(torch.from_numpy(counts), temp,
                               torch.from_numpy(g)).numpy()
        np.testing.assert_array_equal(ja, ta)


def _jax_b_full(eng):
    """The JAX actor keeps its split size in the chunk function's closure."""
    fn = eng.chunk.__wrapped__
    cell = fn.__closure__[fn.__code__.co_freevars.index("B_full")]
    return cell.cell_contents


def test_pcr_partition_sizes_equal():
    jcfg = JE.SplendorConfig()
    for B in (1, 2, 5, 8, 256):
        for prob in (0.0, 0.1, 0.25, 0.3, 0.5, 0.99, 1.0):
            eng = _jax_engine(jcfg, batch_size=B, num_sims=4, prob_full=prob)
            assert SP.pcr_full_size(B, prob) == _jax_b_full(eng), (B, prob)


@pytest.mark.parametrize("num_players,noble_select", [(2, False), (3, True)])
def test_run_games_invariants(num_players, noble_select):
    cfg = E.SplendorConfig(num_players=num_players,
                           enable_noble_select=noble_select)
    sp = SP.SelfPlayConfig(batch_size=4, num_sims=8, ratio_full=4,
                           prob_full=0.5, max_moves=6, chunk_moves=4,
                           forced_playouts=True)
    eng = SP.SelfPlayEngine(cfg, A.make_uniform_eval_fn(cfg), sp,
                            device="cpu")
    it, stats = eng.run_games(None, torch.Generator().manual_seed(3))
    assert stats["games"] == 4
    # two whole chunks of 4 moves, 2 full + 2 fast searches per move
    assert stats["avg_moves"] == 8
    assert stats["rollouts"] == 8 * (2 * 8 + 2 * 2)
    assert stats["examples"] == len(it) == 8 * 2
    E_ = len(it)
    assert it.boards.shape == (E_, cfg.rows, 7) and it.boards.dtype == np.int8
    assert it.pi.shape == (E_, 409) and it.pi.dtype == np.float16
    assert it.valids.shape == (E_, 409) and it.valids.dtype == np.bool_
    assert it.winner.shape == it.scdiff.shape == it.surprise.shape \
        == (E_, num_players)
    np.testing.assert_allclose(it.pi.astype(np.float32).sum(1), 1.0,
                               atol=2e-3)
    assert (it.pi[~it.valids] == 0).all()
    np.testing.assert_array_equal(
        it.valids, A.make_valid_fn(cfg)(torch.from_numpy(it.boards)).numpy())
    # games cut at the cap are settled by the judge: every seat has a result
    assert (np.abs(it.winner.astype(np.float32)).sum(1) > 0).all()


def test_resolve_nobles_takes_the_pending_choice():
    """A board left with a pending noble choice picks one by a fast search
    in the mover's frame; other boards pass through untouched."""
    cfg = E.SplendorConfig(num_players=2, enable_noble_select=True)
    rng = np.random.default_rng(1)
    B = 4
    s = E.init_with_uniforms(
        cfg, torch.from_numpy(rng.random((B, 24), dtype=np.float32)),
        torch.arange(3)[None].repeat(B, 1) + 3).numpy()
    from alphazero_tpu_torch.games.splendor import tables as T
    rn = cfg.row_nobles
    s[:, rn], s[:, rn + 1] = T.ALL_NOBLES[0], T.ALL_NOBLES[1]
    s[:, cfg.row_pcards, :5] = [0, 0, 4, 3, 4]
    s[:, cfg.row_pgems, 5] = 5
    s[:, 1], s[:, 2] = [1, 0, 0, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0, 0]
    mid, adv = E.step(cfg, torch.from_numpy(s), torch.zeros(B, dtype=torch.long),
                      0, torch.zeros(B, 2), False)
    assert (adv == 0).all()
    adv = adv.clone()
    adv[1] = 1                                   # board 1: nothing pending
    eng = SP.SelfPlayEngine(cfg, A.make_uniform_eval_fn(cfg),
                            SP.SelfPlayConfig(batch_size=B, num_sims=8),
                            device="cpu")
    out = eng._resolve_nobles(None, mid, adv, torch.Generator().manual_seed(0))
    assert torch.equal(out[1], mid[1])
    flags = out[[0, 2, 3], rn:rn + cfg.num_nobles, 5]
    assert (flags == 0).all()
    owned = out[[0, 2, 3], cfg.row_pnobles:cfg.row_pnobles + 3, 6]
    assert ((owned > 0).sum(1) == 1).all()


def test_explicit_stage_sims_runs_and_equals_off():
    """An explicit ``stage_sims`` list sums to the full search's sims; the
    port runs its fast search unstaged, so the run equals the ``"off"``
    run.  The JAX engine hands the list to its fast search too, whose sims
    it does not sum to, and raises ``ValueError`` (a JAX fault the port
    does not keep): its constructor raises."""
    cfg = E.SplendorConfig()
    kw = dict(batch_size=4, num_sims=8, ratio_full=4, prob_full=0.5,
              max_moves=6, chunk_moves=4)
    runs = {}
    for stages in ("4,4", "off"):
        eng = SP.SelfPlayEngine(cfg, A.make_uniform_eval_fn(cfg),
                                SP.SelfPlayConfig(stage_sims=stages, **kw),
                                device="cpu")
        runs[stages] = eng.run_games(None, torch.Generator().manual_seed(3))
    (it, stats), (it_off, stats_off) = runs["4,4"], runs["off"]
    assert stats == stats_off and stats["rollouts"] == 160
    for name in ("boards", "pi", "valids", "winner", "scdiff", "surprise"):
        np.testing.assert_array_equal(getattr(it, name), getattr(it_off, name),
                                      err_msg=name)
    with pytest.raises(ValueError, match="sum to num_sims=2"):
        _jax_engine(JE.SplendorConfig(), stage_sims="4,4", **kw)
