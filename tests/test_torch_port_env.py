"""Port parity: the PyTorch Splendor env against the JAX env.

Random legal playouts drive both envs with the same actions, uniforms and
``deterministic`` flags (made with numpy from fixed seeds).  States must be
byte-equal at every step, and every query function must agree exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.games.splendor import tables as JT
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.games.splendor import tables as T


def test_tables_equal():
    names = [n for n in dir(JT) if not n.startswith("_")
             and isinstance(getattr(JT, n), (np.ndarray, int))]
    assert len(names) > 20
    for n in names:
        a, b = getattr(JT, n), getattr(T, n)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, n
            np.testing.assert_array_equal(a, b, err_msg=n)
        else:
            assert a == b, n


def _jax_fns(jcfg):
    step = jax.jit(jax.vmap(lambda s, a, p, u, d: JE.step(jcfg, s, a, p, u, d),
                            in_axes=(0, 0, None, 0, 0)))
    valid = jax.jit(jax.vmap(lambda s, p: JE.valid_moves(jcfg, s, p),
                             in_axes=(0, None)))
    swap = jax.jit(jax.vmap(lambda s, k: JE.swap_players(jcfg, s, k)))
    ends = jax.jit(jax.vmap(lambda s: (JE.check_end_game(jcfg, s),
                                       JE.judge(jcfg, s),
                                       JE.all_scores(jcfg, s))))
    init = jax.jit(jax.vmap(lambda u, n: JE.init_with_uniforms(jcfg, u, n)))
    return step, valid, swap, ends, init


def _pick_actions(rng, valid):
    """A random legal action per board, buying whenever a coin says so and a
    buy is legal (so games reach cards, nobles and reserves quickly)."""
    out = np.zeros(len(valid), np.int64)
    for b, v in enumerate(valid):
        legal = np.flatnonzero(v)
        buys = legal[(legal < 12) | ((legal >= 27) & (legal < 30))]
        if len(buys) and rng.random() < 0.6:
            out[b] = rng.choice(buys)
        else:
            out[b] = rng.choice(legal)
    return out


@pytest.mark.parametrize("num_players", [2, 3, 4])
@pytest.mark.parametrize("noble_select", [False, True])
def test_random_playouts_byte_equal(num_players, noble_select):
    kw = dict(num_players=num_players, enable_noble_select=noble_select)
    jcfg, cfg = JE.SplendorConfig(**kw), E.SplendorConfig(**kw)
    assert dataclasses.astuple(jcfg) == dataclasses.astuple(cfg)
    jstep, jvalid, jswap, jends, jinit = _jax_fns(jcfg)
    rng = np.random.default_rng(100 * num_players + 10 * noble_select)
    B, steps, n = 12, 70, num_players
    u24 = rng.random((B, 24), dtype=np.float32)
    nobles = np.stack([rng.permutation(10)[:cfg.num_nobles]
                       for _ in range(B)])
    js = jinit(jnp.asarray(u24), jnp.asarray(nobles))
    ts = E.init_with_uniforms(cfg, torch.from_numpy(u24),
                              torch.from_numpy(nobles))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    for t in range(steps):
        # canonical play (player 0 + per-board seat swap) with the noble
        # ply, seat-by-seat play with a Python-int player otherwise
        player = 0 if noble_select else t % n
        jv = np.asarray(jvalid(js, player))
        tv = E.valid_moves(cfg, ts, player).numpy()
        np.testing.assert_array_equal(jv, tv, err_msg=f"valid t={t}")
        acts = _pick_actions(rng, jv)
        u = rng.random((B, 2), dtype=np.float32)
        # both Python-bool forms of ``deterministic``, then a per-board mix
        # (the JAX side always takes a per-board array: one compile)
        if t < 40:
            tdet = t % 2 == 1
            det = np.full(B, tdet)
        else:
            det = rng.random(B) < 0.5
            tdet = torch.from_numpy(det)
        js2, jn = jstep(js, jnp.asarray(acts, jnp.int32), player,
                        jnp.asarray(u), jnp.asarray(det))
        ts2, tn = E.step(cfg, ts, torch.from_numpy(acts), player,
                         torch.from_numpy(u), tdet)
        np.testing.assert_array_equal(np.asarray(js2), ts2.numpy(),
                                      err_msg=f"step t={t}")
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
        if noble_select:
            js2 = jswap(js2, jn)
            ts2 = E.swap_players(cfg, ts2, tn)
            np.testing.assert_array_equal(np.asarray(js2), ts2.numpy())
        js, ts = js2, ts2
        je, jj, jsc = (np.asarray(x) for x in jends(js))
        np.testing.assert_array_equal(je, E.check_end_game(cfg, ts).numpy())
        np.testing.assert_array_equal(jj, E.judge(cfg, ts).numpy())
        np.testing.assert_array_equal(jsc, E.all_scores(cfg, ts).numpy())
    # the playouts must have reached the interesting rules
    pc = ts.numpy()[:, cfg.row_pcards:cfg.row_pcards + n, :5]
    assert pc.sum() > 0


@pytest.mark.parametrize("num_players", [2, 3, 4])
def test_swap_players_and_round_wrap(num_players):
    cfg = E.SplendorConfig(num_players=num_players)
    jcfg = JE.SplendorConfig(num_players=num_players)
    rng = np.random.default_rng(num_players)
    states = rng.integers(-128, 128, size=(8, cfg.rows, 7), dtype=np.int8)
    # round counters straddling the int8 wrap (read back as uint8)
    states[:, 0, 6] = np.array([126, 127, -128, -127, -1, 0, 123, -6],
                               np.int8)
    ks = rng.integers(0, num_players, size=8)
    jswap = jax.jit(jax.vmap(lambda s, k: JE.swap_players(jcfg, s, k)))
    for k in range(num_players):
        np.testing.assert_array_equal(
            np.asarray(jswap(jnp.asarray(states), jnp.full(8, k))),
            E.swap_players(cfg, torch.from_numpy(states), k).numpy())
    np.testing.assert_array_equal(
        np.asarray(jswap(jnp.asarray(states), jnp.asarray(ks))),
        E.swap_players(cfg, torch.from_numpy(states),
                       torch.from_numpy(ks)).numpy())
    jround = jax.jit(jax.vmap(lambda s: JE.get_round(jcfg, s)))
    np.testing.assert_array_equal(np.asarray(jround(jnp.asarray(states))),
                                  E.get_round(cfg,
                                              torch.from_numpy(states)).numpy())
    # a step at the wrap advances the counter exactly like the int8 store
    st = E.init_with_uniforms(
        cfg, torch.from_numpy(rng.random((1, 24), dtype=np.float32)),
        torch.arange(cfg.num_nobles)[None]).numpy()[0]
    batch = np.repeat(st[None], 4, 0)
    batch[:, 0, 6] = np.array([126, 127, -1, -128], np.int8)
    acts = np.full(4, 30)
    jout, _ = jax.jit(jax.vmap(
        lambda s, a: JE.step(jcfg, s, a, 0, jnp.zeros(2), True)))(
            jnp.asarray(batch), jnp.asarray(acts))
    tout, _ = E.step(cfg, torch.from_numpy(batch), torch.from_numpy(acts), 0,
                     torch.zeros(4, 2), True)
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())


@pytest.mark.parametrize("num_players", [2, 4])
def test_noble_select_ply(num_players):
    """A buy that makes two nobles eligible keeps the turn; the noble
    actions then award the chosen one.  States, masks and seats equal."""
    kw = dict(num_players=num_players, enable_noble_select=True)
    jcfg, cfg = JE.SplendorConfig(**kw), E.SplendorConfig(**kw)
    rng = np.random.default_rng(num_players)
    B = 6
    s = E.init_with_uniforms(
        cfg, torch.from_numpy(rng.random((B, 24), dtype=np.float32)),
        torch.from_numpy(np.stack([rng.permutation(10)[:cfg.num_nobles]
                                   for _ in range(B)]))).numpy()
    rn = cfg.row_nobles
    s[:, rn] = T.ALL_NOBLES[0]              # needs green 4, red 4
    s[:, rn + 1] = T.ALL_NOBLES[1]          # needs red 4, black 4
    s[:, cfg.row_pcards, :5] = [0, 0, 4, 3, 4]
    s[:, cfg.row_pgems, 5] = 5              # gold covers any cost
    s[:, 1] = [1, 0, 0, 0, 0, 0, 0]         # slot 0: cheap card ...
    s[:, 2] = [0, 0, 0, 1, 0, 0, 0]         # ... that gains red
    jstep = jax.jit(jax.vmap(lambda x, a: JE.step(jcfg, x, a, 0,
                                                  jnp.zeros(2), False)))
    jvalid = jax.jit(jax.vmap(lambda x: JE.valid_moves(jcfg, x, 0)))
    zeros = torch.zeros(B, 2)
    acts = np.zeros(B, np.int64)
    js, jn = jstep(jnp.asarray(s), jnp.asarray(acts))
    ts, tn = E.step(cfg, torch.from_numpy(s), torch.from_numpy(acts), 0,
                    zeros, False)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    assert (tn.numpy() == 0).all()                 # the mover keeps the turn
    tv = E.valid_moves(cfg, ts, 0).numpy()
    np.testing.assert_array_equal(np.asarray(jvalid(js)), tv)
    # only noble choices are legal (a third board noble may qualify too)
    assert tv[:, 405:407].all() and not tv[:, :405].any()
    pick = np.where(np.arange(B) % 2 == 0, 405, 406)
    js2, jn2 = jstep(js, jnp.asarray(pick))
    ts2, tn2 = E.step(cfg, ts, torch.from_numpy(pick), 0, zeros, False)
    np.testing.assert_array_equal(np.asarray(js2), ts2.numpy())
    np.testing.assert_array_equal(np.asarray(jn2), tn2.numpy())
    assert (tn2.numpy() == 1).all()
