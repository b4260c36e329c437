"""The in-tree transition (``ops/env_step.py``) against JAX's
``adapter.make_search_step_fn``, and the wrapper's host side.

The kernel (``ops/csrc/env_step.cu``) runs only on the card, where
``chip_smoke.py`` holds it to ``search_step_plain``.  Here ``search_step``
on CPU tensors (its plain version) must equal JAX's transition under
``jax.vmap`` exactly, in all four outputs: the child byte for byte, the
terminal vector bit for bit, the mask and the seat advance.  Inputs are
states reached by seeded numpy playouts of the JAX env (chance on, the
canonical frame, past round 127; one playout per player count, shared by
its configs), each crossed with every action id 0-408, legal or not;
under noble select also one state with two pending noble flags."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.games.splendor import tables as T
from alphazero_tpu_torch.ops import _build
from alphazero_tpu_torch.ops import env_step as ES

# the playouts' batch, and the JAX transition's: the inputs (states x 409
# actions) go through it in chunks of this many boards
CHUNK = 16
# plies after which a playout state is kept (one board each): rounds up to
# 230, past 127 where the int8 round counter wraps
KEEP = (3, 40, 90, 135, 180, 230)

CONFIGS = [
    dict(num_players=2),
    dict(num_players=3),
    dict(num_players=4),
    dict(num_players=2, enable_noble_select=True),
    dict(num_players=4, enable_noble_select=True, token_limit=8),
    dict(num_players=3, enable_reserve=False),
    dict(num_players=2, enable_giveback=False),
]


def _pick_actions(rng, valid):
    """A random legal action per board, buying whenever a coin says so and a
    buy is legal (so games reach cards, nobles and reserves quickly)."""
    out = np.zeros(len(valid), np.int32)
    for b, v in enumerate(valid):
        legal = np.flatnonzero(v)
        buys = legal[(legal < 12) | ((legal >= 27) & (legal < 30))]
        if len(buys) and rng.random() < 0.6:
            out[b] = rng.choice(buys)
        else:
            out[b] = rng.choice(legal)
    return out


@functools.lru_cache(maxsize=None)
def _playout_states(num_players):
    """States of seeded playouts of the JAX env (its default rules at
    ``num_players``, chance on), each in the mover's canonical frame: one
    board at each ply of ``KEEP``.  Shared by the configs of that player
    count: every config's transition is defined on them."""
    jcfg = JE.SplendorConfig(num_players=num_players)

    def init(u, n):
        s = JE.init_with_uniforms(jcfg, u, n)
        return s, JE.valid_moves(jcfg, s, 0)

    def play(s, a, u):
        s2, nxt = JE.step(jcfg, s, a, 0, u, jnp.asarray(False))
        s2 = JE.swap_players(jcfg, s2, nxt)
        return s2, JE.valid_moves(jcfg, s2, 0)
    init, play = jax.jit(jax.vmap(init)), jax.jit(jax.vmap(play))
    rng = np.random.default_rng(num_players)
    s, v = init(jnp.asarray(rng.random((CHUNK, 24), dtype=np.float32)),
                jnp.asarray(np.stack([rng.permutation(10)[:jcfg.num_nobles]
                                      for _ in range(CHUNK)])))
    kept = []
    for t in range(max(KEEP) + 1):
        acts = _pick_actions(rng, np.asarray(v))
        u = rng.random((CHUNK, 2), dtype=np.float32)
        s, v = play(s, jnp.asarray(acts), jnp.asarray(u))
        if t in KEEP:
            kept.append(np.asarray(s)[rng.integers(CHUNK)])
    return np.stack(kept)


def _with_pending_nobles(cfg, state):
    """``state`` with the pending-choice flags of its first two nobles set
    (column 5 of the noble rows), as two nobles earned at once leave it."""
    s = state.copy()
    s[cfg.row_nobles:cfg.row_nobles + cfg.num_nobles] = 0
    s[cfg.row_nobles:cfg.row_nobles + 2, :5] = [[3, 3, 3, 0, 0],
                                                 [0, 0, 4, 4, 0]]
    s[cfg.row_nobles:cfg.row_nobles + 2, 5] = 1
    s[cfg.row_nobles:cfg.row_nobles + 2, 6] = 3
    return s


@pytest.mark.parametrize("kw", CONFIGS,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_search_step_equals_jax(kw):
    jcfg, cfg = JE.SplendorConfig(**kw), E.SplendorConfig(**kw)
    assert dataclasses.astuple(jcfg) == dataclasses.astuple(cfg)
    states = _playout_states(cfg.num_players)
    if cfg.enable_noble_select:
        states = np.concatenate([states,
                                 _with_pending_nobles(cfg, states[2])[None]])
    rounds = states[:, 0, 6].astype(np.int32) & 0xFF
    assert (rounds > 127).any() and (rounds <= 127).any(), rounds
    # the playouts reached the rules that move cards and nobles
    assert states[:, cfg.row_pcards:cfg.row_pcards + cfg.num_players,
                  :5].sum() > 0
    n = len(states)
    inputs = np.repeat(states, T.NUM_ACTIONS, 0)
    actions = np.tile(np.arange(T.NUM_ACTIONS), n)
    pad = -len(inputs) % CHUNK
    jstep = jax.jit(jax.vmap(JA.make_search_step_fn(jcfg)))
    jin = np.concatenate([inputs, inputs[:pad]])
    jact = np.concatenate([actions, actions[:pad]]).astype(np.int32)
    parts = [jstep(jnp.asarray(jin[i:i + CHUNK]),
                   jnp.asarray(jact[i:i + CHUNK]))
             for i in range(0, len(jin), CHUNK)]
    want = [np.concatenate([np.asarray(p[k]) for p in parts])[:len(inputs)]
            for k in range(4)]

    got = ES.search_step(cfg, torch.from_numpy(inputs),
                         torch.from_numpy(actions))
    assert [g.dtype for g in got] == [torch.int8, torch.float32, torch.bool,
                                      torch.int64]
    child, term, valid, adv = (g.numpy() for g in got)
    np.testing.assert_array_equal(child, want[0])
    np.testing.assert_array_equal(term.view(np.int32),
                                  want[1].view(np.int32))
    np.testing.assert_array_equal(valid, want[2])
    np.testing.assert_array_equal(adv, want[3])
    # the adapter's step function is the same transition
    via_adapter = A.make_search_step_fn(cfg)(torch.from_numpy(inputs[:409]),
                                             torch.from_numpy(actions[:409]))
    for a, b in zip(via_adapter, got):
        assert torch.equal(a, b[:409])
    if cfg.enable_noble_select:
        # the made-up pending state: only the two noble choices are legal
        legal = E.valid_moves(cfg, torch.from_numpy(states[-1:]), 0)[0]
        assert legal.nonzero()[:, 0].tolist() == [T.A_NOBLE, T.A_NOBLE + 1]


def test_pack_tables_unpack_to_tables_py():
    packed = ES.pack_tables()
    assert packed.shape == (2, T.NUM_ACTIONS) and packed.dtype == np.int32
    step, mask = packed.astype(np.int64)

    def f(words, fields, name):
        shift, bits = fields[name]
        return (words >> shift) & ((1 << bits) - 1)
    np.testing.assert_array_equal(f(step, ES.STEP_FIELDS, "kind"),
                                  T.ACTION_KIND)
    np.testing.assert_array_equal(f(step, ES.STEP_FIELDS, "param"),
                                  T.ACTION_PARAM)
    np.testing.assert_array_equal(f(mask, ES.MASK_FIELDS, "xclass"),
                                  T.ACTION_XCLASS)
    np.testing.assert_array_equal(f(mask, ES.MASK_FIELDS, "take_sum"),
                                  T.ACTION_TAKE.sum(1))
    for c in range(5):
        np.testing.assert_array_equal(f(step, ES.STEP_FIELDS, f"take{c}"),
                                      T.ACTION_TAKE[:, c])
        np.testing.assert_array_equal(
            f(mask, ES.MASK_FIELDS, f"bank_req{c}"), T.ACTION_BANK_REQ[:, c])
        np.testing.assert_array_equal(f(mask, ES.MASK_FIELDS, f"give{c}"),
                                      T.ACTION_GIVE[:, c])
    # the fields of a word do not overlap and fit in 31 bits
    for fields in (ES.STEP_FIELDS, ES.MASK_FIELDS):
        bits = [b for shift, width in fields.values()
                for b in range(shift, shift + width)]
        assert len(bits) == len(set(bits)) and max(bits) < 31
    # the kernel's buffer starts with these words; its slot level words
    # carry the kind and the parameter
    np.testing.assert_array_equal(
        ES.packed_tables()[:2 * T.NUM_ACTIONS], packed.ravel())
    levels = ES.slot_words()[0]
    for name in ("kind", "param"):
        np.testing.assert_array_equal(f(levels, ES.SLOT_LEVEL_FIELDS, name),
                                      f(step, ES.STEP_FIELDS, name))


def _args(cfg, B=3):
    return (torch.zeros((B, cfg.rows, 7), dtype=torch.int8),
            torch.zeros(B, dtype=torch.int64))


BAD = {
    "states dtype": lambda cfg, s, a: (cfg, s.to(torch.int32), a),
    "states rows": lambda cfg, s, a: (cfg, s[:, 1:], a),
    "states rank": lambda cfg, s, a: (cfg, s[0], a),
    "actions dtype": lambda cfg, s, a: (cfg, s, a.to(torch.int32)),
    "actions length": lambda cfg, s, a: (cfg, s, a[1:]),
    "actions rank": lambda cfg, s, a: (cfg, s, a[:, None]),
    "device": lambda cfg, s, a: (cfg, s.to("meta"), a.to("meta")),
    "players": lambda cfg, s, a: (
        dataclasses.replace(cfg, num_players=5),
        torch.zeros((3, 32 + 50 + 25, 7), dtype=torch.int8), a),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_argument_checks_raise(case):
    cfg = E.SplendorConfig(num_players=2)
    with pytest.raises(ValueError):
        ES.search_step(*BAD[case](cfg, *_args(cfg)))


def test_any_layout_gives_the_same_transition():
    """Views of another layout (a tree's root column, a strided action
    slice) give what their contiguous copies give."""
    cfg = E.SplendorConfig(num_players=2)
    g = torch.Generator().manual_seed(1)
    tree = E.initial_state(cfg, 8, g, device="cpu").view(4, 2, cfg.rows, 7)
    states = tree[:, 0]
    actions = torch.tensor([[0, 5], [30, 6], [290, 7], [408, 8]])[:, 0]
    assert not states.is_contiguous() and not actions.is_contiguous()
    got = ES.search_step(cfg, states, actions)
    want = ES.search_step(cfg, states.contiguous(), actions.contiguous())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cpu_path_never_loads_the_kernel(monkeypatch):
    """On CPU tensors the wrapper takes the plain version: no build, no
    library, no launch counted."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU path reached the kernel build")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    cfg = E.SplendorConfig(num_players=3)
    g = torch.Generator().manual_seed(0)
    states = E.initial_state(cfg, 5, g, device="cpu")
    actions = torch.tensor([0, 12, 30, 290, 408])
    before = ES.search_step.launches
    got = ES.search_step(cfg, states, actions)
    want = ES.search_step_plain(cfg, states, actions)
    assert ES.search_step.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    empty = ES.search_step(cfg, states[:0], actions[:0])
    assert [tuple(x.shape) for x in empty] == [(0, cfg.rows, 7), (0, 3),
                                               (0, 409), (0,)]
