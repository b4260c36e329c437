"""The env-step kernel's host-built tables (``ops/env_step.py``): the seat
swap's row table, the mask's slot order and the packed buffer's layout.

The kernel (``ops/csrc/env_step.cu``) runs only on the card, where
``chip_smoke.py`` holds it to ``search_step_plain``; what it reads of these
tables is checked here.  The swap table, scattered over a numbered board,
must give what the port's ``E.swap_players`` and JAX's
``alphazero_tpu/games/splendor/env.py::swap_players`` give, for every
player count and seat advance."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.games.splendor import tables as T
from alphazero_tpu_torch.ops import _build
from alphazero_tpu_torch.ops import env_step as ES


def _numbered(cfg):
    """A board whose cell (r, c) holds r + 100 c wrapped to int8: every
    row differs from every other in every column."""
    r = np.arange(cfg.rows)[:, None] + 100 * np.arange(7)[None]
    return (((r + 128) % 256) - 128).astype(np.int8)


@pytest.mark.parametrize("players,advance", [(p, a) for p in (2, 3, 4)
                                             for a in (0, 1)])
def test_swap_rows_permute_like_swap_players(players, advance):
    cfg = E.SplendorConfig(num_players=players)
    dest = ES.swap_dest_rows(players, advance)
    assert sorted(dest.tolist()) == list(range(cfg.rows))
    board = _numbered(cfg)
    scattered = np.empty_like(board)
    scattered[dest] = board
    port = E.swap_players(cfg, torch.from_numpy(board)[None], advance)[0]
    np.testing.assert_array_equal(scattered, port.numpy())
    jax_swapped = JE.swap_players(JE.SplendorConfig(num_players=players),
                                  jnp.asarray(board), advance)
    np.testing.assert_array_equal(scattered, np.asarray(jax_swapped))
    # the entries the kernel reads, rows past the board's end left in place
    packed = ES.pack_swap().astype(np.int64)
    assert packed.shape == (3, ES.MAX_ROWS, 2)
    shift, bits = ES.SWAP_FIELDS["dest"]
    entry = packed[players - 2, :, advance]
    np.testing.assert_array_equal((entry[:cfg.rows] >> shift)
                                  & ((1 << bits) - 1), dest)
    np.testing.assert_array_equal(entry[cfg.rows:],
                                  np.arange(cfg.rows, ES.MAX_ROWS))


@pytest.mark.parametrize("players,advance", [(p, a) for p in (2, 3, 4)
                                             for a in (0, 1)])
def test_swap_entries_give_each_players_score_and_cards(players, advance):
    """Summed over the rows the entries mark as a player's cards or
    nobles, a child's column 6 is that player's score and the cards rows'
    first five columns its card count, as the port's env counts them."""
    cfg = E.SplendorConfig(num_players=players)
    rng = np.random.default_rng(10 * players + advance)
    board = rng.integers(-128, 128, (cfg.rows, 7)).astype(np.int8)
    entry = ES.pack_swap().astype(np.int64)[players - 2, :cfg.rows, advance]

    def f(name):
        shift, bits = ES.SWAP_FIELDS[name]
        return (entry >> shift) & ((1 << bits) - 1)
    scattered = np.empty_like(board)
    scattered[f("dest")] = board
    child = torch.from_numpy(scattered)[None]
    v = board.astype(np.int64)
    for q in range(players):
        mine = f("player") == q
        score = (v[:, 6] * ((f("cards") | f("noble")) & mine)).sum()
        cards = (v[:, :5].sum(1) * (f("cards") & mine)).sum()
        assert score == int(E.get_score(cfg, child, q)[0])
        assert cards == int(child[0, cfg.row_pcards + q, :5].int().sum())
    assert not (f("cards") & f("noble")).any()


def test_mask_slots_order_the_ids_by_kind():
    ids = ES.mask_slots()
    assert ids.shape == (ES.MASK_SLOTS,)
    # the kernel's slot of an id: the id for a card id, id + 2 for the rest
    a = np.arange(T.NUM_ACTIONS)
    np.testing.assert_array_equal(ids[np.where(a < T.A_TAKE, a, a + 2)], a)
    used = ids[ids != ES.IDLE]
    # the 408 non-pass ids, each once, and the pass once
    assert sorted(used[used != T.A_PASS].tolist()) == list(range(T.A_PASS))
    assert (used == T.A_PASS).sum() == 1
    kinds = [set(T.ACTION_KIND[p[p != ES.IDLE]].tolist())
             for p in ids.reshape(ES.MASK_PASSES, 32)]
    # one code path per pass: the card kinds in pass 0, none after it
    cards = {T.KIND_BUY, T.KIND_RESERVE, T.KIND_BUY_RESERVE}
    assert kinds[0] == cards
    assert all(not (k & cards) for k in kinds[1:])
    # consecutive ids in consecutive lanes: coalesced stores
    for p in ids.reshape(ES.MASK_PASSES, 32):
        p = p[p != ES.IDLE]
        assert (np.diff(p) == 1).all()


def test_slot_words_unpack_to_tables_py():
    ids = ES.mask_slots()
    used = ids != ES.IDLE
    packed = ES.pack_slots().view(np.uint32).astype(np.int64)
    assert packed.shape == (ES.MASK_SLOTS, 2)
    levels, cond = packed.T
    assert not (levels[~used] | cond[~used]).any()
    a = ids[used]
    levels, cond = levels[used], cond[used]

    def f(name):
        s, b = ES.SLOT_LEVEL_FIELDS[name]
        return (levels[:, None] >> s) & ((1 << b) - 1)
    # the level word: the bank's minimum and the give-backs as level bits,
    # the kind and the parameter
    bit = np.arange(5)
    np.testing.assert_array_equal((f("bank1") >> bit) & 1,
                                  T.ACTION_BANK_REQ[a] >= 1)
    np.testing.assert_array_equal((f("bank4") >> bit) & 1,
                                  T.ACTION_BANK_REQ[a] >= 4)
    give_levels = (f("give_levels") >> (3 * bit)) & 7
    np.testing.assert_array_equal(give_levels, (1 << T.ACTION_GIVE[a]) - 1)
    np.testing.assert_array_equal(f("kind")[:, 0], T.ACTION_KIND[a])
    np.testing.assert_array_equal(f("param")[:, 0], T.ACTION_PARAM[a])
    # what the step reads of it: the gems taken and given back
    taken = np.where((f("bank4") >> bit) & 1, 2, (f("bank1") >> bit) & 1)
    np.testing.assert_array_equal(taken, T.ACTION_TAKE[a])
    given = sum((give_levels >> t) & 1 for t in range(3))
    np.testing.assert_array_equal(given, T.ACTION_GIVE[a])
    # the condition word, per kind of id (the card ids' and the pass's
    # bits are the kernel's own)
    B = {k: 1 << v for k, v in ES.COND_BITS.items()}
    for i, w in zip(a, cond):
        kind, x = T.ACTION_KIND[i], T.ACTION_XCLASS[i]
        if i < T.A_TAKE or i == T.A_PASS:
            assert w == 0, i
        elif kind == T.KIND_NOBLE:
            assert w == B[f"noble{i - T.A_NOBLE}"], i
        elif x == 0:
            gate = (B["allow1"] if i < T.A_TAKE + 5 else
                    B["allow2d"] if i < T.A_TAKE + 15 else 0)
            assert w == (B["no_pending"] | B["bank_nonneg"] | gate
                         | B[f"fit{T.ACTION_TAKE[i].sum()}"]), i
        else:
            rsvg = (B[f"held{T.ACTION_PARAM[i]}"] | B["rsvg"]
                    if kind == T.KIND_RSVG else 0)
            assert w == (B["no_pending"] | B["bank_nonneg"]
                         | B["gems_nonneg"] | B[f"xclass{x}"]
                         | B["ex_gate"] | rsvg), i
    bits = [b for s, w in ES.SLOT_LEVEL_FIELDS.values()
            for b in range(s, s + w)]
    assert sorted(bits) == list(range(32))
    assert len(set(ES.COND_BITS.values())) == len(ES.COND_BITS)
    assert max(ES.COND_BITS.values()) < 31


def test_packed_tables_layout_matches_the_kernel():
    buf = ES.packed_tables()
    o = ES.TABLE_OFFSETS
    assert buf.dtype == np.int32
    np.testing.assert_array_equal(buf[o["step"]:2 * T.NUM_ACTIONS],
                                  ES.pack_tables().ravel())
    assert o["slots"] % 2 == 0
    np.testing.assert_array_equal(buf[o["slots"]:o["swap"]],
                                  ES.pack_slots().ravel())
    np.testing.assert_array_equal(buf[o["swap"]:].view(np.uint16),
                                  ES.pack_swap().ravel())
    # the kernel's constants for the same layout and condition bits
    src = (_build.CSRC / "env_step.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)[;,]", src)[1])
    assert const("kPasses") == ES.MASK_PASSES
    assert const("kMaxRows") == ES.MAX_ROWS
    assert const("kActions") == T.NUM_ACTIONS
    assert o["mask"] == T.NUM_ACTIONS
    assert o["slots"] == 2 * T.NUM_ACTIONS
    assert o["swap"] - o["slots"] == 2 * ES.MASK_SLOTS
    bits = {"kBitAllow1": "allow1", "kBitAllow2d": "allow2d",
            "kBitExGate": "ex_gate", "kBitHeld": "held0", "kBitRsvg": "rsvg",
            "kBitNoPend": "no_pending", "kBitNoble": "noble0",
            "kBitBankNonneg": "bank_nonneg", "kBitGemsNonneg": "gems_nonneg"}
    for k, name in bits.items():
        assert const(k) == ES.COND_BITS[name], k
    assert const("kBitFit") + 1 == ES.COND_BITS["fit1"]
    assert const("kBitXclass") + 1 == ES.COND_BITS["xclass1"]
    assert const("kKindShift") == ES.SLOT_LEVEL_FIELDS["kind"][0]
    assert const("kParamShift") == ES.SLOT_LEVEL_FIELDS["param"][0]
