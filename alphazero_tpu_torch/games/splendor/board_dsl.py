"""Board-entry DSL: reconstruct an engine state from a human-readable board
description (reference controlable_play.py:34-362 ``yml2board``).

Port of ``alphazero_tpu/games/splendor/board_dsl.py``: host parsing in
numpy that calls the port's ``env.empty_state`` and ``env.swap_players``
on the CPU and returns numpy states, as the JAX module does.

A board spec is a dict (usually parsed from YAML) with keys:

    Tier1/Tier2/Tier3: list of 4 card codes (visible slots, left to right)
    Bank:          6 ints  (5 gem colors + gold)
    Nobles:        list of noble codes (or None for an empty slot)
    Gems:          per player, 6 ints (5 colors + gold)
    Cards:         per player, 5 ints (color bonuses from bought cards)
    Reserve:       per player, list of card codes (0-3)
    PlayersCards:  per player, list of bought card codes (points source)
    PlayersNobles: per player, list of noble codes

Card codes are a color letter (B/R/K/W/G) followed by the card's cost values
sorted descending, e.g. ``W21`` = white card costing 2+1, ``K5333`` = black
tier-3 card costing 5,3,3,3.  This matches the reference's hand-written
``cost_map`` tables (controlable_play.py:42-199), but here the code->card
mapping is derived from the card database so it provably covers every card.

Divergences from the reference (documented repairs):
- bought cards listed in ``PlayersCards`` are also removed from the deck
  (the reference leaves them in, controlable_play.py:330-345, so deck-count
  rows 25-30 of the observation were inconsistent with the visible position);
- works for 2-4 players (the reference hard-codes ``num_players = 2``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import env as E
from . import tables as T

COLOR_LETTERS = "BRKWG"   # card color id 0..4 (reference controlable_play.py:35-41)
# Gem COLUMN order in the state differs from card-color-id order: column c of
# a gem/cost/noble vector is (white, blue, green, red, black) — derived from
# the gain column of each color group in tables.py ALL_CARDS_*.
COLUMN_LETTERS = "WBGRK"


def _card_cost_code(card: np.ndarray) -> str:
    """Cost signature of a [2,7] card: nonzero costs, sorted descending."""
    costs = sorted((int(c) for c in card[0, :5] if c > 0), reverse=True)
    return "".join(str(c) for c in costs)


def _build_code_maps():
    """code -> (tier, color, index) and its inverse, for all 90 cards."""
    by_code: dict[str, tuple[int, int, int]] = {}
    by_id: dict[tuple[int, int, int], str] = {}
    for tier, table in enumerate((T.ALL_CARDS_1, T.ALL_CARDS_2, T.ALL_CARDS_3)):
        for color in range(5):
            for idx in range(table.shape[1]):
                card = table[color, idx]
                code = COLOR_LETTERS[color] + _card_cost_code(card)
                if code in by_code:
                    raise AssertionError(f"ambiguous card code {code}")
                by_code[code] = (tier, color, idx)
                by_id[(tier, color, idx)] = code
    return by_code, by_id


CODE_TO_CARD, CARD_TO_CODE = _build_code_maps()

# Noble codes: letters of the 4-cost colors (reference noble_map,
# controlable_play.py:287-298 — e.g. "RG" = noble needing 4 red + 4 green;
# 3-cost nobles use all three letters).
def _noble_code(noble: np.ndarray) -> str:
    return "".join(COLUMN_LETTERS[c] for c in range(5) if noble[c] > 0)


NOBLE_TO_ID = {}
for _i in range(10):
    NOBLE_TO_ID[_noble_code(T.ALL_NOBLES[_i])] = _i
# the reference accepts letter order as listed in its table; accept any order
for _code, _i in list(NOBLE_TO_ID.items()):
    NOBLE_TO_ID["".join(sorted(_code))] = _i


def lookup_card(code: str) -> tuple[int, int, int]:
    code = code.strip()
    if code not in CODE_TO_CARD:
        raise KeyError(f"unknown card code {code!r}")
    return CODE_TO_CARD[code]


def lookup_noble(code: str) -> int:
    code = code.strip()
    if code in NOBLE_TO_ID:
        return NOBLE_TO_ID[code]
    key = "".join(sorted(code))
    if key in NOBLE_TO_ID:
        return NOBLE_TO_ID[key]
    raise KeyError(f"unknown noble code {code!r}")


def _take_from_deck(state: np.ndarray, cfg, tier: int, color: int, idx: int):
    """Remove card (tier,color,idx) from the deck rows (reference
    _get_select_card, SplendorLogicNumba.py:423-443) and return its [2,7]."""
    crow = cfg.row_decks + 2 * tier
    mask = np.uint8(1) << np.uint8(7 - idx)
    byte = np.uint8(state[crow + 1, color])
    if byte & mask:
        state[crow + 1, color] = np.int8(byte & ~mask)
        state[crow, color] -= 1
    tables = (T.ALL_CARDS_1, T.ALL_CARDS_2, T.ALL_CARDS_3)
    return tables[tier][color, idx]


def spec_to_state(spec: dict, num_players: int = 2,
                  cur_player: int = 0) -> np.ndarray:
    """Build a canonical (rows, 7) int8 state from a board spec.

    The returned state is in ``cur_player``'s frame (seat 0 to move), matching
    the reference's ``getCanonicalForm`` at the end of yml2board
    (controlable_play.py:361)."""
    cfg = E.SplendorConfig(num_players=num_players)
    state = E.empty_state(cfg, "cpu").numpy().copy()

    # visible cards
    for tier, key in enumerate(("Tier1", "Tier2", "Tier3")):
        codes = spec.get(key, [])
        for slot, code in enumerate(codes[:4]):
            if code is None:
                continue
            t, color, idx = lookup_card(code)
            if t != tier:
                raise ValueError(f"card {code!r} is tier {t + 1}, listed in {key}")
            card = _take_from_deck(state, cfg, tier, color, idx)
            r = cfg.row_cards + 8 * tier + 2 * slot
            state[r:r + 2] = card

    # bank (5 colors + gold)
    bank = list(spec.get("Bank", []))
    state[0, :len(bank)] = bank

    # nobles in play
    for i, code in enumerate(spec.get("Nobles", [])[:cfg.num_nobles]):
        if code is None:
            state[cfg.row_nobles + i] = 0
        else:
            state[cfg.row_nobles + i] = T.ALL_NOBLES[lookup_noble(code)]

    for p in range(num_players):
        gems = list(spec.get("Gems", [[0] * 6] * num_players)[p])
        state[cfg.row_pgems + p, :len(gems)] = gems
        bonuses = list(spec.get("Cards", [[0] * 5] * num_players)[p])
        state[cfg.row_pcards + p, :len(bonuses)] = bonuses

        for j, code in enumerate(spec.get("Reserve", [[]] * num_players)[p][:3]):
            t, color, idx = lookup_card(code)
            card = _take_from_deck(state, cfg, t, color, idx)
            r = cfg.row_prsv + 6 * p + 2 * j
            state[r:r + 2] = card

        points = 0
        for code in spec.get("PlayersCards", [[]] * num_players)[p]:
            t, color, idx = lookup_card(code)
            card = _take_from_deck(state, cfg, t, color, idx)   # repair: remove
            points += int(card[1, 6])
        state[cfg.row_pcards + p, 6] = points

        nob = spec.get("PlayersNobles", [[]] * num_players)[p]
        for j, code in enumerate(nob[:cfg.num_nobles]):
            # fill from the block's tail (reference controlable_play.py:349-352)
            row = cfg.row_pnobles + cfg.num_nobles * p + (cfg.num_nobles - 1 - j)
            state[row] = T.ALL_NOBLES[lookup_noble(code)]
            state[cfg.row_pcards + p, 6] += int(T.ALL_NOBLES[lookup_noble(code)][6])

    state = state.astype(np.int8)
    if cur_player:
        state = E.swap_players(cfg, torch.from_numpy(state)[None],
                               cur_player)[0].numpy()
    return state


def state_to_spec(state: np.ndarray, num_players: int = 2) -> dict:
    """Inverse of spec_to_state (for round-trip tests and board export)."""
    cfg = E.SplendorConfig(num_players=num_players)
    s = np.asarray(state)

    def card_code_at(row):
        card = s[row:row + 2]
        if card[1, :5].max() == 0:
            return None
        column = int(np.argmax(card[1, :5]))
        return COLUMN_LETTERS[column] + _card_cost_code(card)

    def noble_code_at(row):
        n = s[row]
        return _noble_code(n) if n[6] > 0 else None

    spec = {
        "Bank": s[0, :6].tolist(),
        "Nobles": [noble_code_at(cfg.row_nobles + i)
                   for i in range(cfg.num_nobles)],
        "Gems": [s[cfg.row_pgems + p, :6].tolist() for p in range(num_players)],
        "Cards": [s[cfg.row_pcards + p, :5].tolist() for p in range(num_players)],
        "Reserve": [], "PlayersNobles": [],
    }
    for tier in range(3):
        spec[f"Tier{tier + 1}"] = [
            card_code_at(cfg.row_cards + 8 * tier + 2 * slot)
            for slot in range(4)]
    for p in range(num_players):
        spec["Reserve"].append(
            [c for j in range(3)
             if (c := card_code_at(cfg.row_prsv + 6 * p + 2 * j)) is not None])
        spec["PlayersNobles"].append(
            [c for i in range(cfg.num_nobles)
             if (c := noble_code_at(cfg.row_pnobles + cfg.num_nobles * p + i))
             is not None])
    return spec
