"""Static data + action-space encodings for Splendor: the benchmark's frozen
reference copy.

Everything here is plain numpy computed once at import time; the environment
lifts these into jnp constants.  Two kinds of content live here:

1. Game data (card decks, nobles) and *action-space encodings* (the exact
   409-action indexing and its exchange-move composition tables).  These must
   match the reference framework bit-for-bit for checkpoint/action-id
   compatibility (reference: SplendorLogicNumba.py:100-210, SplendorLogic.py:
   250-297,320-473).  They are data, not code.

2. Derived per-action metadata (ACTION_KIND / TAKE / GIVE / BANK_REQ /
   EXCHANGE_CLASS / ACTION_PARAM) — our own flattening of the reference's
   nested dispatch (SplendorLogicNumba.py:267-289,615-761) into constant
   arrays so that a single vectorized gather implements move legality and
   gem-delta application for all 409 actions at once on TPU.

Action layout (409 actions; reference SplendorLogicNumba.py:30-35,251-289):
    0-11    buy visible card (tier*4 + index)
    12-26   reserve (12 visible cards + 3 decks)
    27-29   buy reserved card 0-2
    30-59   take gems: 25 distinct-color combos (1..3 gems) + 5 "2 identical"
    60-404  exchange moves (345 = NUM_OF_EXCHANGE), see EXCHANGE GROUPS below
    405-407 select noble (WIP in reference — gated off by default here too)
    408     pass (only legal when nothing else is)
"""

from __future__ import annotations

import itertools

import numpy as np

# ----------------------------------------------------------------------------
# Column indices of the 7-wide state rows
# ----------------------------------------------------------------------------
IDX_WHITE, IDX_BLUE, IDX_GREEN, IDX_RED, IDX_BLACK, IDX_GOLD, IDX_POINTS = range(7)

NUM_ACTIONS = 409
NUM_COLORS = 5

# Exchange group sizes (reference SplendorLogicNumba.py:8-19)
NUM_3TAKE_1GIVE = 20
NUM_3TAKE_2GIVE = 30
NUM_2TAKE_DIFF_2GIVE = 60
NUM_2TAKE_SAME_2GIVE = 50
NUM_2TAKE_DIFF_1GIVE = 30
NUM_2TAKE_SAME_1GIVE = 20
NUM_1TAKE_1GIVE = 20
NUM_1TAKEG_1GIVE = 75          # reserve + give back one gem
NUM_3TAKE_3GIVE = 40
NUM_OF_EXCHANGE = (
    NUM_3TAKE_1GIVE + NUM_3TAKE_2GIVE + NUM_2TAKE_DIFF_2GIVE + NUM_2TAKE_SAME_2GIVE
    + NUM_2TAKE_DIFF_1GIVE + NUM_2TAKE_SAME_1GIVE + NUM_1TAKE_1GIVE
    + NUM_1TAKEG_1GIVE + NUM_3TAKE_3GIVE
)
assert NUM_OF_EXCHANGE == 345

# Action-range anchors
A_BUY = 0                  # 12 actions
A_RESERVE = 12             # 15
A_BUY_RESERVE = 27         # 3
A_TAKE = 30                # 30
A_EXCHANGE = 60            # 345 (groups below)
A_T3G1 = 60
A_T3G2 = 80
A_T2DG2 = 110
A_T2SG2 = 170
A_T2DG1 = 220
A_T2SG1 = 250
A_T1G1 = 270
A_RSVG = 290
A_T3G3 = 365
A_NOBLE = 405              # 3
A_PASS = 408


def observation_size(num_players: int) -> tuple[int, int]:
    """State/observation shape (rows, 7). Reference SplendorLogicNumba.py:26-27."""
    return (32 + 10 * num_players + num_players * num_players, 7)


def action_size() -> int:
    return NUM_ACTIONS


# ----------------------------------------------------------------------------
# Gem-combination tables (reference SplendorLogic.py:250-280)
# ----------------------------------------------------------------------------
def _distinct_gem_combos(max_n: int) -> np.ndarray:
    """Rows of 7-wide one-hot sums over distinct colors, n = 1..max_n,
    in itertools.combinations order."""
    singles = [np.eye(7, dtype=np.int8)[c] for c in range(NUM_COLORS)]
    rows = []
    for n in range(1, max_n + 1):
        for comb in itertools.combinations(singles, n):
            rows.append(sum(comb))
    return np.array(rows, dtype=np.int8)


DIFF_UP_TO_3 = _distinct_gem_combos(3)   # 25 rows: 5 singles, 10 pairs, 10 triples
DIFF_UP_TO_2 = _distinct_gem_combos(2)   # 15 rows: 5 singles, 10 pairs
assert DIFF_UP_TO_3.shape == (25, 7) and DIFF_UP_TO_2.shape == (15, 7)


def give_id_to_vec(j: int) -> np.ndarray:
    """Give-ids 0..19: 0-4 one gem, 5-14 two distinct (pair combos), 15-19 two
    identical of color j-15. Reference encodes gives with these indices."""
    if j < 15:
        return DIFF_UP_TO_2[j, :5].astype(np.int8)
    v = np.zeros(5, dtype=np.int8)
    v[j - 15] = 2
    return v


# Exchange composition tables — compatibility data, verbatim ordering from the
# reference (SplendorLogicNumba.py:100-210).  GIVE_IDS[g][i] lists, for take-
# combination i of group g, the eligible give-ids (0..19, see give_id_to_vec).
GIVE_IDS = np.array([
    # group 0: take-3-distinct -> give 1 (the 2 complement colors)
    [[3, 4, 0, 0, 0, 0, 0, 0, 0, 0],
     [2, 4, 0, 0, 0, 0, 0, 0, 0, 0],
     [2, 3, 0, 0, 0, 0, 0, 0, 0, 0],
     [1, 4, 0, 0, 0, 0, 0, 0, 0, 0],
     [1, 3, 0, 0, 0, 0, 0, 0, 0, 0],
     [1, 2, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 4, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 3, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 2, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 1, 0, 0, 0, 0, 0, 0, 0, 0]],
    # group 1: take-3-distinct -> give 2 (pair of complements, or 2 identical)
    [[14, 18, 19, 0, 0, 0, 0, 0, 0, 0],
     [13, 17, 19, 0, 0, 0, 0, 0, 0, 0],
     [12, 17, 18, 0, 0, 0, 0, 0, 0, 0],
     [11, 16, 19, 0, 0, 0, 0, 0, 0, 0],
     [10, 16, 18, 0, 0, 0, 0, 0, 0, 0],
     [9, 16, 17, 0, 0, 0, 0, 0, 0, 0],
     [8, 15, 19, 0, 0, 0, 0, 0, 0, 0],
     [7, 15, 18, 0, 0, 0, 0, 0, 0, 0],
     [6, 15, 17, 0, 0, 0, 0, 0, 0, 0],
     [5, 15, 16, 0, 0, 0, 0, 0, 0, 0]],
    # group 2: take-2-distinct -> give 2
    [[12, 13, 14, 17, 18, 19, 0, 0, 0, 0],
     [10, 11, 14, 16, 18, 19, 0, 0, 0, 0],
     [9, 11, 13, 17, 16, 19, 0, 0, 0, 0],
     [9, 10, 12, 17, 16, 18, 0, 0, 0, 0],
     [7, 8, 14, 15, 19, 18, 0, 0, 0, 0],
     [6, 8, 13, 15, 19, 17, 0, 0, 0, 0],
     [6, 7, 12, 15, 18, 17, 0, 0, 0, 0],
     [5, 8, 11, 15, 19, 16, 0, 0, 0, 0],
     [5, 7, 10, 15, 18, 16, 0, 0, 0, 0],
     [6, 5, 9, 15, 16, 17, 0, 0, 0, 0]],
    # group 3: take-2-identical -> give 2
    [[9, 12, 13, 10, 11, 14, 17, 16, 18, 19],
     [6, 7, 8, 12, 13, 14, 15, 17, 18, 19],
     [5, 7, 8, 10, 11, 14, 15, 16, 18, 19],
     [6, 5, 8, 9, 13, 11, 15, 17, 16, 19],
     [6, 5, 7, 9, 12, 10, 15, 17, 16, 18],
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0]],
    # group 4: take-2-distinct -> give 1
    [[2, 3, 4, 0, 0, 0, 0, 0, 0, 0],
     [1, 3, 4, 0, 0, 0, 0, 0, 0, 0],
     [1, 2, 4, 0, 0, 0, 0, 0, 0, 0],
     [1, 2, 3, 0, 0, 0, 0, 0, 0, 0],
     [0, 3, 4, 0, 0, 0, 0, 0, 0, 0],
     [0, 2, 4, 0, 0, 0, 0, 0, 0, 0],
     [0, 2, 3, 0, 0, 0, 0, 0, 0, 0],
     [0, 1, 4, 0, 0, 0, 0, 0, 0, 0],
     [0, 1, 3, 0, 0, 0, 0, 0, 0, 0],
     [0, 1, 2, 0, 0, 0, 0, 0, 0, 0]],
    # group 5: take-2-identical -> give 1
    [[1, 2, 3, 4, 0, 0, 0, 0, 0, 0],
     [0, 2, 3, 4, 0, 0, 0, 0, 0, 0],
     [0, 1, 3, 4, 0, 0, 0, 0, 0, 0],
     [0, 1, 2, 4, 0, 0, 0, 0, 0, 0],
     [0, 1, 2, 3, 0, 0, 0, 0, 0, 0],
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
     [0, 0, 0, 0, 0, 0, 0, 0, 0, 0]],
], dtype=np.int8)

# take-1 -> give-1: give-id per action (reference SplendorLogicNumba.py:667,747)
T1G1_GIVE = np.array([1, 2, 3, 4, 0, 2, 3, 4, 0, 1, 3, 4, 0, 1, 2, 4, 0, 1, 2, 3],
                     dtype=np.int8)

# take-3 -> give-3: [take3-id, give-id, give-id] (reference :169-210)
GIVE_IDS3 = np.array([
    [0, 3, 18], [0, 18, 4], [0, 3, 19], [0, 19, 4],
    [1, 2, 17], [1, 17, 4], [1, 2, 19], [1, 19, 4],
    [2, 2, 17], [2, 17, 3], [2, 2, 18], [2, 18, 3],
    [3, 1, 16], [3, 16, 4], [3, 1, 19], [3, 19, 4],
    [4, 1, 16], [4, 16, 3], [4, 1, 18], [4, 18, 3],
    [5, 1, 16], [5, 16, 2], [5, 1, 17], [5, 17, 2],
    [6, 0, 15], [6, 15, 4], [6, 0, 19], [6, 19, 4],
    [7, 0, 15], [7, 15, 3], [7, 0, 18], [7, 18, 3],
    [8, 0, 15], [8, 15, 2], [8, 0, 17], [8, 17, 2],
    [9, 0, 15], [9, 15, 1], [9, 0, 16], [9, 16, 1],
], dtype=np.int8)

# Symmetry permutation tables (reference SplendorLogic.py:283-297)
CARDS_SYMMETRIES = np.array([(1, 3, 0, 2), (2, 0, 3, 1), (3, 2, 1, 0)], dtype=np.int8)
RESERVE_SYMMETRIES = np.array([
    [(-1, -1, -1), (-1, -1, -1)],   # 0 cards reserved
    [(-1, -1, -1), (-1, -1, -1)],   # 1
    [(1, 0, 2), (-1, -1, -1)],      # 2
    [(1, 2, 0), (2, 0, 1)],         # 3
], dtype=np.int8)

# ----------------------------------------------------------------------------
# Card / noble databases (standard Splendor deck; reference SplendorLogic.py:
# 320-473).  Shape per tier: [color][card][cost|gain][7].
# ----------------------------------------------------------------------------
ALL_NOBLES = np.array([
    [0, 0, 4, 4, 0, 0, 3],
    [0, 0, 0, 4, 4, 0, 3],
    [0, 4, 4, 0, 0, 0, 3],
    [4, 0, 0, 0, 4, 0, 3],
    [4, 4, 0, 0, 0, 0, 3],
    [3, 0, 0, 3, 3, 0, 3],
    [3, 3, 3, 0, 0, 0, 3],
    [0, 0, 3, 3, 3, 0, 3],
    [0, 3, 3, 3, 0, 0, 3],
    [3, 3, 0, 0, 3, 0, 3],
], dtype=np.int8)

ALL_CARDS_1 = np.array([
    [  # gain blue
        [[0, 0, 0, 0, 3, 0, 0], [0, 1, 0, 0, 0, 0, 0]],
        [[1, 0, 0, 0, 2, 0, 0], [0, 1, 0, 0, 0, 0, 0]],
        [[0, 0, 2, 0, 2, 0, 0], [0, 1, 0, 0, 0, 0, 0]],
        [[1, 0, 2, 2, 0, 0, 0], [0, 1, 0, 0, 0, 0, 0]],
        [[0, 1, 3, 1, 0, 0, 0], [0, 1, 0, 0, 0, 0, 0]],
        [[1, 0, 1, 1, 1, 0, 0], [0, 1, 0, 0, 0, 0, 0]],
        [[1, 0, 1, 2, 1, 0, 0], [0, 1, 0, 0, 0, 0, 0]],
        [[0, 0, 0, 4, 0, 0, 0], [0, 1, 0, 0, 0, 0, 1]],
    ],
    [  # gain red
        [[3, 0, 0, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0, 0]],
        [[0, 2, 1, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0, 0]],
        [[2, 0, 0, 2, 0, 0, 0], [0, 0, 0, 1, 0, 0, 0]],
        [[2, 0, 1, 0, 2, 0, 0], [0, 0, 0, 1, 0, 0, 0]],
        [[1, 0, 0, 1, 3, 0, 0], [0, 0, 0, 1, 0, 0, 0]],
        [[1, 1, 1, 0, 1, 0, 0], [0, 0, 0, 1, 0, 0, 0]],
        [[2, 1, 1, 0, 1, 0, 0], [0, 0, 0, 1, 0, 0, 0]],
        [[4, 0, 0, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0, 1]],
    ],
    [  # gain black
        [[0, 0, 3, 0, 0, 0, 0], [0, 0, 0, 0, 1, 0, 0]],
        [[0, 0, 2, 1, 0, 0, 0], [0, 0, 0, 0, 1, 0, 0]],
        [[2, 0, 2, 0, 0, 0, 0], [0, 0, 0, 0, 1, 0, 0]],
        [[2, 2, 0, 1, 0, 0, 0], [0, 0, 0, 0, 1, 0, 0]],
        [[0, 0, 1, 3, 1, 0, 0], [0, 0, 0, 0, 1, 0, 0]],
        [[1, 1, 1, 1, 0, 0, 0], [0, 0, 0, 0, 1, 0, 0]],
        [[1, 2, 1, 1, 0, 0, 0], [0, 0, 0, 0, 1, 0, 0]],
        [[0, 4, 0, 0, 0, 0, 0], [0, 0, 0, 0, 1, 0, 1]],
    ],
    [  # gain white
        [[0, 3, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0, 0]],
        [[0, 0, 0, 2, 1, 0, 0], [1, 0, 0, 0, 0, 0, 0]],
        [[0, 2, 0, 0, 2, 0, 0], [1, 0, 0, 0, 0, 0, 0]],
        [[0, 2, 2, 0, 1, 0, 0], [1, 0, 0, 0, 0, 0, 0]],
        [[3, 1, 0, 0, 1, 0, 0], [1, 0, 0, 0, 0, 0, 0]],
        [[0, 1, 1, 1, 1, 0, 0], [1, 0, 0, 0, 0, 0, 0]],
        [[0, 1, 2, 1, 1, 0, 0], [1, 0, 0, 0, 0, 0, 0]],
        [[0, 0, 4, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0, 1]],
    ],
    [  # gain green
        [[0, 0, 0, 3, 0, 0, 0], [0, 0, 1, 0, 0, 0, 0]],
        [[2, 1, 0, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0, 0]],
        [[0, 2, 0, 2, 0, 0, 0], [0, 0, 1, 0, 0, 0, 0]],
        [[0, 1, 0, 2, 2, 0, 0], [0, 0, 1, 0, 0, 0, 0]],
        [[1, 3, 1, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0, 0]],
        [[1, 1, 0, 1, 1, 0, 0], [0, 0, 1, 0, 0, 0, 0]],
        [[1, 1, 0, 1, 2, 0, 0], [0, 0, 1, 0, 0, 0, 0]],
        [[0, 0, 0, 0, 4, 0, 0], [0, 0, 1, 0, 0, 0, 1]],
    ],
], dtype=np.int8)

ALL_CARDS_2 = np.array([
    [
        [[0, 2, 2, 3, 0, 0, 0], [0, 1, 0, 0, 0, 0, 1]],
        [[0, 2, 3, 0, 3, 0, 0], [0, 1, 0, 0, 0, 0, 1]],
        [[0, 5, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0, 2]],
        [[5, 3, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0, 2]],
        [[2, 0, 0, 1, 4, 0, 0], [0, 1, 0, 0, 0, 0, 2]],
        [[0, 6, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0, 3]],
    ],
    [
        [[2, 0, 0, 2, 3, 0, 0], [0, 0, 0, 1, 0, 0, 1]],
        [[0, 3, 0, 2, 3, 0, 0], [0, 0, 0, 1, 0, 0, 1]],
        [[0, 0, 0, 0, 5, 0, 0], [0, 0, 0, 1, 0, 0, 2]],
        [[3, 0, 0, 0, 5, 0, 0], [0, 0, 0, 1, 0, 0, 2]],
        [[1, 4, 2, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0, 2]],
        [[0, 0, 0, 6, 0, 0, 0], [0, 0, 0, 1, 0, 0, 3]],
    ],
    [
        [[3, 2, 2, 0, 0, 0, 0], [0, 0, 0, 0, 1, 0, 1]],
        [[3, 0, 3, 0, 2, 0, 0], [0, 0, 0, 0, 1, 0, 1]],
        [[5, 0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 1, 0, 2]],
        [[0, 0, 5, 3, 0, 0, 0], [0, 0, 0, 0, 1, 0, 2]],
        [[0, 1, 4, 2, 0, 0, 0], [0, 0, 0, 0, 1, 0, 2]],
        [[0, 0, 0, 0, 6, 0, 0], [0, 0, 0, 0, 1, 0, 3]],
    ],
    [
        [[0, 0, 3, 2, 2, 0, 0], [1, 0, 0, 0, 0, 0, 1]],
        [[2, 3, 0, 3, 0, 0, 0], [1, 0, 0, 0, 0, 0, 1]],
        [[0, 0, 0, 5, 0, 0, 0], [1, 0, 0, 0, 0, 0, 2]],
        [[0, 0, 0, 5, 3, 0, 0], [1, 0, 0, 0, 0, 0, 2]],
        [[0, 0, 1, 4, 2, 0, 0], [1, 0, 0, 0, 0, 0, 2]],
        [[6, 0, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0, 3]],
    ],
    [
        [[2, 3, 0, 0, 2, 0, 0], [0, 0, 1, 0, 0, 0, 1]],
        [[3, 0, 2, 3, 0, 0, 0], [0, 0, 1, 0, 0, 0, 1]],
        [[0, 0, 5, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0, 2]],
        [[0, 5, 3, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0, 2]],
        [[4, 2, 0, 0, 1, 0, 0], [0, 0, 1, 0, 0, 0, 2]],
        [[0, 0, 6, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0, 3]],
    ],
], dtype=np.int8)

ALL_CARDS_3 = np.array([
    [
        [[3, 0, 3, 3, 5, 0, 0], [0, 1, 0, 0, 0, 0, 3]],
        [[7, 0, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0, 4]],
        [[6, 3, 0, 0, 3, 0, 0], [0, 1, 0, 0, 0, 0, 4]],
        [[7, 3, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0, 5]],
    ],
    [
        [[3, 5, 3, 0, 3, 0, 0], [0, 0, 0, 1, 0, 0, 3]],
        [[0, 0, 7, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0, 4]],
        [[0, 3, 6, 3, 0, 0, 0], [0, 0, 0, 1, 0, 0, 4]],
        [[0, 0, 7, 3, 0, 0, 0], [0, 0, 0, 1, 0, 0, 5]],
    ],
    [
        [[3, 3, 5, 3, 0, 0, 0], [0, 0, 0, 0, 1, 0, 3]],
        [[0, 0, 0, 7, 0, 0, 0], [0, 0, 0, 0, 1, 0, 4]],
        [[0, 0, 3, 6, 3, 0, 0], [0, 0, 0, 0, 1, 0, 4]],
        [[0, 0, 0, 7, 3, 0, 0], [0, 0, 0, 0, 1, 0, 5]],
    ],
    [
        [[0, 3, 3, 5, 3, 0, 0], [1, 0, 0, 0, 0, 0, 3]],
        [[0, 0, 0, 0, 7, 0, 0], [1, 0, 0, 0, 0, 0, 4]],
        [[3, 0, 0, 3, 6, 0, 0], [1, 0, 0, 0, 0, 0, 4]],
        [[3, 0, 0, 0, 7, 0, 0], [1, 0, 0, 0, 0, 0, 5]],
    ],
    [
        [[5, 3, 0, 3, 3, 0, 0], [0, 0, 1, 0, 0, 0, 3]],
        [[0, 7, 0, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0, 4]],
        [[3, 6, 3, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0, 4]],
        [[0, 7, 3, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0, 5]],
    ],
], dtype=np.int8)

CARDS_PER_TIER_COLOR = np.array([8, 6, 4], dtype=np.int8)

# Zero-padded unified card array: [tier, color, card(<=8), cost|gain, 7]
ALL_CARDS_PADDED = np.zeros((3, 5, 8, 2, 7), dtype=np.int8)
ALL_CARDS_PADDED[0, :, :8] = ALL_CARDS_1
ALL_CARDS_PADDED[1, :, :6] = ALL_CARDS_2
ALL_CARDS_PADDED[2, :, :4] = ALL_CARDS_3

# Initial packed deck-bit bytes per tier (MSB = card 0): 8->0xFF, 6->0xFC, 4->0xF0
INIT_DECK_BITS = np.array([0xFF, 0xFC, 0xF0], dtype=np.uint8)


# ----------------------------------------------------------------------------
# Derived per-action metadata
# ----------------------------------------------------------------------------
# Action kinds
KIND_BUY, KIND_RESERVE, KIND_BUY_RESERVE, KIND_GEMS, KIND_RSVG, KIND_NOBLE, KIND_PASS = range(7)
# Exchange token classes (player token total vs NUM_TOKEN_LIMIT L):
#   0 = not an exchange;  1 = requires total == L-2;  2 = total == L-1;
#   3 = the else branch (total >= 8 and not L-2/L-1)
XC_NONE, XC_LM2, XC_LM1, XC_ELSE = 0, 1, 2, 3


def _build_action_tables():
    kind = np.zeros(NUM_ACTIONS, dtype=np.int8)
    param = np.zeros(NUM_ACTIONS, dtype=np.int8)      # card slot / reserve slot
    take = np.zeros((NUM_ACTIONS, 5), dtype=np.int8)  # gems gained by player
    give = np.zeros((NUM_ACTIONS, 5), dtype=np.int8)  # gems returned to bank
    bank_req = np.zeros((NUM_ACTIONS, 5), dtype=np.int8)  # min bank for take part
    xclass = np.zeros(NUM_ACTIONS, dtype=np.int8)

    def onehot(c, v=1):
        x = np.zeros(5, dtype=np.int8)
        x[c] = v
        return x

    for a in range(12):                       # buy visible
        kind[a], param[a] = KIND_BUY, a
    for a in range(12, 27):                   # reserve
        kind[a], param[a] = KIND_RESERVE, a - 12
    for a in range(27, 30):                   # buy reserved
        kind[a], param[a] = KIND_BUY_RESERVE, a - 27

    for a in range(30, 55):                   # take distinct combos
        kind[a] = KIND_GEMS
        take[a] = DIFF_UP_TO_3[a - 30, :5]
        bank_req[a] = take[a]
    for a in range(55, 60):                   # take 2 identical (needs bank>=4)
        kind[a] = KIND_GEMS
        take[a] = onehot(a - 55, 2)
        bank_req[a] = onehot(a - 55, 4)

    def set_exchange(a, take_vec, bank_req_vec, give_vec, xc):
        kind[a] = KIND_GEMS
        take[a] = take_vec
        bank_req[a] = bank_req_vec
        give[a] = give_vec
        xclass[a] = xc

    triples = DIFF_UP_TO_3[15:25, :5]
    pairs = DIFF_UP_TO_3[5:15, :5]
    for i in range(NUM_3TAKE_1GIVE):          # 60-79: take3 give1   (L-2)
        t = i // 2
        g = GIVE_IDS[0][t][i % 2]
        set_exchange(A_T3G1 + i, triples[t], triples[t], give_id_to_vec(g), XC_LM2)
    for i in range(NUM_3TAKE_2GIVE):          # 80-109: take3 give2  (L-1)
        t = i // 3
        g = GIVE_IDS[1][t][i % 3]
        set_exchange(A_T3G2 + i, triples[t], triples[t], give_id_to_vec(g), XC_LM1)
    for i in range(NUM_2TAKE_DIFF_2GIVE):     # 110-169: take2d give2 (else)
        t = i // 6
        g = GIVE_IDS[2][t][i % 6]
        set_exchange(A_T2DG2 + i, pairs[t], pairs[t], give_id_to_vec(g), XC_ELSE)
    for i in range(NUM_2TAKE_SAME_2GIVE):     # 170-219: take2s give2 (else)
        t = i // 10
        g = GIVE_IDS[3][t][i % 10]
        set_exchange(A_T2SG2 + i, onehot(t, 2), onehot(t, 4), give_id_to_vec(g), XC_ELSE)
    for i in range(NUM_2TAKE_DIFF_1GIVE):     # 220-249: take2d give1 (L-1)
        t = i // 3
        g = GIVE_IDS[4][t][i % 3]
        set_exchange(A_T2DG1 + i, pairs[t], pairs[t], give_id_to_vec(g), XC_LM1)
    for i in range(NUM_2TAKE_SAME_1GIVE):     # 250-269: take2s give1 (L-1)
        t = i // 4
        g = GIVE_IDS[5][t][i % 4]
        set_exchange(A_T2SG1 + i, onehot(t, 2), onehot(t, 4), give_id_to_vec(g), XC_LM1)
    for i in range(NUM_1TAKE_1GIVE):          # 270-289: take1 give1 (else)
        t = i // 4
        g = T1G1_GIVE[i]
        set_exchange(A_T1G1 + i, onehot(t), onehot(t), give_id_to_vec(g), XC_ELSE)
    for i in range(NUM_1TAKEG_1GIVE):         # 290-364: reserve + give1 (else)
        a = A_RSVG + i
        kind[a] = KIND_RSVG
        param[a] = i // 5                     # reserve slot 0-14
        give[a] = onehot(i % 5)
        xclass[a] = XC_ELSE
    for i in range(NUM_3TAKE_3GIVE):          # 365-404: take3 give3 (else)
        t, g1, g2 = GIVE_IDS3[i]
        gv = give_id_to_vec(g1) + give_id_to_vec(g2)
        set_exchange(A_T3G3 + i, triples[t], triples[t], gv, XC_ELSE)

    for a in range(405, 408):
        kind[a], param[a] = KIND_NOBLE, a - 405
    kind[408] = KIND_PASS
    return kind, param, take, give, bank_req, xclass


(ACTION_KIND, ACTION_PARAM, ACTION_TAKE, ACTION_GIVE,
 ACTION_BANK_REQ, ACTION_XCLASS) = _build_action_tables()

# Sanity invariants
assert (ACTION_TAKE.sum(axis=1) <= 3).all() and (ACTION_GIVE.sum(axis=1) <= 3).all()
assert (ACTION_XCLASS[60:405] != XC_NONE).all()
assert (ACTION_XCLASS[:60] == XC_NONE).all() and (ACTION_XCLASS[405:] == XC_NONE).all()
