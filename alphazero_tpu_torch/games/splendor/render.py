"""Terminal board rendering (reference SplendorLogic.py:475-607).

The port's own copy of ``alphazero_tpu/games/splendor/render.py`` (numpy
only): ``print_board(cfg, state)`` takes a numpy ``[R, 7]`` state."""

from __future__ import annotations

import numpy as np

try:
    from colorama import Back, Fore, Style
    LIGHT = [
        Back.LIGHTWHITE_EX + Fore.BLACK,
        Back.LIGHTBLUE_EX + Fore.WHITE,
        Back.LIGHTGREEN_EX + Fore.BLACK,
        Back.LIGHTRED_EX + Fore.BLACK,
        Back.LIGHTBLACK_EX + Fore.WHITE,
        Back.LIGHTYELLOW_EX + Fore.BLACK,
    ]
    RESET = Style.RESET_ALL
    BRIGHT = Style.BRIGHT
except Exception:                                    # pragma: no cover
    LIGHT = [""] * 6
    RESET = BRIGHT = ""


def _score(cfg, st, p):
    nn = cfg.num_nobles
    nob = st[cfg.row_pnobles + nn * p: cfg.row_pnobles + nn * (p + 1)]
    return int(st[cfg.row_pcards + p, 6]) + int(nob[:, 6].sum())


def print_board(cfg, st: np.ndarray) -> None:
    n = cfg.num_players
    rnd = int(np.uint8(st[0, 6]))
    head = " ".join(f"P{p}: {_score(cfg, st, p)} pts" for p in range(n))
    print(f"{'=' * 10} round {rnd}   {head} {'=' * 10}")

    # nobles
    parts = []
    for i in range(cfg.num_nobles):
        noble = st[cfg.row_nobles + i]
        if noble[6] == 0:
            parts.append("<empty>")
        else:
            req = " ".join(f"{LIGHT[c]} {noble[c]} {RESET}"
                           for c in range(5) if noble[c])
            parts.append(f"<{noble[6]}pts {req}>")
    print(f"{BRIGHT}Nobles:{RESET} " + "  ".join(parts))

    # tiers (top down)
    for tier in range(2, -1, -1):
        cells = []
        for i in range(4):
            cost = st[1 + 8 * tier + 2 * i]
            gain = st[2 + 8 * tier + 2 * i]
            if gain[:5].sum() == 0:
                cells.append("  --  ")
                continue
            color = int(np.flatnonzero(gain[:5])[0])
            coststr = "".join(f"{LIGHT[c]}{cost[c]}{RESET}"
                              for c in range(5) if cost[c])
            cells.append(f"{LIGHT[color]} {gain[6]} {RESET}|{coststr}")
        deck_n = int(st[cfg.row_decks + 2 * tier, :5].sum())
        print(f"Tier {tier} ({deck_n:2d} left):  " + "   ".join(cells))

    bank = " ".join(f"{LIGHT[c]} {st[0, c]} {RESET}" for c in range(6))
    print(f"{BRIGHT}Bank:{RESET}   {bank}")

    for p in range(n):
        gems = " ".join(f"{LIGHT[c]} {st[cfg.row_pgems + p, c]} {RESET}"
                        for c in range(6))
        cards = " ".join(f"{LIGHT[c]} {st[cfg.row_pcards + p, c]} {RESET}"
                         for c in range(5))
        rsv = []
        for r in range(3):
            gain = st[cfg.row_prsv + 6 * p + 2 * r + 1]
            if gain[:5].sum():
                color = int(np.flatnonzero(gain[:5])[0])
                rsv.append(f"{LIGHT[color]} {gain[6]} {RESET}")
        rsv_s = (" rsv: " + " ".join(rsv)) if rsv else ""
        print(f"P{p} gems: {gems}  cards: {cards}{rsv_s}")
    print()
