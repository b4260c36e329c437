"""Human-readable move descriptions (reference SplendorLogic.py:59-248).

The port's own copy of ``alphazero_tpu/games/splendor/strings.py``, so that
the port never imports the JAX package."""

from __future__ import annotations

from . import tables as T

COLOR_NAMES = ["white", "blue", "green", "red", "black", "gold"]


def _gems_str(vec) -> str:
    parts = [f"{int(v)} {COLOR_NAMES[i]}" for i, v in enumerate(vec) if v != 0]
    return ", ".join(parts)


def move_to_str(move: int) -> str:
    kind = int(T.ACTION_KIND[move])
    param = int(T.ACTION_PARAM[move])
    if kind == T.KIND_BUY:
        tier, index = divmod(param, 4)
        return f"buy from tier {tier} index {index}"
    if kind == T.KIND_RESERVE:
        if param < 12:
            tier, index = divmod(param, 4)
            return f"reserve from tier {tier} index {index}"
        return f"reserve from deck of tier {param - 12}"
    if kind == T.KIND_BUY_RESERVE:
        return f"buy from reserve {param}"
    if kind == T.KIND_GEMS:
        take = T.ACTION_TAKE[move]
        give = T.ACTION_GIVE[move]
        if give.sum() == 0:
            return f"take {_gems_str(take)}"
        return f"take {_gems_str(take)} and give back {_gems_str(give)}"
    if kind == T.KIND_RSVG:
        give = T.ACTION_GIVE[move]
        gstr = f"give back {_gems_str(give)}"
        if param < 12:
            tier, index = divmod(param, 4)
            return f"reserve from tier {tier} index {index} and {gstr}"
        return f"reserve from deck of tier {param - 12} and {gstr}"
    if kind == T.KIND_NOBLE:
        return f"select noble {param}"
    return "do nothing"


def row_to_str(row: int, n: int = 2) -> str:
    """Describe a state row (reference SplendorLogic.py:226-248, generalized
    to the num_nobles-per-player layout)."""
    nn = {2: 3, 3: 4, 4: 5}[n]
    if row < 1:
        return "bank"
    if row < 25:
        tier, index = divmod(row - 1, 8)
        return (f"Card in tier {tier} index {index // 2} "
                + ("cost" if index % 2 == 0 else "value"))
    if row < 31:
        t = (row - 25) // 2
        return (f"Nb cards in deck of tier {t}" if (row - 25) % 2 == 0
                else f"Deck bitmask of tier {t}")
    if row < 31 + nn:
        return f"Nobles num {row - 31}"
    base = 31 + nn
    if row < base + n:
        return f"Nb of gems of player {row - base}/{n}"
    base += n
    if row < base + n * nn:
        player, index = divmod(row - base, nn)
        return f"Noble {index} earned by player {player}/{n}"
    base += n * nn
    if row < base + n:
        return f"Cards of player {row - base}/{n}"
    base += n
    if row < base + 6 * n:
        player, index = divmod(row - base, 6)
        return (f"Reserve {index // 2} of player {player}/{n} "
                + ("cost" if index % 2 == 0 else "value"))
    return f"unknown row {row}"
