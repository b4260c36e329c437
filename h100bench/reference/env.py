"""Batched, fixed-shape Splendor environment in plain PyTorch: the
benchmark's frozen reference copy of the env the program steps.

It imports nothing of the program; a change to the program's env does not
move it.  A batch of games is one
``[B, R, 7] int8`` tensor with the same row layout, so states compare byte
for byte with the JAX env.  Every function takes the whole batch:

- Per-board control flow (the JAX ``lax.switch`` on the action kind and the
  ``lax.cond`` on ``deterministic``) is a ``torch.where`` select over all
  branches, so nothing waits on the host.  Each branch computes on the
  whole batch with its indices clamped into range; the select discards the
  branches a board did not take.
- Arithmetic runs on an int32 copy of the state.  The two places where
  int8 really wraps are explicit: the round counter (column 6 of the bank
  row, read back as uint8) and the deck bitmask bytes (``0xFF`` is stored
  as int8 -1).
- Table lookups are index gathers: integer matmul is not available on
  CUDA.
- Chance enters only as uniforms, and the draw divides integer-exact
  float32 cumsums exactly as the JAX env does, so injected uniforms give
  the same cards.

``player`` is a Python int on every canonical path (always 0 in search and
self-play); ``step`` returns the next player as a ``[B]`` tensor because a
pending noble choice keeps the turn per board.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from . import tables as T

i32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SplendorConfig:
    """Static game configuration (same fields as the JAX env's)."""
    num_players: int = 2
    token_limit: int = 10
    enable_reserve: bool = True
    enable_giveback: bool = True
    enable_noble_select: bool = False
    score_win: int = 15

    @property
    def num_nobles(self) -> int:
        return {2: 3, 3: 4, 4: 5}[self.num_players]

    @property
    def num_gems_in_play(self) -> int:
        return {2: 4, 3: 5, 4: 7}[self.num_players]

    @property
    def max_moves(self) -> int:
        return 62 * self.num_players

    @property
    def row_bank(self) -> int:
        return 0

    @property
    def row_cards(self) -> int:
        return 1

    @property
    def row_decks(self) -> int:
        return 25

    @property
    def row_nobles(self) -> int:
        return 31

    @property
    def row_pgems(self) -> int:
        return 31 + self.num_nobles

    @property
    def row_pnobles(self) -> int:
        return self.row_pgems + self.num_players

    @property
    def row_pcards(self) -> int:
        return self.row_pnobles + self.num_players * self.num_nobles

    @property
    def row_prsv(self) -> int:
        return self.row_pcards + self.num_players

    @property
    def rows(self) -> int:
        return self.row_prsv + 6 * self.num_players

    @property
    def observation_shape(self) -> tuple[int, int]:
        return (self.rows, 7)

    @property
    def num_actions(self) -> int:
        return T.NUM_ACTIONS


_TABLES: dict[str, SimpleNamespace] = {}


def _tables(device: torch.device) -> SimpleNamespace:
    """The constant tables as int64 tensors on ``device`` (built once)."""
    key = str(device)
    if key not in _TABLES:
        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)
        _TABLES[key] = SimpleNamespace(
            kind=t(T.ACTION_KIND), param=t(T.ACTION_PARAM),
            take=t(T.ACTION_TAKE), give=t(T.ACTION_GIVE),
            bank_req=t(T.ACTION_BANK_REQ), xclass=t(T.ACTION_XCLASS),
            cards_flat=t(T.ALL_CARDS_PADDED.reshape(120, 2, 7)),
            nobles=t(T.ALL_NOBLES),
            buyrsv_perm=t([[2, 3, 4, 5], [0, 1, 4, 5], [0, 1, 2, 3]]),
            ar7=torch.arange(7, device=device),
            shifts=7 - torch.arange(8, device=device),
        )
    return _TABLES[key]


# ----------------------------------------------------------------------------
# Row helpers on the int32 working copy ``S [B, R, 7]``.  A row index is a
# Python int (same row for every board) or a ``[B]`` tensor (one per board).
# Every helper returns a new tensor and leaves its input untouched.
# ----------------------------------------------------------------------------
def _wrap8(x):
    """The value an int8 store of int32 ``x`` holds (two's-complement wrap)."""
    return ((x + 128) & 0xFF) - 128


def _ar(S):
    return torch.arange(S.shape[0], device=S.device)


def _row(S, row):
    return S[:, row] if isinstance(row, int) else S[_ar(S), row]


def _set_row(S, row, vals):
    S = S.clone()
    if isinstance(row, int):
        S[:, row] = vals
    else:
        S[_ar(S), row] = vals
    return S


def _set2_rows(S, row, vals):
    """Rows ``row`` and ``row + 1`` <- ``vals [B, 2, 7]`` (or a scalar)."""
    S = S.clone()
    if isinstance(vals, (int, float)):
        vals = torch.full((S.shape[0], 2, 7), vals, dtype=S.dtype,
                          device=S.device)
    if isinstance(row, int):
        S[:, row:row + 2] = vals
    else:
        ar = _ar(S)
        S[ar, row] = vals[:, 0]
        S[ar, row + 1] = vals[:, 1]
    return S


def _sel(mask, a, b):
    """Per-board select between two state batches."""
    return torch.where(mask[:, None, None], a, b)


def _as_batch(x, S):
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((S.shape[0],), int(x), dtype=torch.long, device=S.device)


# ----------------------------------------------------------------------------
# Initialization
# ----------------------------------------------------------------------------
def empty_state(cfg: SplendorConfig, device="cuda") -> torch.Tensor:
    """Bank + full decks, no visible cards / nobles: one ``[R, 7]`` int8."""
    s = np.zeros(cfg.observation_shape, dtype=np.int8)
    s[0, :5] = cfg.num_gems_in_play
    s[0, 5] = 5
    for tier in range(3):
        s[cfg.row_decks + 2 * tier, :5] = T.CARDS_PER_TIER_COLOR[tier]
        s[cfg.row_decks + 2 * tier + 1, :5] = \
            T.INIT_DECK_BITS[tier].astype(np.int8)
    return torch.as_tensor(s, device=torch.device(device))


def _draw_deck_card(cfg, S, tier, u0, u1):
    """Pick a random remaining card of ``tier [B]``: color by the per-color
    counts, then card by the remaining bitmask.  Returns
    ``(S', card [B, 2, 7], has [B])``."""
    Tb = _tables(S.device)
    ar = _ar(S)
    crow = cfg.row_decks + 2 * tier
    crow_full, brow_full = S[ar, crow], S[ar, crow + 1]
    counts = crow_full[:, :5]
    total = counts.sum(1)
    has = total > 0
    cum = (torch.cumsum(counts.to(torch.float32), 1)
           / total.clamp(min=1).to(torch.float32)[:, None])
    color = (cum <= u0[:, None]).sum(1).clamp(0, 4)
    col_m = Tb.ar7[None, :] == color[:, None]

    byte = (brow_full * col_m).sum(1) & 0xFF                  # uint8 view
    bits = (byte[:, None] >> Tb.shifts[None, :]) & 1
    nb = bits.sum(1).clamp(min=1)
    bcum = (torch.cumsum(bits.to(torch.float32), 1)
            / nb.to(torch.float32)[:, None])
    card_idx = (bcum <= u1[:, None]).sum(1).clamp(0, 7)

    clear = torch.bitwise_left_shift(torch.ones_like(card_idx), 7 - card_idx)
    new_byte = byte & ~clear & 0xFF
    card = Tb.cards_flat[tier * 40 + color * 8 + card_idx]      # [B, 2, 7]

    new_crow = torch.where(col_m, crow_full - 1, crow_full)
    new_brow = torch.where(col_m, _wrap8(new_byte)[:, None], brow_full)
    S2 = S.clone()
    S2[ar, crow] = new_crow.to(S.dtype)
    S2[ar, crow + 1] = new_brow.to(S.dtype)
    return _sel(has, S2, S), card.to(S.dtype), has


def _fill_slot(cfg, S, tier, index, deterministic, u0, u1):
    """Clear a visible-card slot and, unless deterministic, refill it from
    the deck.  ``deterministic``: Python bool or ``[B]`` bool tensor."""
    row = cfg.row_cards + 8 * tier + 2 * index
    S = _set2_rows(S, row, 0)
    if deterministic is True:
        return S
    S2, card, has = _draw_deck_card(cfg, S, _as_batch(tier, S), u0, u1)
    drawn = _sel(has, _set2_rows(S2, row, card), S2)
    if deterministic is False:
        return drawn
    return _sel(deterministic, S, drawn)


def init_with_uniforms(cfg: SplendorConfig, uniforms24: torch.Tensor,
                       noble_indices: torch.Tensor) -> torch.Tensor:
    """Initial states given their randomness: ``uniforms24 [B, 24]`` fill
    the 12 visible cards in tier-major order, ``noble_indices [B,
    num_nobles]`` pick distinct nobles of the 10-noble table."""
    device = uniforms24.device
    B = uniforms24.shape[0]
    S = empty_state(cfg, device).to(i32)[None].expand(B, -1, -1).clone()
    u = uniforms24.to(torch.float32)
    k = 0
    for tier in range(3):
        for index in range(4):
            S = _fill_slot(cfg, S, tier, index, False, u[:, k], u[:, k + 1])
            k += 2
    nob = _tables(device).nobles[noble_indices.long()].to(i32)  # [B, nn, 7]
    S[:, cfg.row_nobles:cfg.row_nobles + cfg.num_nobles] = nob
    return S.to(torch.int8)


def initial_state(cfg: SplendorConfig, batch: int,
                  generator: torch.Generator | None = None,
                  device="cuda") -> torch.Tensor:
    """``batch`` random initial states drawn from ``generator``."""
    dev = torch.device(device)
    u = torch.rand(batch, 24, generator=generator, device=dev)
    nobles = torch.rand(batch, 10, generator=generator, device=dev)\
        .argsort(1)[:, :cfg.num_nobles]
    return init_with_uniforms(cfg, u, nobles)


# ----------------------------------------------------------------------------
# Valid moves
# ----------------------------------------------------------------------------
def valid_moves(cfg: SplendorConfig, state: torch.Tensor,
                player: int) -> torch.Tensor:
    """``[B, 409]`` bool mask of legal actions for ``player``."""
    Tb = _tables(state.device)
    S = state.to(i32)
    B = S.shape[0]
    bank = S[:, 0, :5]
    gold_bank = S[:, 0, 5]
    pg_row = S[:, cfg.row_pgems + player]
    pg, pgold = pg_row[:, :5], pg_row[:, 5]
    tokens = pg_row[:, :6].sum(1)
    pc = S[:, cfg.row_pcards + player, :5]

    # buy visible (0-11)
    costs = S[:, 1:25:2, :5]                                     # [B, 12, 5]
    missing = (costs - pg[:, None] - pc[:, None]).clamp(min=0).sum(2)
    buy_ok = (missing <= pgold[:, None]) & (costs.sum(2) != 0)

    # reserve (12-26)
    deck_counts = S[:, cfg.row_decks:cfg.row_decks + 6:2, :5]    # [B, 3, 5]
    not_empty15 = torch.cat([costs.sum(2) != 0, deck_counts.sum(2) != 0], 1)
    rsv_base = cfg.row_prsv + 6 * player
    rsv_rows = S[:, rsv_base:rsv_base + 6]
    slot_free = rsv_rows[:, 5, :5].sum(1) == 0
    rsv_nolimit = not_empty15 & slot_free[:, None]
    rsv_gate = (torch.full_like(slot_free, cfg.enable_reserve)
                & ~((tokens == cfg.token_limit) & (gold_bank > 0)))
    rsv_ok = rsv_nolimit & rsv_gate[:, None]

    # buy reserved (27-29)
    rcosts = rsv_rows[:, 0:6:2, :5]
    rmissing = (rcosts - pg[:, None] - pc[:, None]).clamp(min=0).sum(2)
    buyrsv_ok = (rmissing <= pgold[:, None]) & (rcosts.sum(2) != 0)

    # plain takes (30-59)
    bank_ok_all = (bank[:, None, :] >= Tb.bank_req[None]).all(2)  # [B, 409]
    give_ok_all = (pg[:, None, :] >= Tb.give[None]).all(2)
    take_sum = Tb.take.sum(1)
    take_ok = (bank_ok_all[:, 30:60]
               & (tokens[:, None] + take_sum[None, 30:60] <= cfg.token_limit))
    nz_bank = (bank != 0).sum(1)
    allow_take1 = (tokens == 9) | (nz_bank == 1)
    allow_take2d = (tokens == 8) | (nz_bank == 2)
    take_ok = torch.cat([take_ok[:, 0:5] & allow_take1[:, None],
                         take_ok[:, 5:15] & allow_take2d[:, None],
                         take_ok[:, 15:]], 1)

    # exchanges (60-404)
    L = cfg.token_limit
    xclass_now = torch.where(tokens == L - 2, T.XC_LM2,
                             torch.where(tokens == L - 1, T.XC_LM1,
                                         T.XC_ELSE))
    ex_gate = (tokens > 7) & cfg.enable_giveback
    ex_ok = ((Tb.xclass[None] == xclass_now[:, None]) & bank_ok_all
             & give_ok_all & ex_gate[:, None])
    slot15 = Tb.param[T.A_RSVG:T.A_T3G3]
    rsvg_ok = (ex_ok[:, T.A_RSVG:T.A_T3G3] & rsv_nolimit[:, slot15]
               & (gold_bank > 0)[:, None])

    valid = torch.cat([
        buy_ok, rsv_ok, buyrsv_ok, take_ok,
        ex_ok[:, 60:T.A_RSVG], rsvg_ok, ex_ok[:, T.A_T3G3:405],
        torch.zeros((B, T.NUM_ACTIONS - 405), dtype=torch.bool,
                    device=S.device)], 1)
    if cfg.enable_noble_select:
        # pending noble choice: only "select the (k+1)-th eligible noble"
        flags = S[:, cfg.row_nobles:cfg.row_nobles + cfg.num_nobles, 5]
        n_elig = flags.sum(1)
        sel = torch.zeros_like(valid)
        k = torch.arange(T.A_PASS - T.A_NOBLE, device=S.device)
        sel[:, T.A_NOBLE:T.A_PASS] = k[None, :] < n_elig[:, None]
        valid = torch.where((n_elig > 0)[:, None], sel, valid)
    valid[:, T.A_PASS] = ~valid[:, :T.A_PASS].any(1)
    return valid


# ----------------------------------------------------------------------------
# Move application
# ----------------------------------------------------------------------------
def _award_nobles(cfg, S, player, select):
    """Give every noble whose requirement the player now meets; with
    ``select``, two or more eligible nobles set the pending-choice flags
    (column 5 of the noble rows) instead."""
    pc = S[:, cfg.row_pcards + player, :5]
    rn, nn_ = cfg.row_nobles, cfg.num_nobles
    if select:
        req = S[:, rn:rn + nn_, :5]                               # [B, nn, 5]
        eligible = (req.sum(2) > 0) & (pc[:, None, :] >= req).all(2)
        flagged = S.clone()
        flagged[:, rn:rn + nn_, 5] = eligible.to(S.dtype)
        awarded_all = _award_nobles(cfg, S, player, False)
        return _sel(eligible.sum(1) >= 2, flagged, awarded_all)
    for i in range(nn_):
        noble = S[:, rn + i]
        earned = (noble[:, :5].sum(1) > 0) & (pc >= noble[:, :5]).all(1)
        awarded = S.clone()
        awarded[:, cfg.row_pnobles + nn_ * player + i] = noble
        awarded[:, rn + i] = 0
        S = _sel(earned, awarded, S)
    return S


def _pay_and_gain(cfg, S, cost7, gain7, player, select):
    """Pay for a card (gold covers missing colors) and add its gain row."""
    cost = cost7[:, :5]
    pg_row = S[:, cfg.row_pgems + player]
    pg = pg_row[:, :5]
    pc = S[:, cfg.row_pcards + player, :5]
    missing = (cost - pg - pc).clamp(min=0).sum(1)
    paid = torch.minimum((cost - pc).clamp(min=0), pg)
    S = S.clone()
    S[:, cfg.row_pgems + player, :5] -= paid
    S[:, cfg.row_pgems + player, 5] -= missing
    S[:, 0, :5] += paid
    S[:, 0, 5] += missing
    S[:, cfg.row_pcards + player] += gain7
    return _award_nobles(cfg, S, player, select)


def _first_empty_reserve_row(cfg, S, player):
    base = cfg.row_prsv + 6 * player
    empty = S[:, base:base + 6:2, :5].sum(2) == 0                 # [B, 3]
    return base + 2 * torch.argmax(empty.to(i32), 1)   # first empty, else 0


def _do_reserve(cfg, S, slot15, player, deterministic, u0, u1):
    """Reserve a visible card (slot < 12) or a deck's top card, and take a
    gold token if the bank has one."""
    ar = _ar(S)
    er = _first_empty_reserve_row(cfg, S, player)

    vis = slot15.clamp(max=11)
    row = cfg.row_cards + 2 * vis
    card = torch.stack([S[ar, row], S[ar, row + 1]], 1)
    s_vis = _fill_slot(cfg, _set2_rows(S, er, card), vis // 4, vis % 4,
                       deterministic, u0, u1)

    if deterministic is True:
        s_deck = S
    else:
        S2, dcard, has = _draw_deck_card(cfg, S, (slot15 - 12).clamp(0, 2),
                                         u0, u1)
        drawn = _sel(has, _set2_rows(S2, er, dcard), S2)
        s_deck = (drawn if deterministic is False
                  else _sel(deterministic, S, drawn))
    S = _sel(slot15 < 12, s_vis, s_deck)

    take_gold = (S[:, 0, 5] > 0).to(S.dtype)
    S[:, 0, 5] -= take_gold
    S[:, cfg.row_pgems + player, 5] += take_gold
    return S


def _take_noble(cfg, S, action, player):
    """Noble-select action: award the (k+1)-th flagged noble, clear every
    pending flag."""
    rn, nn_ = cfg.row_nobles, cfg.num_nobles
    k = action - T.A_NOBLE
    flags = S[:, rn:rn + nn_, 5]
    hit = (flags > 0) & (torch.cumsum(flags, 1) == (k + 1)[:, None])
    for i in range(nn_):
        noble = S[:, rn + i].clone()
        noble[:, 5] = 0
        taken = S.clone()
        taken[:, cfg.row_pnobles + nn_ * player + i] = noble
        taken[:, rn + i] = 0
        S = _sel(hit[:, i], taken, S)
        S[:, rn + i, 5] = 0
    return S


def step(cfg: SplendorConfig, state: torch.Tensor, action: torch.Tensor,
         player: int, uniforms: torch.Tensor, deterministic):
    """Apply ``action [B]`` for ``player``; returns ``(state', next_player
    [B])``.  ``uniforms [B, 2]`` are consumed only when a hidden card is
    revealed; ``deterministic`` (Python bool or ``[B]`` bool) collapses
    chance like the search does (empty slots stay empty)."""
    Tb = _tables(state.device)
    S = state.to(i32)
    ar = _ar(S)
    action = action.long()
    det = (deterministic.to(torch.bool).expand(S.shape[0])
           if isinstance(deterministic, torch.Tensor) else bool(deterministic))
    u = uniforms.to(torch.float32)
    u0, u1 = u[:, 0], u[:, 1]
    kind, param = Tb.kind[action], Tb.param[action]
    take, give = Tb.take[action].to(i32), Tb.give[action].to(i32)
    select = cfg.enable_noble_select
    pgems = cfg.row_pgems + player

    # buy a visible card
    pb = param.clamp(0, 11)
    rowb = cfg.row_cards + 2 * pb
    s_buy = _pay_and_gain(cfg, S, S[ar, rowb], S[ar, rowb + 1], player, select)
    s_buy = _fill_slot(cfg, s_buy, pb // 4, pb % 4, det, u0, u1)

    # reserve, and reserve + give back a gem
    s_rsv = _do_reserve(cfg, S, param.clamp(0, 14), player, det, u0, u1)
    s_rsvg = s_rsv.clone()
    s_rsvg[:, pgems, :5] -= give
    s_rsvg[:, 0, :5] += give

    # buy a reserved card, then compact the remaining reserved cards
    base = cfg.row_prsv + 6 * player
    pr = param.clamp(0, 2)
    s_br = _pay_and_gain(cfg, S, S[ar, base + 2 * pr], S[ar, base + 2 * pr + 1],
                         player, select)
    kept = s_br[:, base:base + 6][ar[:, None], Tb.buyrsv_perm[pr]]  # [B,4,7]
    s_br[:, base:base + 4] = kept
    s_br[:, base + 4:base + 6] = 0

    # take / exchange gems
    s_gems = S.clone()
    s_gems[:, pgems, :5] += take - give
    s_gems[:, 0, :5] -= take - give

    out = S                                                  # pass / no-op
    branches = [(T.KIND_BUY, s_buy), (T.KIND_RESERVE, s_rsv),
                (T.KIND_BUY_RESERVE, s_br), (T.KIND_GEMS, s_gems),
                (T.KIND_RSVG, s_rsvg)]
    if select:
        branches.append((T.KIND_NOBLE, _take_noble(cfg, S, action, player)))
    for k, s_k in branches:
        out = _sel(kind == k, s_k, out)

    if select:
        # a pending noble choice keeps the turn and defers the round tick
        pend = out[:, cfg.row_nobles:cfg.row_nobles + cfg.num_nobles, 5]\
            .sum(1) > 0
        adv = torch.where(pend, 0, 1)
        out[:, 0, 6] = _wrap8(out[:, 0, 6] + adv)
        next_player = (player + adv) % cfg.num_players
    else:
        out[:, 0, 6] = _wrap8(out[:, 0, 6] + 1)
        next_player = torch.full_like(action, (player + 1) % cfg.num_players)
    return out.to(torch.int8), next_player.long()


# ----------------------------------------------------------------------------
# Scores / termination / canonicalization
# ----------------------------------------------------------------------------
def get_score(cfg: SplendorConfig, state: torch.Tensor, player: int):
    S = state.to(i32)
    base = cfg.row_pnobles + cfg.num_nobles * player
    return (S[:, cfg.row_pcards + player, 6]
            + S[:, base:base + cfg.num_nobles, 6].sum(1))


def get_round(cfg: SplendorConfig, state: torch.Tensor):
    """Round counter read as uint8 (it is stored as a wrapping int8)."""
    return state[:, 0, 6].to(i32) & 0xFF


def all_scores(cfg: SplendorConfig, state: torch.Tensor):
    return torch.stack([get_score(cfg, state, p)
                        for p in range(cfg.num_players)], 1)


def judge(cfg: SplendorConfig, state: torch.Tensor) -> torch.Tensor:
    """``[B, P]`` winner vector by score with the card-count tiebreak."""
    scores = all_scores(cfg, state)
    score_max = scores.max(1, keepdim=True).values
    S = state.to(i32)
    num_cards = torch.stack(
        [S[:, cfg.row_pcards + p, :5].sum(1)
         for p in range(cfg.num_players)], 1)
    top = scores == score_max
    single = top.sum(1, keepdim=True) == 1
    simple = torch.where(top, 1.0, -1.0)
    masked = torch.where(scores < score_max, 999, num_cards)
    min_ids = masked == masked.min(1, keepdim=True).values
    tie_val = torch.where(min_ids.sum(1, keepdim=True) > 1, 0.01, 1.0)
    tiebreak = torch.where(min_ids, tie_val, -1.0)
    return torch.where(single, simple, tiebreak).to(torch.float32)


def check_end_game(cfg: SplendorConfig, state: torch.Tensor) -> torch.Tensor:
    """``[B, P]`` outcome; zeros while the game is running."""
    rnd = get_round(cfg, state)
    scores = all_scores(cfg, state)
    at_turn_boundary = (rnd % cfg.num_players) == 0
    over = (scores.max(1).values >= cfg.score_win) | (rnd >= cfg.max_moves)
    return torch.where((at_turn_boundary & over)[:, None], judge(cfg, state),
                       0.0).to(torch.float32)


def swap_players(cfg: SplendorConfig, state: torch.Tensor, nb_swaps):
    """Rotate seats so player ``nb_swaps`` (int or ``[B]``) becomes 0."""
    n = cfg.num_players
    out = state.clone()
    per_board = isinstance(nb_swaps, torch.Tensor)

    def roll_block(start, rows_total, rows_per_player):
        block = state[:, start:start + rows_total]
        if per_board:
            idx = (torch.arange(rows_total, device=state.device)[None, :]
                   + rows_per_player * nb_swaps.long()[:, None]) % rows_total
            rolled = torch.gather(block, 1,
                                  idx[:, :, None].expand(-1, -1, 7))
        else:
            rolled = torch.roll(block, -rows_per_player * int(nb_swaps), 1)
        out[:, start:start + rows_total] = rolled

    roll_block(cfg.row_pgems, n, 1)
    roll_block(cfg.row_pnobles, n * cfg.num_nobles, cfg.num_nobles)
    roll_block(cfg.row_pcards, n, 1)
    roll_block(cfg.row_prsv, 6 * n, 6)
    return out
