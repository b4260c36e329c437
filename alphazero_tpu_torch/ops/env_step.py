"""In-tree transition of the batched search: the CUDA kernel's wrapper and
its plain version.

Port of ``alphazero_tpu/games/splendor/adapter.py::make_search_step_fn``,
which the JAX search runs in XLA (it was never a Pallas kernel).  Every
simulation of every search applies the chosen edge's action to its parent
board: the deterministic env step from the canonical frame (chance
collapsed), the seat swap to the next mover's frame, the terminal vector
and the next mover's valid-move mask.

``search_step`` takes the plain version, ``search_step_plain``, for CPU
tensors; for CUDA tensors it launches ``csrc/env_step.cu`` (one warp per
board, its rows in the lanes' registers; the warp applies the action's one
branch, stores each row at the child row the swap table gives, and fills
the mask in passes of one action kind each) or raises.
``search_step.launches`` counts the kernel's launches.

Precondition, not checked on the card (it would cost a device sync): every
action lies in ``[0, 409)``.  On the CPU an action outside raises; the
kernel applies it as a pass.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..games.splendor import env as E
from ..games.splendor import tables as T
from . import _build

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _PTR,
             _PTR, _PTR, _PTR, _PTR, _PTR]

# bit fields of the packed tables (csrc/env_step.cu reads the same):
# the step word holds the kind, the parameter and the gems taken, the mask
# word the bank's minimum for the take, the gems given back, the exchange
# class and the number of gems taken
STEP_FIELDS = {"kind": (0, 3), "param": (3, 4),
               **{f"take{c}": (7 + 2 * c, 2) for c in range(5)}}
MASK_FIELDS = {**{f"bank_req{c}": (3 * c, 3) for c in range(5)},
               **{f"give{c}": (15 + 2 * c, 2) for c in range(5)},
               "xclass": (25, 2), "take_sum": (27, 2)}


def pack_tables() -> np.ndarray:
    """The action tables of ``tables.py`` as the kernel reads them: ``[2,
    409]`` int32, row 0 the step words, row 1 the mask words.  Raises if a
    value does not fit its field."""
    cols = {"kind": T.ACTION_KIND, "param": T.ACTION_PARAM,
            "xclass": T.ACTION_XCLASS, "take_sum": T.ACTION_TAKE.sum(1)}
    for c in range(5):
        cols[f"take{c}"] = T.ACTION_TAKE[:, c]
        cols[f"bank_req{c}"] = T.ACTION_BANK_REQ[:, c]
        cols[f"give{c}"] = T.ACTION_GIVE[:, c]
    out = np.zeros((2, T.NUM_ACTIONS), np.int64)
    for row, fields in enumerate((STEP_FIELDS, MASK_FIELDS)):
        for name, (shift, bits) in fields.items():
            v = np.asarray(cols[name], np.int64)
            if ((v < 0) | (v >= 1 << bits)).any():
                raise ValueError(f"{name} does not fit {bits} bits")
            out[row] |= v << shift
    return out.astype(np.int32)


# the mask's slots: 13 passes of the warp's 32 lanes
MASK_PASSES = 13
MASK_SLOTS = 32 * MASK_PASSES
IDLE = -1                  # mask_slots' id of an unused slot
MAX_ROWS = E.SplendorConfig(num_players=4).rows
# a slot's level word: a bit per level of a count the action asks for (at
# least 1 or 4 of a colour in the bank, at least 1-3 of the mover's gems of
# a colour, to give back), so that one mask test checks every colour; then
# the kind and the parameter.  The step reads it too: an action takes 2
# gems of a colour where the bank must hold 4, else 0 or 1 as it must hold
SLOT_LEVEL_FIELDS = {"bank1": (0, 5), "bank4": (5, 5), "give_levels": (10, 15),
                     "kind": (25, 3), "param": (28, 4)}
# the board's condition bits that a slot's condition word asks for
COND_BITS = {"allow1": 0, "allow2d": 1,
             **{f"fit{t}": 1 + t for t in (1, 2, 3)},
             **{f"xclass{x}": 4 + x for x in (1, 2, 3)},
             "ex_gate": 8, **{f"held{j}": 9 + j for j in range(15)},
             "rsvg": 24, "no_pending": 25,
             **{f"noble{k}": 26 + k for k in range(3)},
             "bank_nonneg": 29, "gems_nonneg": 30}
# a swap entry: the child row a row goes to, and that child row's owner
# when it is a row of a player's cards or nobles
SWAP_FIELDS = {"dest": (0, 7), "player": (8, 2), "cards": (10, 1),
               "noble": (11, 1)}
# where each part of ``packed_tables`` starts, in int32 words (a slot's two
# words 8-byte aligned, one load)
TABLE_OFFSETS = {"step": 0, "mask": T.NUM_ACTIONS,
                 "slots": 2 * T.NUM_ACTIONS,
                 "swap": 2 * T.NUM_ACTIONS + 2 * MASK_SLOTS}


def mask_slots() -> np.ndarray:
    """The action id of each of the mask's ``MASK_SLOTS`` slots (slot
    ``32 j + lane`` is pass j of that lane), ``IDLE`` where unused: the 30
    card ids fill pass 0 (slot = id), the take and exchange ids, the nobles
    and the pass passes 1-12 (slot = id + 2), so a pass runs one code path
    and stores consecutive ids from consecutive lanes."""
    out = np.full(MASK_SLOTS, IDLE, np.int64)
    ids = np.arange(T.NUM_ACTIONS)
    out[np.where(ids < T.A_TAKE, ids, ids + 2)] = ids
    return out


def slot_words() -> np.ndarray:
    """The two slot words of every action id, ``[2, 409]`` int64: the level
    word (``SLOT_LEVEL_FIELDS``) and the condition word (the ``COND_BITS``
    valid_moves asks of the board besides the levels; the card ids' and the
    pass's are 0: the kernel computes those bits otherwise).  Raises if a
    bank minimum is not 0, 1 or 4, more than 3 gems of a colour are given
    back, the gems taken are not what the bank minimum says, or a take
    takes none."""
    req, give, take = T.ACTION_BANK_REQ, T.ACTION_GIVE, T.ACTION_TAKE
    if not np.isin(req, (0, 1, 4)).all() or (give > 3).any():
        raise ValueError("a bank minimum or a give-back has no level bits")
    if (take != np.where(req == 4, 2, req)).any():
        raise ValueError("the gems taken differ from the bank's minimum")
    c = np.arange(5)
    out = np.zeros((2, T.NUM_ACTIONS), np.int64)
    out[0] = (((req >= 1) << c) | ((req >= 4) << (5 + c))).sum(1)
    for t in range(3):
        out[0] |= ((give > t).astype(np.int64) << (10 + 3 * c + t)).sum(1)
    out[0] |= T.ACTION_KIND.astype(np.int64) << SLOT_LEVEL_FIELDS["kind"][0]
    out[0] |= T.ACTION_PARAM.astype(np.int64) << SLOT_LEVEL_FIELDS["param"][0]
    bit = {k: 1 << v for k, v in COND_BITS.items()}
    for a in range(T.NUM_ACTIONS):
        kind, x = T.ACTION_KIND[a], int(T.ACTION_XCLASS[a])
        if kind == T.KIND_NOBLE:
            out[1, a] = bit[f"noble{a - T.A_NOBLE}"]
        elif kind in (T.KIND_GEMS, T.KIND_RSVG) and x == 0:        # a take
            t = int(take[a].sum())
            if t == 0:
                raise ValueError(f"take {a} takes no gem")
            out[1, a] = (bit["no_pending"] | bit["bank_nonneg"]
                         | bit[f"fit{t}"])
            if a < T.A_TAKE + 5:
                out[1, a] |= bit["allow1"]
            elif a < T.A_TAKE + 15:
                out[1, a] |= bit["allow2d"]
        elif kind in (T.KIND_GEMS, T.KIND_RSVG):                   # exchange
            out[1, a] = (bit["no_pending"] | bit["bank_nonneg"]
                         | bit["gems_nonneg"] | bit[f"xclass{x}"]
                         | bit["ex_gate"])
            if kind == T.KIND_RSVG:
                out[1, a] |= bit[f"held{T.ACTION_PARAM[a]}"] | bit["rsvg"]
    return out


def pack_slots() -> np.ndarray:
    """``slot_words`` in the order of ``mask_slots``, a slot's words side by
    side: ``[MASK_SLOTS, 2]`` int32 (level, condition; zeros in an unused
    slot)."""
    ids = mask_slots()
    used = ids != IDLE
    out = np.zeros((MASK_SLOTS, 2), np.int64)
    out[used] = slot_words()[:, ids[used]].T
    return out.astype(np.uint32).view(np.int32)


def swap_dest_rows(num_players: int, advance: int) -> np.ndarray:
    """For each row of a stepped board, the row of the child it goes to
    when the next mover is seat ``advance`` (0 or 1): ``E.swap_players``
    as a row table, seat q's rows to seat q - advance."""
    cfg = E.SplendorConfig(num_players=num_players)
    n = num_players
    dest = np.arange(cfg.rows)
    for start, per in ((cfg.row_pgems, 1), (cfg.row_pnobles, cfg.num_nobles),
                       (cfg.row_pcards, 1), (cfg.row_prsv, 6)):
        r = np.arange(start, start + per * n)
        dest[r] = start + (r - start - per * advance) % (per * n)
    return dest


def row_owners(num_players: int) -> tuple[np.ndarray, np.ndarray]:
    """For each row of a board: the player whose cards (role 1) or nobles
    (role 2) it holds, and the role (0 and player 0 for any other row)."""
    cfg = E.SplendorConfig(num_players=num_players)
    n, nn = num_players, cfg.num_nobles
    player = np.zeros(cfg.rows, np.int64)
    role = np.zeros(cfg.rows, np.int64)
    player[cfg.row_pcards:cfg.row_pcards + n] = np.arange(n)
    role[cfg.row_pcards:cfg.row_pcards + n] = 1
    player[cfg.row_pnobles:cfg.row_pnobles + n * nn] = np.arange(n * nn) // nn
    role[cfg.row_pnobles:cfg.row_pnobles + n * nn] = 2
    return player, role


def pack_swap() -> np.ndarray:
    """The swap entries of 2-4 players: ``[3, MAX_ROWS, 2]`` uint16 (player
    count, row of the stepped board, advance): ``swap_dest_rows`` and the
    destination's ``row_owners``, as ``SWAP_FIELDS`` lays them out (a row
    past a board's end keeps its index and has no owner)."""
    f = SWAP_FIELDS
    out = np.tile(np.arange(MAX_ROWS, dtype=np.int64)[:, None], (3, 1, 2))
    for p in (2, 3, 4):
        player, role = row_owners(p)
        for adv in (0, 1):
            d = swap_dest_rows(p, adv)
            out[p - 2, :len(d), adv] = (
                d | player[d] << f["player"][0]
                | (role[d] == 1) << f["cards"][0]
                | (role[d] == 2) << f["noble"][0])
    return out.astype(np.uint16)


def packed_tables() -> np.ndarray:
    """Everything the kernel reads of the tables, as one int32 buffer laid
    out as ``TABLE_OFFSETS`` says: ``pack_tables`` (id order), then
    ``pack_slots`` and the uint16 entries of ``pack_swap``."""
    return np.concatenate([pack_tables().ravel(), pack_slots().ravel(),
                           pack_swap().ravel().view(np.int32)])


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    """The packed tables on ``device``, uploaded once."""
    return torch.as_tensor(packed_tables(), device=device)


@functools.lru_cache(maxsize=None)
def _launch():
    """The library's launch function, built and declared once."""
    launch = _build.load("env_step").env_step_launch
    launch.argtypes, launch.restype = _ARGTYPES, ctypes.c_int
    return launch


def search_step_plain(cfg: E.SplendorConfig, states, actions):
    """The transition in plain PyTorch: the deterministic step from the
    canonical frame, re-canonicalize for the next seat, then the terminal
    vector and validity."""
    zeros = torch.zeros((states.shape[0], 2), dtype=torch.float32,
                        device=states.device)
    s2, nxt = E.step(cfg, states, actions, 0, zeros, True)
    # without the noble ply every edge advances exactly one seat
    s2 = E.swap_players(cfg, s2, nxt if cfg.enable_noble_select else 1)
    return s2, E.check_end_game(cfg, s2), E.valid_moves(cfg, s2, 0), nxt


def _check(cfg, states, actions):
    if cfg.num_players not in (2, 3, 4):
        raise ValueError(f"2-4 players, not {cfg.num_players}")
    if (states.dtype != torch.int8 or states.dim() != 3
            or tuple(states.shape[1:]) != (cfg.rows, 7)):
        raise ValueError(f"states must be int8 [B, {cfg.rows}, 7], got "
                         f"{tuple(states.shape)} {states.dtype}")
    if actions.dtype != torch.int64 or tuple(actions.shape) != \
            (states.shape[0],):
        raise ValueError(f"actions must be int64 [{states.shape[0]}], got "
                         f"{tuple(actions.shape)} {actions.dtype}")
    if states.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the search step runs on cuda or cpu tensors, not "
                         f"{states.device}")
    if actions.device != states.device:
        raise ValueError(f"actions on {actions.device}, states on "
                         f"{states.device}")


def search_step(cfg: E.SplendorConfig, states, actions):
    """The in-tree transition of ``states [B, R, 7]`` int8 by ``actions
    [B]`` int64 for seat 0.  Returns ``(child [B, R, 7] int8, term [B, P]
    float32, valid [B, 409] bool, adv [B] int64)``: the child in the next
    mover's frame, its terminal vector (zeros while the game runs), its
    valid mask and the seat advance (1, or 0 on a pending noble-select ply
    that keeps the turn).  On CUDA tensors one kernel launch computes them
    (inputs of another layout are copied to contiguous ones first)."""
    _check(cfg, states, actions)
    if states.device.type == "cpu":
        return search_step_plain(cfg, states, actions)
    states, actions = states.contiguous(), actions.contiguous()
    dev = states.device
    B, P = states.shape[0], cfg.num_players
    child = torch.empty_like(states)
    term = torch.empty((B, P), dtype=torch.float32, device=dev)
    valid = torch.empty((B, T.NUM_ACTIONS), dtype=torch.bool, device=dev)
    adv = torch.empty(B, dtype=torch.int64, device=dev)
    if B:
        with torch.cuda.device(dev):
            err = _launch()(
                states.data_ptr(), actions.data_ptr(), B, P,
                cfg.token_limit, int(cfg.enable_reserve),
                int(cfg.enable_giveback), int(cfg.enable_noble_select),
                cfg.score_win, _tables(dev).data_ptr(), child.data_ptr(),
                term.data_ptr(), valid.data_ptr(), adv.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"env_step kernel launch failed: CUDA error "
                               f"{err}")
        search_step.launches += 1
    return child, term, valid, adv


search_step.launches = 0
