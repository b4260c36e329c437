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
board, the board staged in shared memory, the action's one branch applied,
the rows permuted for the swap as they are stored, the mask's actions
shared among the lanes) or raises.  ``search_step.launches`` counts the
kernel's launches.

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


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    """The packed tables on ``device``, uploaded once."""
    return torch.as_tensor(pack_tables(), device=device)


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
