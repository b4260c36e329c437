"""Symmetry augmentation for Splendor: port of
``alphazero_tpu/games/splendor/symmetry.py``.

One random symmetry per sample at training time: the four open card slots
of each tier are permuted by one of four permutations, and each player's
occupied reserve slots by one of the permutations their count allows.  The
reserve-and-give-back action blocks, whose ids name tier card slots, are
permuted with the card slots.

The random choices are inputs here (``tier_choice [.., 3]`` in [0, 4),
``rsv_raw [.., n]`` in [0, 3)), so a caller can hand in the JAX package's
draws; ``batched_random_symmetry`` draws them from a ``torch.Generator``
and permutes rows, ``pi`` and ``valids`` of a batch in one gather each.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import env as E
from . import tables as T

# 4 choices per tier: identity + the reference's three derangements
TIER_PERMS = np.array([[0, 1, 2, 3], [1, 3, 0, 2], [2, 0, 3, 1], [3, 2, 1, 0]],
                      dtype=np.int64)
# reserve-slot perms indexed by occupied count (rows padded with identity)
RSV_PERMS_BY_COUNT = np.array([
    [[0, 1, 2], [0, 1, 2], [0, 1, 2]],   # 0 reserved
    [[0, 1, 2], [0, 1, 2], [0, 1, 2]],   # 1
    [[0, 1, 2], [1, 0, 2], [0, 1, 2]],   # 2 -> may swap first two
    [[0, 1, 2], [1, 2, 0], [2, 0, 1]],   # 3 -> cyclic perms
], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The permutation tables on ``device``, copied there once."""
    return (torch.as_tensor(TIER_PERMS, device=device),
            torch.as_tensor(RSV_PERMS_BY_COUNT, device=device))


def symmetry_perms(cfg: E.SplendorConfig, states, tier_choice, rsv_raw):
    """Per-board source indices: ``row_perm [B, R]`` and ``act_perm [B,
    A]`` such that the permuted state is ``states[b, row_perm[b]]`` and the
    permuted policy ``pi[b, act_perm[b]]``."""
    dev = states.device
    B, n = states.shape[0], cfg.num_players
    tiers, rsvs = _tables(dev)
    tier_choice = torch.as_tensor(tier_choice, device=dev).long()
    rsv_raw = torch.as_tensor(rsv_raw, device=dev).long()
    row_perm = torch.arange(cfg.rows, device=dev).repeat(B, 1)
    act_perm = torch.arange(cfg.num_actions, device=dev).repeat(B, 1)
    s4, s5 = torch.arange(4, device=dev), torch.arange(5, device=dev)

    for t in range(3):
        perm = tiers[tier_choice[:, t]]                             # [B, 4]
        base = cfg.row_cards + 8 * t
        row_perm[:, base + 2 * s4] = base + 2 * perm
        row_perm[:, base + 2 * s4 + 1] = base + 2 * perm + 1
        act_perm[:, 4 * t + s4] = 4 * t + perm
        act_perm[:, 12 + 4 * t + s4] = 12 + 4 * t + perm
        dst = (T.A_RSVG + 5 * (4 * t + s4)[:, None] + s5[None, :]).reshape(-1)
        src = (T.A_RSVG + 5 * (4 * t + perm)[:, :, None] + s5[None, None, :])
        act_perm[:, dst] = src.reshape(B, -1)

    s3 = torch.arange(3, device=dev)
    for p in range(n):
        base = cfg.row_prsv + 6 * p
        rows = states[:, base:base + 6:2, :5].to(torch.int32)      # [B, 3, 5]
        count = (rows.sum(2) > 0).sum(1)
        perm = rsvs[count, rsv_raw[:, p]]                           # [B, 3]
        row_perm[:, base + 2 * s3] = base + 2 * perm
        row_perm[:, base + 2 * s3 + 1] = base + 2 * perm + 1
        if p == 0:
            act_perm[:, 27 + s3] = 27 + perm
    return row_perm, act_perm


def apply_symmetry(cfg: E.SplendorConfig, states, pis, valids, tier_choice,
                   rsv_raw):
    """Batched symmetry with given choices: ``states [B, R, 7]``, ``pis
    [B, A]``, ``valids [B, A]``, ``tier_choice [B, 3]``, ``rsv_raw [B,
    n]``."""
    row_perm, act_perm = symmetry_perms(cfg, states, tier_choice, rsv_raw)
    states = states.gather(1, row_perm[:, :, None].expand(-1, -1,
                                                         states.shape[2]))
    return states, pis.gather(1, act_perm), valids.gather(1, act_perm)


def random_symmetry(cfg: E.SplendorConfig, tier_choice, rsv_raw, state, pi,
                    valids):
    """One sample: ``state (R, 7)``, ``pi (A,)``, ``valids (A,)`` with the
    choices ``tier_choice (3,)`` and ``rsv_raw (n,)``."""
    s, p, v = apply_symmetry(cfg, state[None], pi[None], valids[None],
                             torch.as_tensor(tier_choice)[None],
                             torch.as_tensor(rsv_raw)[None])
    return s[0], p[0], v[0]


def batched_random_symmetry(cfg: E.SplendorConfig):
    """``fn(generator, states, pis, valids, rank=0, world=1)``: one
    uniformly random symmetry per board, its choices drawn from
    ``generator``.  With ``world`` > 1 the boards are rank ``rank``'s block
    of a global batch of ``world`` equal blocks: the choices are drawn for
    the global batch and this block's rows are kept."""
    def fn(generator, states, pis, valids, rank=0, world=1):
        B, dev = states.shape[0], states.device
        rows = slice(rank * B, (rank + 1) * B)
        tier_choice = torch.randint(0, 4, (B * world, 3),
                                    generator=generator, device=dev)[rows]
        rsv_raw = torch.randint(0, 3, (B * world, cfg.num_players),
                                generator=generator, device=dev)[rows]
        return apply_symmetry(cfg, states, pis, valids, tier_choice, rsv_raw)
    return fn
