"""Glue between the Splendor env, the network and the batched MCTS.

Every function here works on a batch: states ``[B, R, 7]`` int8, actions
``[B]``."""

from __future__ import annotations

import weakref

import torch

from ...models import splendor_net as N
from ...ops import env_step as ES
from . import env as E


def net_config_for(cfg: E.SplendorConfig, dropout: float = 0.3,
                   nn_version: int = 1, width: int = 128,
                   dtype: str = "float32", layers: int = N.NetConfig.layers,
                   heads: int = N.NetConfig.heads, ffn: int = N.NetConfig.ffn,
                   smolgen: tuple[int, int, int] = N.NetConfig.smolgen,
                   ) -> N.NetConfig:
    """The net's config for the env; ``layers``, ``heads``, ``ffn`` and
    ``smolgen`` are version 3's sizes (``NetConfig``'s)."""
    return N.NetConfig(
        nb_vect=cfg.rows,
        vect_dim=7,
        action_size=cfg.num_actions,
        num_players=cfg.num_players,
        max_score_diff=15,
        dropout=dropout,
        nn_version=nn_version,
        width=width,
        dtype=dtype,
        layers=layers,
        heads=heads,
        ffn=ffn,
        smolgen=smolgen,
    )


def make_eval_fn(net_cfg: N.NetConfig):
    """eval_fn(net, states, valids) -> (probs, values) by ``N.infer``
    (``states`` int8 or float32 boards; on CUDA tensors the net's forward
    replayed from a CUDA graph); ``net`` is the ``SplendorNet`` that
    evaluates the leaves, and it must have been built from ``net_cfg``
    (checked when a net first comes to the evaluator)."""
    checked = weakref.WeakSet()

    def eval_fn(net, states, valids):
        if net not in checked:
            if net.cfg != net_cfg:
                raise ValueError(f"the net was built from {net.cfg}, the "
                                 f"evaluator from {net_cfg}")
            checked.add(net)
        return N.infer(net, states, valids)
    return eval_fn


def make_uniform_eval_fn(cfg: E.SplendorConfig):
    """Prior-free evaluator: uniform over valid moves, zero value."""
    def eval_fn(bundle, states, valids):
        del bundle
        probs = valids.to(torch.float32)
        probs = probs / probs.sum(-1, keepdim=True).clamp(min=1e-8)
        return probs, torch.zeros((states.shape[0], cfg.num_players),
                                  dtype=torch.float32, device=states.device)
    return eval_fn


def make_search_step_fn(cfg: E.SplendorConfig):
    """In-tree transition on a batch: deterministic step (chance collapsed)
    from the canonical frame, re-canonicalize for the next seat, then the
    terminal vector and validity.  The 4th output is each edge's seat
    advance: 1, or 0 on a pending noble-select ply that keeps the turn.
    One launch of the ``ops/env_step.py`` kernel on the card, its plain
    version on the CPU."""
    def step_fn(states, actions):
        return ES.search_step(cfg, states, actions)
    return step_fn


def make_valid_fn(cfg: E.SplendorConfig):
    def valid_fn(states):
        return E.valid_moves(cfg, states, 0)
    return valid_fn
