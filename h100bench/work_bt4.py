"""Operations of SplendorNet version 3 (Leela Chess Zero's BT4 encoder
transformer) from shapes alone, for a configuration's file: its
``net_width`` d, ``net_layers``, ``net_heads`` H, ``net_ffn`` and
``net_smolgen`` (compressed channels c, hidden, generator size).  FLOPs
are 2 per multiply-add of every matmul of ``reference/bt4.py``; the
score-difference head, which the search does not read, and the
elementwise work (activations, norms, softmax, the gating) are not
counted, as in ``work.forward_flops``."""

from __future__ import annotations

from h100bench import work


def token_flops(cfg: dict) -> int:
    """FLOPs that scale with the tokens (board rows): the embedding, and
    per layer Q, K and V, the output, the FFN and smolgen's compression."""
    d, ffn = cfg["net_width"], cfg["net_ffn"]
    comp = cfg["net_smolgen"][0]
    per_layer = 3 * d * d + d * d + 2 * d * ffn + d * comp
    return 2 * (7 * d + cfg["net_layers"] * per_layer)


def board_flops(cfg: dict, rows: int, actions: int = 409) -> int:
    """FLOPs once per board of ``rows`` tokens: per layer smolgen's hidden
    and generator-input layers, the shared generator and the attention's
    two products (QK^T and PV over all heads); then the policy and value
    heads at the width."""
    d, H, T = cfg["net_width"], cfg["net_heads"], rows
    comp, hidden, gen = cfg["net_smolgen"]
    per_layer = (T * comp * hidden + hidden * H * gen + H * gen * T * T
                 + 2 * T * T * d)
    players = cfg["num_players"]
    heads = d * d + d * actions + d * d + d * players
    return 2 * (cfg["net_layers"] * per_layer + heads)


def forward_flops(cfg: dict, actions: int = 409) -> int:
    """FLOPs of one leaf evaluation at the configuration's players."""
    rows = work.rows(cfg["num_players"])
    return rows * token_flops(cfg) + board_flops(cfg, rows, actions)
