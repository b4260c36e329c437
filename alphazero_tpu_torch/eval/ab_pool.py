"""Process-pool AlphaBeta agent for the batched arena.

Port of ``alphazero_tpu/eval/ab_pool.py``.  The reference pits its NN+MCTS
player against ``AlphaBetaPlayer`` at depth 6 with a 10 s per-move
wall-clock deadline (SplendorPlayers.py:15-16,252-283): a host search of
one board at a time, which the lockstep ``BatchArena`` would serialize, so
the boards of each wave go to a persistent pool of worker processes.

The workers run on the CPU on purpose, as the JAX workers pin the CPU
platform: each owns a ``SplendorGame(device="cpu")`` and one torch thread
(``torch.set_num_threads(1)``), so N workers do not oversubscribe the
host.  The NN side of the same pit stays on the card.  The pool uses the
``spawn`` start method: each worker is a fresh interpreter (nothing of the
parent's CUDA state is inherited, as it would be under ``fork``) that
hides the GPUs (``CUDA_VISIBLE_DEVICES=""``) before any CUDA call and asks
for ``device="cpu"`` explicitly, so the parent may create the pool before
or after it has touched CUDA.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_G: dict = {}


def _init_worker(num_players: int, depth: int, deadline_s: float,
                 value_ckpt: str | None = None):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    from ..games.game_api import SplendorGame
    from . import players as P
    game = SplendorGame(num_players, device="cpu")
    _G["game"] = game
    value_fn = None
    if value_ckpt:
        # reference AlphaBetaPlayer evaluates leaves with the NN value head
        # (valueFuncNN, SplendorPlayers.py:177-181; pit.py:71-72 passes the
        # NN player's own net in): the same checkpoint in each worker, its
        # version and width from its meta
        from ..games.splendor import adapter as A
        from ..models import splendor_net as N
        from ..utils import checkpoint as C
        net, _ = C.load_net(value_ckpt, game.cfg, "cpu")
        valid_fn = A.make_valid_fn(game.cfg)

        @torch.inference_mode()
        def value_fn(board):
            state = torch.as_tensor(np.asarray(board))[None]
            _, v, _ = N.apply_inference(net, state.to(torch.float32),
                                        valid_fn(state))
            return float(v[0, 0])
        value_fn(game.getInitBoard())
    _G["player"] = P.AlphaBetaPlayer(game, depth=depth, deadline_s=deadline_s,
                                     value_fn=value_fn)
    # the env's tables are built at first use; build them before the first
    # real move's deadline starts
    b = game.getInitBoard()
    game.getValidMoves(b, 0)
    game.getNextState(b, 0, int(np.flatnonzero(game.getValidMoves(b, 0))[0]),
                      deterministic=True)
    game.getGameEnded(b)
    game.getScore(b, 0)


def _play_one(board: np.ndarray) -> int:
    game = _G["game"]
    if game.getGameEnded(board).any():
        # lockstep arenas keep stepping finished games; answer instantly
        # with any legal move instead of burning the deadline
        return int(np.flatnonzero(game.getValidMoves(board, 0))[0])
    return int(_G["player"].play(board))


class AlphaBetaPool:
    """Persistent worker pool exposing the batched-arena Agent protocol:
    ``agent(canonical_states [B,R,7], generator) -> actions [B]``, an int64
    tensor on the states' device."""

    def __init__(self, num_players: int, depth: int = 6,
                 deadline_s: float = 10.0, workers: int | None = None,
                 value_ckpt: str | None = None):
        import multiprocessing as mp
        self.workers = workers or max(os.cpu_count() or 2, 1)
        ctx = mp.get_context("spawn")
        self.pool = ctx.Pool(self.workers, initializer=_init_worker,
                             initargs=(num_players, depth, deadline_s,
                                       value_ckpt))

    def agent(self, canon, generator=None):
        boards = canon.cpu().numpy()
        actions = self.pool.map(_play_one,
                                [boards[i] for i in range(len(boards))],
                                chunksize=1)
        return torch.as_tensor(actions, dtype=torch.long,
                               device=canon.device)

    def close(self):
        self.pool.terminate()
        self.pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
