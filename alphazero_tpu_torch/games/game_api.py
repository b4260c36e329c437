"""Host-side Game API: the reference's 13-method interface (Game.py:1-162)
over numpy states, backed by the port's batched env at B=1.

Port of ``alphazero_tpu/games/game_api.py``: the convenience layer for the
sequential pit, the baseline and alpha-beta players and the single-board
tools; the training and search hot path uses the batched env directly.
Boards go in and come out as numpy ``[R, 7]`` int8 arrays; each call runs
the env on ``device`` (the GPU unless the caller asks for the CPU).

Randomness, as in the JAX API:

- ``getNextState`` draws its two chance uniforms from
  ``np.random.default_rng(seed)`` on every call, ``deterministic=True``
  included, so a game driven by the same seed reveals the same cards;
- ``getInitBoard`` and ``getSymmetries`` draw from a ``torch.Generator``
  seeded with ``seed`` where the JAX API splits a ``PRNGKey``, so their
  draws are not the JAX API's (``env.init_with_uniforms`` and
  ``symmetry.apply_symmetry`` take given draws).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from .splendor import env as E
from .splendor import render
from .splendor import strings as S
from .splendor import symmetry as SYM


class SplendorGame:
    """Reference parity: SplendorGame.py:11-86."""

    def __init__(self, num_players: int = 2, token_limit: int = 10,
                 enable_reserve: bool = True, enable_giveback: bool = True,
                 seed: int = 0, device="cuda"):
        self.cfg = E.SplendorConfig(
            num_players=num_players, token_limit=token_limit,
            enable_reserve=enable_reserve, enable_giveback=enable_giveback)
        self.num_players = num_players
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)

    # --------------------------------------------------------------- helpers
    def _batch(self, board) -> torch.Tensor:
        """One numpy board as a ``[1, R, 7]`` tensor on the device (a copy:
        the board may be a read-only array)."""
        return torch.tensor(np.asarray(board), device=self.device)[None]

    @staticmethod
    def _board(states: torch.Tensor) -> np.ndarray:
        return states[0].cpu().numpy()

    # ------------------------------------------------------------------ API
    @torch.inference_mode()
    def getInitBoard(self) -> np.ndarray:
        return self._board(E.initial_state(self.cfg, 1, self._gen,
                                           self.device))

    def getBoardSize(self):
        return self.cfg.observation_shape

    def getActionSize(self) -> int:
        return self.cfg.num_actions

    def getMaxScoreDiff(self) -> int:
        return 15

    @torch.inference_mode()
    def getNextState(self, board, player, action, deterministic=False):
        u = torch.as_tensor(self._np_rng.random(2), dtype=torch.float32,
                            device=self.device)[None]
        a = torch.tensor([int(action)], device=self.device)
        s2, nxt = E.step(self.cfg, self._batch(board), a, int(player), u,
                         bool(deterministic))
        return self._board(s2), int(nxt[0])

    @torch.inference_mode()
    def getValidMoves(self, board, player) -> np.ndarray:
        return self._board(E.valid_moves(self.cfg, self._batch(board),
                                         int(player)))

    @torch.inference_mode()
    def getGameEnded(self, board, next_player=0) -> np.ndarray:
        return self._board(E.check_end_game(self.cfg, self._batch(board)))

    @torch.inference_mode()
    def getScore(self, board, player) -> int:
        return int(E.get_score(self.cfg, self._batch(board), int(player))[0])

    @torch.inference_mode()
    def getRound(self, board) -> int:
        return int(E.get_round(self.cfg, self._batch(board))[0])

    @torch.inference_mode()
    def getCanonicalForm(self, board, player) -> np.ndarray:
        if player == 0:
            return np.asarray(board)
        return self._board(E.swap_players(self.cfg, self._batch(board),
                                          int(player)))

    @torch.inference_mode()
    def getSymmetries(self, board, pi, valid_actions):
        """Reference returns an explicit expansion (SplendorLogicNumba.py:
        349-395); we return 8 random-symmetry draws of the same group."""
        fn = SYM.batched_random_symmetry(self.cfg)
        n = 8
        boards = self._batch(board).repeat(n, 1, 1)
        pis = torch.as_tensor(np.asarray(pi, np.float32),
                              device=self.device)[None].repeat(n, 1)
        vas = torch.as_tensor(np.asarray(valid_actions, bool),
                              device=self.device)[None].repeat(n, 1)
        b, p, v = fn(self._gen, boards, pis, vas)
        return list(zip(b.cpu().numpy(), p.cpu().numpy(), v.cpu().numpy()))

    def stringRepresentation(self, board) -> bytes:
        return np.asarray(board).tobytes()

    def getNumberOfPlayers(self) -> int:
        return self.num_players

    def moveToString(self, move, current_player=0) -> str:
        return S.move_to_str(int(move))

    def printBoard(self, board) -> None:
        render.print_board(self.cfg, np.asarray(board))

    # reference extras (SplendorGame.py:82-86)
    def disableReserve(self):
        self.cfg = dataclasses.replace(self.cfg, enable_reserve=False)

    def enableReserve(self):
        self.cfg = dataclasses.replace(self.cfg, enable_reserve=True)
