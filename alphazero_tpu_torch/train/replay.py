"""Self-play examples: the port's own copy of ``Iteration``.

Same columns, dtypes and meaning as ``alphazero_tpu/train/replay.py``'s
``Iteration``, so examples from either package can be mixed on the host.
The replay buffer itself waits for the port of training."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Iteration:
    boards: np.ndarray      # (E, R, 7) int8   canonical
    pi: np.ndarray          # (E, A) float16
    winner: np.ndarray      # (E, P) float16
    scdiff: np.ndarray      # (E, P) int8
    valids: np.ndarray      # (E, A) bool
    surprise: np.ndarray    # (E, P) float16 — per-player |root-Q - winner|

    def __len__(self):
        return len(self.boards)
