"""Baseline agents for pitting (reference SplendorPlayers.py).

Port of ``alphazero_tpu/eval/players.py``, line for line over the port's
``SplendorGame``: the same numpy draws in the same order (each candidate
move's ``getNextState`` draws its chance uniforms, as in JAX), the stable
move-ordering sort, the same pruning and the same heuristic value.

All players expose ``play(board) -> action`` over a canonical (player-0 to
move) numpy board, matching the reference player protocol so the pit CLI and
the batch arena adapter can mix them with NN+MCTS players."""

from __future__ import annotations

import time

import numpy as np

from ..games.game_api import SplendorGame
from ..games.splendor import strings as S


class RandomPlayer:
    """Uniform over valid moves (reference :18-25)."""

    def __init__(self, game: SplendorGame, seed: int = 0):
        self.game = game
        self.rng = np.random.default_rng(seed)

    def play(self, board) -> int:
        valids = self.game.getValidMoves(board, 0)
        return int(self.rng.choice(np.flatnonzero(valids)))


class GreedyPlayer:
    """1-ply score maximizer with the reference's tie-break ladder
    (buys > gem takes > anything, reference :93-115)."""

    def __init__(self, game: SplendorGame, seed: int = 0):
        self.game = game
        self.rng = np.random.default_rng(seed)

    def play(self, board) -> int:
        g = self.game
        valids = g.getValidMoves(board, 0)
        initial = g.getScore(board, 0)
        candidates = []
        for m in np.flatnonzero(valids):
            nxt, _ = g.getNextState(board, 0, int(m), deterministic=True)
            candidates.append((g.getScore(nxt, 0), int(m)))
        max_score = max(c[0] for c in candidates)
        if max_score == initial:
            pool = [m for m in np.flatnonzero(valids) if m < 12]
            if not pool:
                pool = [m for m in np.flatnonzero(valids) if 30 <= m < 60]
            if not pool:
                pool = list(np.flatnonzero(valids))
        else:
            pool = [m for s, m in candidates if s == max_score]
        return int(self.rng.choice(pool))


class HumanPlayer:
    """Interactive console player (reference :29-90)."""

    def __init__(self, game: SplendorGame):
        self.game = game

    def play(self, board) -> int:
        g = self.game
        g.printBoard(board)
        valids = np.flatnonzero(g.getValidMoves(board, 0))
        for i, m in enumerate(valids):
            print(f"  [{i:3d}] {S.move_to_str(int(m))}")
        while True:
            raw = input("move> ").strip()
            if raw.isdigit() and int(raw) < len(valids):
                return int(valids[int(raw)])
            print("invalid choice")


class AlphaBetaPlayer:
    """Depth-limited alpha-beta with a wall-clock deadline, children ordered
    by immediate score gain, small-gem-move pruning, and a value function
    that can be a NN/MCTS evaluator (reference :119-299, kuboyoo's agent)."""

    def __init__(self, game: SplendorGame, depth: int = 4,
                 deadline_s: float = 10.0, value_fn=None, seed: int = 0):
        self.game = game
        self.depth = depth
        self.deadline_s = deadline_s
        self.n = game.getNumberOfPlayers()
        # value_fn(canonical_board) -> scalar value for player 0 of that frame
        self.value_fn = value_fn
        self.rng = np.random.default_rng(seed)

    # ----------------------------------------------------------- internals
    def _children(self, board, player):
        g = self.game
        canon = g.getCanonicalForm(board, player)
        valids = np.flatnonzero(g.getValidMoves(canon, 0))
        valids = valids[valids != 408]          # skip pass unless forced
        if len(valids) == 0:
            valids = np.array([408])
        bank_gold = int(board[0, 5])
        my_tokens = int(canon[self.game.cfg.row_pgems, :6].sum())
        out = []
        before = g.getScore(canon, 0)
        for a in valids:
            a = int(a)
            if (bank_gold == 0 or my_tokens == 10) and 12 <= a < 27:
                continue                         # reference :286-290
            nxt, _ = g.getNextState(board, player, a, deterministic=True)
            gain = g.getScore(nxt, player) - before
            out.append((gain, a, nxt))
        out.sort(key=lambda x: -x[0])
        return out

    @staticmethod
    def _prune_small(children):
        """Drop 1-2 gem takes / take3-give1 unless nothing else exists
        (reference pruning, :286-299)."""
        small = lambda a: (29 < a < 45) or (60 <= a < 80)  # noqa: E731
        big = [c for c in children if not small(c[1])]
        return big if big else children

    def _value(self, board, player):
        g = self.game
        canon = g.getCanonicalForm(board, player)
        if self.value_fn is not None:
            v = float(self.value_fn(canon))
        else:                                   # handcrafted fallback
            v = (g.getScore(canon, 0)
                 - max(g.getScore(canon, p) for p in range(1, self.n))) / 15.0
        # value from mover's perspective -> root player's perspective
        return v if player == self.root_player else -v

    def _alphabeta(self, board, player, depth, alpha, beta, deadline):
        ended = self.game.getGameEnded(board)
        if ended.any():
            return 10.0 * float(ended[self.root_player])
        if depth == 0 or time.time() >= deadline:
            return self._value(board, player)
        children = self._prune_small(self._children(board, player))
        nxt_player = (player + 1) % self.n
        if player == self.root_player:
            v = -np.inf
            for _, _, child in children:
                v = max(v, self._alphabeta(child, nxt_player, depth - 1,
                                           alpha, beta, deadline))
                alpha = max(alpha, v)
                if beta <= alpha:
                    break
            return v
        v = np.inf
        for _, _, child in children:
            v = min(v, self._alphabeta(child, nxt_player, depth - 1,
                                       alpha, beta, deadline))
            beta = min(beta, v)
            if beta <= alpha:
                break
        return v

    def play(self, board) -> int:
        """board is canonical (root player = seat 0)."""
        self.root_player = 0
        deadline = time.time() + self.deadline_s
        children = self._prune_small(self._children(board, 0))
        best_a, best_v = children[0][1], -np.inf
        for _, a, child in children:
            v = self._alphabeta(child, 1 % self.n, self.depth - 1,
                                -np.inf, np.inf, deadline)
            if v > best_v:
                best_v, best_a = v, a
            if time.time() >= deadline:
                break
        return int(best_a)
