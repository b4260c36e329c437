"""Resume a recorded game from a given turn (reference restart.py:50-97).

Port of ``alphazero_tpu/cli/restart.py`` (the same flags, plus
``--device``); agent specs as in the pit CLI.

    python -m alphazero_tpu_torch.cli.restart ./records/game_0.pkl \\
        --turn 12 ./temp/best.pt random -n 1
"""

from __future__ import annotations

import argparse
import logging
import pickle

import numpy as np

from ..games.game_api import SplendorGame
from .pit import create_player

log = logging.getLogger(__name__)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("record")
    p.add_argument("players", nargs="+",
                   help="agent specs (see pit CLI)")
    p.add_argument("--turn", type=int, default=-1)
    p.add_argument("--numMCTSSims", "-m", type=int, default=0)
    p.add_argument("--numPlayers", "-np", type=int, default=2)
    p.add_argument("--ab-depth", type=int, default=4)
    p.add_argument("--ab-deadline", type=float, default=10.0)
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device to run on: 'cuda' (the default; raises "
                        "without a GPU) or 'cpu'")
    args = p.parse_args(argv)

    with open(args.record, "rb") as f:
        boards = pickle.load(f)
    turn = args.turn if args.turn >= 0 else len(boards) - 1
    board = np.asarray(boards[turn])
    game = SplendorGame(args.numPlayers, seed=args.seed, device=args.device)
    players = [create_player(s, game, args) for s in args.players]

    player = turn % args.numPlayers
    game.printBoard(board)
    log.info("resuming from turn %d, player %d", turn, player)

    for move_i in range(turn, game.cfg.max_moves + 1):
        canon = game.getCanonicalForm(board, player)
        a = players[player % len(players)].play(canon)
        if args.verbose:
            print(f"turn {move_i} P{player}: {game.moveToString(a)}")
        board, player = game.getNextState(board, player, a)
        r = game.getGameEnded(board)
        if r.any():
            game.printBoard(board)
            scores = [game.getScore(board, s)
                      for s in range(args.numPlayers)]
            print(f"result: {r.tolist()} scores: {scores}")
            return
    print("move cap reached")


if __name__ == "__main__":
    main()
