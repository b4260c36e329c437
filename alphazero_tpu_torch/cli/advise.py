"""Interactive/one-shot move advisor from a human-entered board spec
(reference controlable_play.py — the "play against a live opponent" tool).

Port of ``alphazero_tpu/cli/advise.py`` (the same flags, plus
``--device``).  PyYAML is imported only here, when a spec is read.

    python -m alphazero_tpu_torch.cli.advise board.yaml \\
        --checkpoint temp/best.pt -m 10000 --player 0

The YAML format is documented in games/splendor/board_dsl.py.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("board", help="YAML board spec (see board_dsl.py)")
    p.add_argument("--checkpoint", "-c", required=True)
    p.add_argument("--player", type=int, default=0,
                   help="seat whose turn it is")
    p.add_argument("--numMCTSSims", "-m", type=int, default=10000)
    p.add_argument("--numPlayers", "-np", type=int, default=2)
    p.add_argument("--cpuct", type=float, default=2.5)
    p.add_argument("--device", default="cuda",
                   help="device to run on: 'cuda' (the default; raises "
                        "without a GPU) or 'cpu'")
    args = p.parse_args(argv)

    import numpy as np
    import yaml

    from ..games.game_api import SplendorGame
    from ..games.splendor import board_dsl as D
    from ..utils import checkpoint as CKPT
    from .review import review_position

    with open(args.board) as f:
        spec = yaml.safe_load(f)
    board = D.spec_to_state(spec, args.numPlayers, args.player)

    game = SplendorGame(args.numPlayers, device=args.device)
    game.printBoard(board)
    print(f"Player {args.player}'s turn...")

    net, _ = CKPT.load_net(args.checkpoint, game.cfg, game.device)
    return review_position(game, net, np.asarray(board), args.numMCTSSims)


if __name__ == "__main__":
    main()
