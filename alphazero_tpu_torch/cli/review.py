"""Review a recorded position: NN value + top MCTS move probabilities
(reference review.py:11-68).

Port of ``alphazero_tpu/cli/review.py`` (the same flags, plus
``--device``); the checkpoint's net version and width come from its meta.

    python -m alphazero_tpu_torch.cli.review ./records/game_0.pkl --turn 12 \\
        --checkpoint ./temp/best.pt -m 1600
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from ..games.game_api import SplendorGame
from ..games.splendor import adapter as A
from ..games.splendor import strings as S
from ..models import splendor_net as N
from ..search import mcts as M
from ..utils import checkpoint as CKPT


@torch.inference_mode()
def review_position(game, net, board, num_sims=1600, top_k=5):
    """Print the net's value of ``board`` (a canonical numpy board) and the
    top ``top_k`` moves of one ``num_sims`` search of it on ``game``'s
    device (B=1, no depth cap, so the backup's path holds up to
    ``num_sims`` levels); returns ``(pi, q)`` as numpy."""
    dev = game.device
    valids = game.getValidMoves(board, 0)
    state = torch.as_tensor(np.asarray(board), device=dev)[None]
    _, v, _ = N.apply_inference(net, state.to(torch.float32),
                                torch.as_tensor(valids, device=dev)[None])
    print(f"NN value (per seat): {v[0].cpu().numpy().round(3).tolist()}")

    search = M.build_search(
        M.MCTSConfig(num_sims=num_sims), game.cfg.num_players,
        A.make_eval_fn(net.cfg), A.make_search_step_fn(game.cfg),
        A.make_valid_fn(game.cfg), dev)
    res = search(net, state, generator=torch.Generator(dev).manual_seed(0))
    counts = res.raw_counts[0].cpu().numpy()
    q = res.q[0].cpu().numpy()
    pi = counts / max(counts.sum(), 1)
    order = np.argsort(-pi)[:top_k]
    print(f"MCTS root Q: {q.round(3).tolist()}")
    for a in order:
        if pi[a] > 0:
            print(f"  {pi[a]:6.1%}  [{a:3d}] {S.move_to_str(int(a))}")
    return pi, q


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("record", help="pickled game record (list of boards)")
    p.add_argument("--turn", type=int, default=-1)
    p.add_argument("--checkpoint", "-c", required=True)
    p.add_argument("--numMCTSSims", "-m", type=int, default=1600)
    p.add_argument("--numPlayers", "-np", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="device to run on: 'cuda' (the default; raises "
                        "without a GPU) or 'cpu'")
    args = p.parse_args(argv)

    with open(args.record, "rb") as f:
        boards = pickle.load(f)
    board = np.asarray(boards[args.turn])
    game = SplendorGame(args.numPlayers, device=args.device)
    game.printBoard(board)

    net, _ = CKPT.load_net(args.checkpoint, game.cfg, game.device)
    return review_position(game, net, board, args.numMCTSSims)


if __name__ == "__main__":
    main()
