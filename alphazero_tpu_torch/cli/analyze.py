"""Analyze a recorded game: per-turn NN value + policy entropy to CSV (+ plot
if matplotlib is present).  Reference analyze.py:38-86.

Port of ``alphazero_tpu/cli/analyze.py`` (the same flags, plus
``--device``); the checkpoint's net version and width come from its meta.

    python -m alphazero_tpu_torch.cli.analyze ./records/game_0.pkl \\
        -c ./temp/best.pt
"""

from __future__ import annotations

import argparse
import csv
import pickle

import numpy as np
import torch

from ..games.game_api import SplendorGame
from ..models import splendor_net as N
from ..utils import checkpoint as CKPT


@torch.inference_mode()
def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("record")
    p.add_argument("--checkpoint", "-c", required=True)
    p.add_argument("--numPlayers", "-np", type=int, default=2)
    p.add_argument("--output", "-o", default="report.csv")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device to run on: 'cuda' (the default; raises "
                        "without a GPU) or 'cpu'")
    args = p.parse_args(argv)

    with open(args.record, "rb") as f:
        boards = pickle.load(f)

    game = SplendorGame(args.numPlayers, device=args.device)
    dev = game.device
    net, _ = CKPT.load_net(args.checkpoint, game.cfg, dev)

    rows = []
    for turn, board in enumerate(boards):
        board = np.asarray(board)
        seat = turn % args.numPlayers
        canon = game.getCanonicalForm(board, seat)
        valids = game.getValidMoves(canon, 0)
        probs, v, _ = N.apply_inference(
            net, torch.as_tensor(canon, device=dev)[None].to(torch.float32),
            torch.as_tensor(valids, device=dev)[None])
        pi = probs[0].cpu().numpy()
        nz = pi[pi > 1e-12]
        entropy = float(-(nz * np.log(nz)).sum())
        value = float(v[0, 0])
        rows.append({"turn": turn, "seat": seat, "value": value,
                     "entropy": entropy,
                     "score0": game.getScore(board, 0),
                     "score1": game.getScore(board, 1)})

    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=rows[0].keys())
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.output} ({len(rows)} turns)")

    if args.plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            t = [r["turn"] for r in rows]
            plt.figure(figsize=(10, 4))
            plt.plot(t, [r["value"] for r in rows], label="value (mover)")
            plt.plot(t, [r["entropy"] for r in rows], label="policy entropy")
            plt.legend()
            plt.xlabel("turn")
            out = args.output.replace(".csv", ".png")
            plt.savefig(out, dpi=120, bbox_inches="tight")
            print(f"wrote {out}")
        except ImportError:
            print("matplotlib not available; skipped plot")
    return rows


if __name__ == "__main__":
    main()
