"""Pit CLI, batched mode: port of ``alphazero_tpu/cli/pit.py --batched``
(the same flags, plus ``--device``).

Agent specs: ``random``, ``greedy`` or a checkpoint path (NN + MCTS, its
search settings and net shape read from the checkpoint's meta).  Two
specs play a pairwise match; ``--tournament DIR`` plays a round robin of
the checkpoints under DIR and keeps Glicko-2 ratings with ``--ratings``.
The sequential host mode, ``alphabeta``, ``human``, ``--record-dir`` and
``--token-limits`` come with the tooling slice of the port and raise
``NotImplementedError`` here.

Example:
    python -m alphazero_tpu_torch.cli.pit ./temp/best.pt greedy --batched -n 20
    python -m alphazero_tpu_torch.cli.pit --batched --tournament ./runs \\
        --ratings ./runs/ratings.json
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import logging
import os
import time

import torch

from ..eval import arena as AR
from ..eval.glicko2 import RatingBook
from ..games.splendor import adapter as A
from ..games.splendor import env as E
from ..models import splendor_net as N
from ..search import mcts as M
from ..utils import checkpoint as CKPT
from ..utils.device import resolve_device

log = logging.getLogger(__name__)

_TOOLING = ("comes with the tooling slice of the port (game_api.py, "
            "players.py, ab_pool.py); use --batched with random, greedy or "
            "checkpoint agents")


def _load_net(path, env_cfg, device):
    """``(net, meta)`` of a checkpoint; the net's version and width come
    from its meta (v1, width 128 without them)."""
    ckpt = CKPT.load_checkpoint(os.path.dirname(path) or ".",
                                os.path.basename(path))
    meta = ckpt.get("meta", {})
    net = N.build_net(A.net_config_for(
        env_cfg, nn_version=int(meta.get("nn_version", 1)),
        width=int(meta.get("net_width", 128))), device)
    net.load_state_dict(N.from_flax(ckpt["params"], ckpt["batch_stats"]))
    return net, meta


def _search_agent(net, env_cfg, mcfg, device):
    """Greedy NN + MCTS agent (temp 0, as the gate plays)."""
    search = M.build_search(mcfg, env_cfg.num_players, A.make_eval_fn(net.cfg),
                            A.make_search_step_fn(env_cfg),
                            A.make_valid_fn(env_cfg), device)
    return AR.make_search_agent(search, net)


def _batched_agent(spec: str, env_cfg, args, device):
    """A batched-arena agent ``(canon [B,R,7], generator) -> actions [B]``
    for an agent spec; a checkpoint searches with its meta's ``num_sims``
    (unless ``-m``), ``cpuct`` and ``fpu``."""
    if spec == "random":
        return AR.make_random_agent(A.make_valid_fn(env_cfg))
    if spec == "greedy":
        return AR.make_greedy_agent(env_cfg)
    if spec in ("alphabeta", "human"):
        raise NotImplementedError(f"the {spec!r} agent {_TOOLING}")
    net, meta = _load_net(spec, env_cfg, device)
    mcfg = M.MCTSConfig(
        num_sims=args.numMCTSSims or int(meta.get("num_sims", 200)),
        cpuct=float(meta.get("cpuct", 1.0)), fpu=float(meta.get("fpu", 0.0)))
    return _search_agent(net, env_cfg, mcfg, device)


def play_batched(args, device):
    """Agent A takes every seat in turn, agent B all the others, with
    ``num_games // num_players`` lockstep games per seat; prints and
    returns one JSON record."""
    n = args.numPlayers
    env_cfg = E.SplendorConfig(num_players=n)
    per_seat = max(args.num_games // n, 1)
    if per_seat * n != args.num_games:
        log.warning("-n %d is not a multiple of %d players: playing %d "
                    "games (%d per seat)", args.num_games, n, per_seat * n,
                    per_seat)
    a_main = _batched_agent(args.players[0], env_cfg, args, device)
    a_opp = _batched_agent(args.players[1], env_cfg, args, device)
    arena = AR.BatchArena(env_cfg, per_seat, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    w = l = d = 0
    t0 = time.time()
    for seat in range(n):
        agents = [a_main if p == seat else a_opp for p in range(n)]
        wins, dr = arena.play(agents, gen).tally(
            [0 if p == seat else 1 for p in range(n)])
        w += wins[0]
        l += wins[1]
        d += dr
        log.info("seat %d/%d done: cumulative %d-%d (%d draws)",
                 seat + 1, n, w, l, d)
    out = {"players": args.players, "num_players": n,
           "games": w + l + d, "wins": w, "losses": l, "draws": d,
           "winrate": (w + 0.5 * d) / max(w + l + d, 1),
           "sims": args.numMCTSSims,
           "ab_depth": args.ab_depth, "ab_deadline": args.ab_deadline,
           "seconds": round(time.time() - t0, 1)}
    print(json.dumps(out))
    return out


def _tournament_paths(args):
    paths = sorted(set(
        glob.glob(os.path.join(args.tournament, "**", "best*.pt"),
                  recursive=True)
        + glob.glob(os.path.join(args.tournament, "**", "checkpoint_*.pt"),
                    recursive=True)))
    if args.max_age_hours is not None:
        cutoff = time.time() - args.max_age_hours * 3600
        paths = [p for p in paths if os.stat(p).st_mtime >= cutoff]
    return paths


def run_tournament_batched(args, device):
    """Round robin of the checkpoints under ``args.tournament``: each pair
    plays ``num_games`` split over both seat orders, every search at
    ``numMCTSSims`` (200 by default), cpuct 1 and fpu 0; with ``--ratings``
    the Glicko-2 book is updated after each pair.  Returns the book or
    None."""
    paths = _tournament_paths(args)
    if len(paths) < 2:
        print(f"need >=2 checkpoints under {args.tournament}, "
              f"found {len(paths)}")
        return None
    print(f"tournament (batched): {len(paths)} checkpoints")
    env_cfg = E.SplendorConfig(num_players=args.numPlayers)
    mcfg = M.MCTSConfig(num_sims=args.numMCTSSims or 200)

    def agent(path):
        return _search_agent(_load_net(path, env_cfg, device)[0], env_cfg,
                             mcfg, device)

    arena = AR.BatchArena(env_cfg, max(args.num_games // 2, 1), device=device)
    book = RatingBook.load(args.ratings) if args.ratings else None
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for pa, pb in itertools.combinations(paths, 2):
        aa, ab = agent(pa), agent(pb)
        w1, d1 = arena.play([aa, ab], gen).tally([0, 1])
        w2, d2 = arena.play([ab, aa], gen).tally([1, 0])
        wins = [w1[0] + w2[0], w1[1] + w2[1]]
        draws = d1 + d2
        na = os.path.relpath(pa, args.tournament)
        nb = os.path.relpath(pb, args.tournament)
        print(f"{na} vs {nb}: {wins} draws={draws}", flush=True)
        if book is not None:
            total = wins[0] + wins[1] + draws
            book.record_match(na, nb, (wins[0] + 0.5 * draws) / max(total, 1))
            book.save()
    if book is not None:
        for name, r in sorted(book.ratings.items(),
                              key=lambda kv: -kv[1].rating):
            print(f"{r.rating:7.1f} +-{r.rd:5.1f}  {name}")
    return book


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pit agents")
    p.add_argument("players", nargs="*",
                   help="2+ agent specs: random|greedy|alphabeta|human|ckpt "
                        "(omit with --tournament)")
    p.add_argument("--num-games", "-n", type=int, default=10)
    p.add_argument("--numMCTSSims", "-m", type=int, default=0)
    p.add_argument("--numPlayers", "-np", type=int, default=2)
    p.add_argument("--ab-depth", type=int, default=6,
                   help="alphabeta search depth; only echoed into the JSON "
                        "record until alphabeta is ported")
    p.add_argument("--ab-deadline", type=float, default=10.0,
                   help="alphabeta per-move budget in seconds; only echoed "
                        "into the JSON record until alphabeta is ported")
    p.add_argument("--record-dir", default=None,
                   help="pickle each game's boards (sequential mode; not "
                        "ported yet)")
    p.add_argument("--ratings", default=None,
                   help="path to a glicko2 JSON book to update")
    p.add_argument("--token-limits", default=None,
                   help="per-seat gem limits, e.g. 8,10 (handicap mode; "
                        "not ported yet)")
    p.add_argument("--tournament", default=None, metavar="DIR",
                   help="round-robin all best*.pt / checkpoint_*.pt under "
                        "DIR instead of explicit players")
    p.add_argument("--max-age-hours", type=float, default=None,
                   help="with --tournament: only checkpoints newer than this")
    p.add_argument("--batched", action="store_true",
                   help="device-batched lockstep arena (the only mode "
                        "ported so far)")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device to run on: 'cuda' (the default; raises "
                        "without a GPU) or 'cpu'")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = build_parser()
    args = p.parse_args(argv)
    if not args.tournament and len(args.players) < 2:
        p.error("need at least 2 agent specs (or --tournament DIR)")
    if not args.batched:
        raise NotImplementedError(f"the sequential pit {_TOOLING}")
    for flag, value in (("--record-dir", args.record_dir),
                        ("--token-limits", args.token_limits)):
        if value:
            raise NotImplementedError(f"{flag} {_TOOLING}")
    device = resolve_device(args.device)
    if args.tournament:
        return run_tournament_batched(args, device)
    if len(args.players) != 2:
        p.error("--batched takes exactly 2 agent specs")
    return play_batched(args, device)


if __name__ == "__main__":
    main()
