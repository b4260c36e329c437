"""Pit CLI: play any two agents against each other (reference pit.py).

Port of ``alphazero_tpu/cli/pit.py`` (the same flags, plus ``--device``).
Agent specs: ``random``, ``greedy``, ``alphabeta``, ``human``, or a
checkpoint path (NN + MCTS, its search settings and net shape read from
the checkpoint's meta, like the reference's additional_keys, pit.py:50-61).

- The sequential mode (the default) plays one board at a time through the
  host ``SplendorGame``, with the reference's 1 2 2 1 seat pattern,
  ``--token-limits`` per seat and ``--record-dir`` game records; with
  ``--tournament DIR`` it plays a round robin of the checkpoints under DIR.
- ``--batched`` plays lockstep games on the device: two specs pairwise
  (``alphabeta`` moves in a pool of CPU workers), or a round robin with
  ``--tournament``; ``--ratings`` keeps a Glicko-2 book in either mode.

Example:
    python -m alphazero_tpu_torch.cli.pit random greedy -n 20
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
import pickle
import time

import numpy as np
import torch

from ..eval import arena as AR
from ..eval import players as P
from ..eval.glicko2 import RatingBook
from ..games.game_api import SplendorGame
from ..games.splendor import adapter as A
from ..games.splendor import env as E
from ..search import mcts as M
from ..utils import checkpoint as CKPT
from ..utils.device import resolve_device
from ..utils.profiling import count, span

log = logging.getLogger(__name__)


def _mcts_config(args, meta):
    """A checkpoint's search: its meta's ``num_sims`` (unless ``-m``),
    ``cpuct`` and ``fpu``."""
    return M.MCTSConfig(
        num_sims=args.numMCTSSims or int(meta.get("num_sims", 200)),
        cpuct=float(meta.get("cpuct", 1.0)), fpu=float(meta.get("fpu", 0.0)))


def _build_search(mcfg, env_cfg, net, device):
    return M.build_search(mcfg, env_cfg.num_players, A.make_eval_fn(net.cfg),
                          A.make_search_step_fn(env_cfg),
                          A.make_valid_fn(env_cfg), device)


class MCTSPlayer:
    """Single-board player over the batched search (B=1), on the game's
    device.  It searches under the rules of the game it is bound to
    (``self.game``), which ``play_games`` sets to the seat's own game."""

    def __init__(self, game, net, num_sims, cpuct=1.0, fpu=0.0,
                 temp: float = 0.0):
        self.game = game
        self.net = net
        self.temp = temp
        self.mcfg = M.MCTSConfig(num_sims=num_sims, cpuct=cpuct, fpu=fpu)
        self._searches = {}                # env config -> its search
        self._gen = torch.Generator(device=game.device).manual_seed(0)

    @property
    def search(self):
        cfg = self.game.cfg
        if cfg not in self._searches:
            self._searches[cfg] = _build_search(self.mcfg, cfg, self.net,
                                                self.game.device)
        return self._searches[cfg]

    def play(self, board) -> int:
        """The action for ``board``: the search's most visited edge, or one
        drawn from its counts at ``temp``.  While a profiler records, the
        host time outside the search falls into the spans
        ``player.upload`` and ``player.answer``, and ``player.requests``
        counts the calls."""
        with span("player.upload"):
            search = self.search
            roots = torch.as_tensor(np.asarray(board),
                                    device=self.game.device)[None]
        res = search(self.net, roots, generator=self._gen)
        with span("player.answer"):
            count("player.requests")
            counts = res.counts[0].cpu().numpy()
            if self.temp <= 1e-6:
                return int(counts.argmax())
            p = counts ** (1.0 / self.temp)
            p = p / p.sum()
            return int(np.random.default_rng().choice(len(p), p=p))


def create_player(spec: str, game, args):
    """Reference create_player (pit.py:32-93)."""
    if spec == "random":
        return P.RandomPlayer(game, seed=args.seed)
    if spec == "greedy":
        return P.GreedyPlayer(game, seed=args.seed)
    if spec == "human":
        return P.HumanPlayer(game)
    if spec == "alphabeta":
        return P.AlphaBetaPlayer(game, depth=args.ab_depth,
                                 deadline_s=args.ab_deadline)
    # checkpoint path -> NN + MCTS
    net, meta = CKPT.load_net(spec, game.cfg, game.device)
    mcfg = _mcts_config(args, meta)
    return MCTSPlayer(game, net, mcfg.num_sims, mcfg.cpuct, mcfg.fpu)


def play_games(game, players, num_games, record_dir=None, verbose=False,
               token_limits=None):
    """Sequential host arena over the Game adapter; seats follow the
    reference's 1 2 2 1 alternation (Arena.py:195-202).  ``token_limits``
    optionally handicaps each seat's gem-holding limit (reference
    Arena.py:102-116): the agent at a seat chooses on that seat's game
    (its ``game`` is rebound for the move and restored at the end), so a
    handicapped seat only picks moves its own limit allows.  The JAX pit
    lets every agent choose on the shared game, where an 8-token seat can
    pick a move its own game rejects.  Returns (wins_per_agent, draws,
    score_sums)."""
    n = game.getNumberOfPlayers()
    seat_games = [game] * n
    if token_limits:
        seat_games = [game if lim == game.cfg.token_limit
                      else SplendorGame(n, token_limit=lim,
                                        device=game.device)
                      for lim in token_limits]
    homes = [p.game for p in players]
    try:
        return _play_games(game, players, num_games, seat_games, record_dir,
                           verbose)
    finally:
        for p, home in zip(players, homes):
            p.game = home


def _play_games(game, players, num_games, seat_games, record_dir, verbose):
    n = game.getNumberOfPlayers()
    wins = [0] * len(players)
    draws = 0
    scores_sum = np.zeros(len(players))
    pattern = [0, 1, 1, 0]
    for gi in range(num_games):
        flip = pattern[gi % 4] if len(players) == 2 else gi % len(players)
        # agent controlling seat s this game
        agent_of_seat = [(s - flip) % len(players) for s in range(n)]
        board = game.getInitBoard()
        player = 0
        records = []
        for move_i in range(game.cfg.max_moves + 1):
            g = seat_games[player]
            canon = g.getCanonicalForm(board, player)
            agent = players[agent_of_seat[player]]
            agent.game = g
            a = agent.play(canon)
            valids = g.getValidMoves(canon, 0)
            assert valids[a], f"illegal move {a} from agent at seat {player}"
            if verbose:
                print(f"move {move_i} P{player}: {game.moveToString(a)}")
            if record_dir:
                records.append(board.copy())
            board, player = g.getNextState(board, player, a)
            r = game.getGameEnded(board)
            if r.any():
                top = np.flatnonzero(r > 0)
                if len(top) == 1:
                    wins[agent_of_seat[top[0]]] += 1
                else:
                    draws += 1
                for seat in range(n):
                    scores_sum[agent_of_seat[seat]] += game.getScore(board, seat)
                break
        if record_dir:
            os.makedirs(record_dir, exist_ok=True)
            with open(os.path.join(record_dir, f"game_{gi}.pkl"), "wb") as f:
                pickle.dump(records + [board], f)
        log.info("game %d done: wins=%s draws=%d", gi, wins, draws)
    return wins, draws, scores_sum


def _search_agent(net, env_cfg, mcfg, device):
    """Greedy NN + MCTS agent (temp 0, as the gate plays)."""
    return AR.make_search_agent(_build_search(mcfg, env_cfg, net, device),
                                net)


def _batched_agent(spec: str, env_cfg, args, device, closers: list):
    """A batched-arena agent ``(canon [B,R,7], generator) -> actions [B]``
    for an agent spec; ``alphabeta`` starts a worker pool whose ``close``
    goes into ``closers``.  Any other spec is a checkpoint path, ``human``
    included, as in the JAX pit."""
    if spec == "random":
        return AR.make_random_agent(A.make_valid_fn(env_cfg))
    if spec == "greedy":
        return AR.make_greedy_agent(env_cfg)
    if spec == "alphabeta":
        from ..eval.ab_pool import AlphaBetaPool
        pool = AlphaBetaPool(env_cfg.num_players, depth=args.ab_depth,
                             deadline_s=args.ab_deadline,
                             value_ckpt=args.ab_value_ckpt)
        closers.append(pool.close)
        return pool.agent
    net, meta = CKPT.load_net(spec, env_cfg, device)
    return _search_agent(net, env_cfg, _mcts_config(args, meta), device)


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
    if "alphabeta" in args.players and not args.ab_value_ckpt:
        # reference parity: alphabeta's leaf eval defaults to the NN
        # opponent's own value head (pit.py:71-72)
        others = [s for s in args.players if os.path.exists(s)]
        if others:
            args.ab_value_ckpt = others[0]
            log.info("alphabeta leaf values from %s", others[0])
    closers: list = []
    w = l = d = 0
    t0 = time.time()
    try:
        a_main = _batched_agent(args.players[0], env_cfg, args, device,
                                closers)
        a_opp = _batched_agent(args.players[1], env_cfg, args, device,
                               closers)
        arena = AR.BatchArena(env_cfg, per_seat, device=device)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        for seat in range(n):
            agents = [a_main if p == seat else a_opp for p in range(n)]
            wins, dr = arena.play(agents, gen).tally(
                [0 if p == seat else 1 for p in range(n)])
            w += wins[0]
            l += wins[1]
            d += dr
            log.info("seat %d/%d done: cumulative %d-%d (%d draws)",
                     seat + 1, n, w, l, d)
    finally:
        for c in closers:
            c()
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
        return _search_agent(CKPT.load_net(path, env_cfg, device)[0],
                             env_cfg, mcfg, device)

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


def run_tournament(game, args):
    """Round-robin of recent checkpoints with Glicko-2 bookkeeping
    (reference pit.py:115-201 play_age/update_ratings), one board at a
    time; the book names each checkpoint by its path.  Returns the book or
    None."""
    paths = _tournament_paths(args)
    if len(paths) < 2:
        print(f"need >=2 checkpoints under {args.tournament}, found {len(paths)}")
        return None
    print(f"tournament: {len(paths)} checkpoints")
    book = RatingBook.load(args.ratings) if args.ratings else None
    for pa, pb in itertools.combinations(paths, 2):
        players = [create_player(pa, game, args), create_player(pb, game, args)]
        wins, draws, _ = play_games(game, players, args.num_games)
        print(f"{os.path.relpath(pa, args.tournament)} vs "
              f"{os.path.relpath(pb, args.tournament)}: {wins} draws={draws}")
        if book is not None:
            total = wins[0] + wins[1] + draws
            book.record_match(pa, pb, (wins[0] + 0.5 * draws) / max(total, 1))
            book.save()
    if book is not None:
        for name, r in sorted(book.ratings.items(), key=lambda kv: -kv[1].rating):
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
                   help="alphabeta search depth (reference DEFAULT_DEPTH=6, "
                        "SplendorPlayers.py:16)")
    p.add_argument("--ab-deadline", type=float, default=10.0,
                   help="alphabeta per-move wall-clock budget in seconds "
                        "(reference MAX_SEARCH_TIME=10, "
                        "SplendorPlayers.py:15)")
    p.add_argument("--ab-value-ckpt", default=None,
                   help="checkpoint whose value head evaluates alphabeta "
                        "leaves (reference valueFuncNN; --batched defaults "
                        "to the NN opponent's checkpoint, else heuristic)")
    p.add_argument("--record-dir", default=None,
                   help="pickle each game's boards (sequential mode)")
    p.add_argument("--ratings", default=None,
                   help="path to a glicko2 JSON book to update")
    p.add_argument("--token-limits", default=None,
                   help="per-seat gem limits, e.g. 8,10 (handicap mode of "
                        "the sequential pit; reference Arena.py:102-116)")
    p.add_argument("--tournament", default=None, metavar="DIR",
                   help="round-robin all best*.pt / checkpoint_*.pt under "
                        "DIR instead of explicit players")
    p.add_argument("--max-age-hours", type=float, default=None,
                   help="with --tournament: only checkpoints newer than this")
    p.add_argument("--batched", action="store_true",
                   help="device-batched lockstep arena instead of the "
                        "sequential host loop (2 agent specs; alphabeta "
                        "moves run in a parallel CPU worker pool)")
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
    if args.batched:
        for flag, value in (("--record-dir", args.record_dir),
                            ("--token-limits", args.token_limits)):
            if value:
                p.error(f"{flag} is a flag of the sequential pit; drop "
                        f"--batched to use it")
        device = resolve_device(args.device)
        if args.tournament:
            return run_tournament_batched(args, device)
        if len(args.players) != 2:
            p.error("--batched takes exactly 2 agent specs")
        return play_batched(args, device)

    game = SplendorGame(args.numPlayers, seed=args.seed, device=args.device)
    if args.tournament:
        return run_tournament(game, args)

    limits = ([int(x) for x in args.token_limits.split(",")]
              if args.token_limits else None)
    players = [create_player(s, game, args) for s in args.players]
    wins, draws, scores = play_games(game, players, args.num_games,
                                     record_dir=args.record_dir,
                                     verbose=args.verbose,
                                     token_limits=limits)
    print(f"result: wins={wins} draws={draws} avg_scores="
          f"{(scores / max(args.num_games, 1)).round(2).tolist()}")

    if args.ratings and len(players) == 2:
        book = RatingBook.load(args.ratings)
        total = wins[0] + wins[1] + draws
        score_a = (wins[0] + 0.5 * draws) / max(total, 1)
        book.record_match(args.players[0], args.players[1], score_a)
        book.save()
        print({k: round(v.rating, 1) for k, v in book.ratings.items()})
    return wins, draws, scores


if __name__ == "__main__":
    main()
