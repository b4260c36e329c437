"""Alpha-beta node rate of one pit worker, in the PyTorch port and in the
JAX package, on this host's CPU.

    python scripts/ab_node_rate.py [--depth 2] [--boards 4]

Each package runs in a process of its own, on the CPU with one thread,
as a worker of the pit's alpha-beta pool does (``eval/ab_pool.py``):
``AlphaBetaPlayer`` at ``--depth`` with no deadline and the heuristic
value, on the same boards (from numpy uniforms and numpy-drawn moves of
byte-equal envs), after one warm-up move.  It prints, per package, the
seconds, the nodes searched (calls of ``_alphabeta``) and the candidate
steps (``getNextState`` calls) per second, and the CPU's model name; then
the port's rate over JAX's.  The moves must agree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_name() -> str:
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return "unknown"


def boards(api, env, num_players, n, seed=0):
    """``n`` canonical boards: an initial board from numpy uniforms, then
    6-14 numpy-drawn legal moves."""
    import numpy as np
    game = api.SplendorGame(num_players, seed=seed, **_kw(api))
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        u = rng.random(24, dtype=np.float32)
        nob = rng.permutation(10)[:game.cfg.num_nobles]
        board, player = env(game.cfg, u, nob), 0
        for _ in range(6 + 2 * (i % 5)):
            valid = np.flatnonzero(game.getValidMoves(board, player))
            board, player = game.getNextState(board, player,
                                              int(rng.choice(valid)))
        out.append(game.getCanonicalForm(board, player))
    return out


def _kw(api):
    return {"device": "cpu"} if api.__name__.startswith("alphazero_tpu_torch") \
        else {}


def run(package: str, depth: int, n: int) -> dict:
    import numpy as np
    if package == "port":
        import torch
        torch.set_num_threads(1)
        from alphazero_tpu_torch.eval import players as P
        from alphazero_tpu_torch.games import game_api as API
        from alphazero_tpu_torch.games.splendor import env as E

        def env(cfg, u, nob):
            return E.init_with_uniforms(cfg, torch.from_numpy(u)[None],
                                        torch.from_numpy(nob)[None])[0].numpy()
    else:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        from alphazero_tpu.eval import players as P
        from alphazero_tpu.games import game_api as API
        from alphazero_tpu.games.splendor import env as E

        def env(cfg, u, nob):
            return np.asarray(E.init_with_uniforms(cfg, jnp.asarray(u),
                                                   jnp.asarray(nob)))
    game = API.SplendorGame(2, **_kw(API))
    todo = boards(API, env, 2, n + 1)
    player = P.AlphaBetaPlayer(game, depth=depth, deadline_s=1e9)
    counts = {"nodes": 0, "steps": 0}
    inner_ab, inner_step = player._alphabeta, game.getNextState

    def alphabeta(*a):
        counts["nodes"] += 1
        return inner_ab(*a)

    def step(*a, **kw):
        counts["steps"] += 1
        return inner_step(*a, **kw)
    player._alphabeta, game.getNextState = alphabeta, step
    player.play(todo[0])                          # warm-up (compiles)
    counts.update(nodes=0, steps=0)
    t0 = time.perf_counter()
    moves = [int(player.play(b)) for b in todo[1:]]
    dt = time.perf_counter() - t0
    return {"package": package, "depth": depth, "boards": n, "moves": moves,
            "seconds": dt, "nodes": counts["nodes"], "steps": counts["steps"],
            "nodes_per_s": counts["nodes"] / dt,
            "steps_per_s": counts["steps"] / dt, "cpu": cpu_name()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--boards", type=int, default=4)
    ap.add_argument("--package", choices=("port", "jax"), default=None,
                    help="run one package in this process")
    args = ap.parse_args(argv)
    if args.package:
        print(json.dumps(run(args.package, args.depth, args.boards)))
        return 0
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    rec = {}
    for package in ("port", "jax"):
        out = subprocess.run(
            [sys.executable, __file__, "--package", package, "--depth",
             str(args.depth), "--boards", str(args.boards)],
            env=env, capture_output=True, text=True, check=True)
        rec[package] = json.loads(out.stdout.strip().splitlines()[-1])
        r = rec[package]
        print(f"{package}: {r['seconds']:.2f} s, {r['nodes']} nodes "
              f"({r['nodes_per_s']:.1f}/s), {r['steps']} steps "
              f"({r['steps_per_s']:.1f}/s) at depth {args.depth} on "
              f"{args.boards} boards; CPU {r['cpu']}")
    if rec["port"]["moves"] != rec["jax"]["moves"]:
        raise SystemExit(f"moves differ: {rec['port']['moves']} vs "
                         f"{rec['jax']['moves']}")
    print(f"port / jax nodes per second: "
          f"{rec['port']['nodes_per_s'] / rec['jax']['nodes_per_s']:.3f}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
