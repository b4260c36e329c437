"""End-to-end self-play throughput on one GPU: port of the repository's
root ``bench_selfplay.py``.

Complements ``cli/bench.py`` (search only): this drives the whole actor
(``SelfPlayEngine.run_games``: batched MCTS, optionally on carried trees,
action sampling, env steps with real chance draws, finalization and host
example collection) over whole games and reports games/s, moves/s,
examples/s and rollouts/s, and a model-FLOP/s estimate: one leaf
evaluation per rollout at 2 FLOPs per parameter (a lower bound; the env
step, the tree ops and the reroot are left out).

Reference anchor: ~3,000 rollouts/s on 1 CPU core (reference README.md:14);
``vs_baseline`` is the measured rollouts/s over that figure.  Prints ONE
JSON line.

Knobs (environment, as the JAX bench): ``BENCH_BATCH`` (256),
``BENCH_SIMS`` (128), ``BENCH_REPS`` (2), ``BENCH_REUSE=1`` (tree reuse),
``BENCH_PLAYERS`` (2), ``BENCH_DTYPE`` (the net's trunk, ``float32``),
``BENCH_STATS_DTYPE`` (``auto``).  One warm-up run (seed 1), then
``BENCH_REPS`` timed runs (seeds 2, 3, ...).

    python -m alphazero_tpu_torch.cli.bench_selfplay          # on the GPU
    BENCH_BATCH=4 BENCH_SIMS=8 BENCH_REPS=1 \\
        python -m alphazero_tpu_torch.cli.bench_selfplay --device cpu
"""

from __future__ import annotations

import argparse
import json
import os

from ..games.splendor import adapter as A
from ..games.splendor import env as E
from ..models import splendor_net as N
from .bench import BASELINE_ROLLOUTS_PER_S, play, selfplay_config


def row(device, batch: int = 256, sims: int = 128, reps: int = 2,
        reuse: bool = False, players: int = 2, dtype: str = "float32",
        stats_dtype: str = "auto",
        sp_cfg_overrides: dict | None = None) -> dict:
    """The benchmark's JSON record: ``reps`` timed ``run_games`` after one
    warm-up, the actor of ``cli/bench.py``'s self-play row (with
    ``sp_cfg_overrides``' cut, if any) and a net from Flax's initializers
    at seed 0."""
    env_cfg = E.SplendorConfig(num_players=players)
    net_cfg = A.net_config_for(env_cfg, dtype=dtype)
    net = N.build_net(net_cfg, device)
    cfg = selfplay_config(batch, sims, reuse, stats_dtype,
                          **(sp_cfg_overrides or {}))
    totals, dt = play(device, env_cfg, net_cfg, net, cfg, 1,
                      [2 + i for i in range(reps)])
    rps = totals["rollouts"] / dt
    return {
        "metric": "selfplay_rollouts_per_s_per_chip",
        "value": round(rps, 1),
        "unit": "rollouts/s",
        "vs_baseline": round(rps / BASELINE_ROLLOUTS_PER_S, 2),
        "games_per_s": round(totals["games"] / dt, 2),
        "moves_per_s": round(totals["moves"] / dt, 1),
        "examples_per_s": round(totals["examples"] / dt, 1),
        "batch": cfg.batch_size,
        "num_sims": cfg.num_sims,
        "num_players": players,
        "tree_reuse": reuse,
        "model_flops_per_s": round(2.0 * N.count_params(net) * rps),
    }


def main(argv=None) -> dict:
    """Prints the one JSON line and returns it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    out = row(args.device,
              batch=int(os.environ.get("BENCH_BATCH", "256")),
              sims=int(os.environ.get("BENCH_SIMS", "128")),
              reps=int(os.environ.get("BENCH_REPS", "2")),
              reuse=os.environ.get("BENCH_REUSE", "0") == "1",
              players=int(os.environ.get("BENCH_PLAYERS", "2")),
              dtype=os.environ.get("BENCH_DTYPE", "float32"),
              stats_dtype=os.environ.get("BENCH_STATS_DTYPE", "auto"))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
