"""Training CLI: port of ``alphazero_tpu/cli/main.py`` (the same flags and
defaults, plus ``--device``).

Example:
    python -m alphazero_tpu_torch.cli.main -m 200 -e 256 -i 5 -C ./results/run1

``--distributed`` joins the process group that torchrun's variables
describe (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), one process per device, and the coach shards self-play
and training over it:
    torchrun --nproc-per-node 2 -m alphazero_tpu_torch.cli.main \
        --distributed --device cpu -C ./results/run1
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from ..parallel import distributed as D
from ..train.coach import Coach, CoachConfig, completed_iterations
from ..utils import profiling

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="alphazero_tpu_torch trainer")
    p.add_argument("--numIters", "-n", type=int, default=50)
    p.add_argument("--numPlayers", "-np", type=int, default=2)
    p.add_argument("--numEps", "-e", type=int, default=500,
                   help="self-play games per iteration")
    p.add_argument("--selfplayBatch", type=int, default=0,
                   help="boards per batched self-play call (0 = numEps)")
    p.add_argument("--tempThreshold", "-T", type=int, default=10)
    p.add_argument("--updateThreshold", type=float, default=0.60)
    p.add_argument("--numMCTSSims", "-m", type=int, default=1600)
    p.add_argument("--ratio-fullMCTS", type=int, default=5, dest="ratio_full")
    p.add_argument("--prob-fullMCTS", type=float, default=0.25,
                   dest="prob_full")
    p.add_argument("--temperature", "-t", type=float, nargs=2,
                   default=[1.25, 0.8])
    p.add_argument("--cpuct", "-c", type=float, default=1.0)
    p.add_argument("--dirichletAlpha", "-d", type=float, default=0.2)
    p.add_argument("--fpu", "-f", type=float, default=0.0)
    p.add_argument("--numItersHistory", "-i", type=int, default=5)
    p.add_argument("--learn-rate", "-l", type=float, default=3e-4,
                   dest="learn_rate")
    p.add_argument("--epochs", "-p", type=int, default=2)
    p.add_argument("--batch-size", "-b", type=int, default=32,
                   dest="batch_size")
    p.add_argument("--nn-version", "-V", type=int, default=1,
                   dest="nn_version")
    p.add_argument("--vl-weight", "-v", type=float, default=10.0,
                   dest="vl_weight")
    p.add_argument("--vl-warmup-iters", type=int, default=0,
                   dest="vl_warmup_iters",
                   help="ramp the value-loss weight linearly over the first "
                        "N iterations (0 = off); mitigates the N>2 "
                        "value-head collapse (docs/PERF.md, runs/r10_4p)")
    p.add_argument("--gate-mode", choices=("threshold", "always"),
                   default="threshold", dest="gate_mode",
                   help="'threshold': reference accept/reject at "
                        "updateThreshold with rollback (Coach.py:152-162); "
                        "'always': latest net always becomes best (no "
                        "rollback), gate match still recorded")
    p.add_argument("--forced-playouts", "-F", action="store_true",
                   dest="forced_playouts")
    p.add_argument("--surprise-weight", "-W", action="store_true",
                   dest="surprise_weight")
    p.add_argument("--tree-reuse", action=argparse.BooleanOptionalAction,
                   dest="tree_reuse", default=False,
                   help="cross-move MCTS tree carryover in self-play "
                        "(default off; its cost on the GPU is in PERF.md)")
    p.add_argument("--stage-sims", type=str, default="auto", dest="stage_sims",
                   help="staged tree-capacity schedule for fresh searches: "
                        "'auto' (doubling from 16, +14-18%% measured), 'off', "
                        "or comma-separated sim counts summing to num_sims "
                        "(bit-exact either way; docs/PERF.md)")
    p.add_argument("--val-split", type=float, default=0.0, dest="val_split",
                   help="held-out validation fraction of the replay buffer "
                        "(reference GenericNNetWrapper.py:108-137)")
    p.add_argument("--eval-baselines", type=int, default=0,
                   dest="eval_baselines",
                   help="games vs random AND greedy per iteration for the "
                        "learning curve (0 = off); logged to metrics.jsonl")
    p.add_argument("--arenaCompare", type=int, default=0, dest="arena_compare",
                   help="gate games per iteration (0 = reference-derived "
                        "30/50, main.py:137); raise to de-noise the gate")
    p.add_argument("--gate-sims", type=int, default=0, dest="gate_sims",
                   help="MCTS sims for the gate search (0 = numMCTSSims)")
    p.add_argument("--eval-sims", type=int, default=0, dest="eval_sims",
                   help="MCTS sims for the baseline learning-curve probe "
                        "(0 = gate sims)")
    p.add_argument("--checkpoint", "-C", default="./temp/")
    p.add_argument("--load-folder-file", "-L", default=None,
                   dest="load_folder_file")
    p.add_argument("--load-fallback", action="store_true",
                   help="allow resume to fall back to sibling checkpoints "
                        "(temp/best/newest) when the requested file is "
                        "missing or unreadable — used by the crash-restart "
                        "supervisor")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", "-P", action="store_true",
                   help="run one profiled iteration with torch.profiler")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group of torchrun's variables "
                        "(one process per device) and shard over it")
    p.add_argument("--device", default="cuda",
                   help="device to run on: 'cuda' (the default; raises "
                        "without a GPU) or 'cpu'")
    return p


def args_to_config(args) -> CoachConfig:
    arena_games = args.arena_compare or (
        30 if args.numEps < 500 else 50)              # reference main.py:137
    return CoachConfig(
        num_players=args.numPlayers,
        num_iters=args.numIters,
        games_per_iter=args.numEps,
        selfplay_batch=args.selfplayBatch or min(args.numEps, 512),
        num_sims=args.numMCTSSims,
        ratio_full=args.ratio_full,
        prob_full=args.prob_full,
        temp_threshold=args.tempThreshold,
        cpuct=args.cpuct,
        fpu=args.fpu,
        forced_playouts=args.forced_playouts,
        dirichlet_alpha=args.dirichletAlpha,
        prior_temp=args.temperature[0],
        learn_rate=args.learn_rate,
        vl_weight=args.vl_weight,
        vl_warmup_iters=args.vl_warmup_iters,
        gate_mode=args.gate_mode,
        batch_size=args.batch_size,
        epochs=args.epochs,
        surprise_weight=args.surprise_weight,
        val_split=args.val_split,
        tree_reuse=args.tree_reuse,
        stage_sims=args.stage_sims,
        nn_version=args.nn_version,
        history=args.numItersHistory,
        update_threshold=args.updateThreshold,
        arena_games=arena_games,
        gate_num_sims=args.gate_sims,
        eval_num_sims=args.eval_sims,
        eval_baseline_games=args.eval_baselines,
        checkpoint_dir=args.checkpoint,
        seed=args.seed,
    )


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    joined = args.distributed and not D.initialized()
    if args.distributed:
        # one process per device, from torchrun's variables (NCCL on
        # cuda, gloo on cpu); the coach shards over the group
        D.initialize(device=args.device)
    try:
        _run(args)
    finally:
        if joined:
            D.shutdown()


def _run(args):
    coach = Coach(args_to_config(args), device=args.device)
    start_iter = 1
    if args.load_folder_file:
        coach.load_checkpoint(os.path.dirname(args.load_folder_file),
                              os.path.basename(args.load_folder_file),
                              fallback=args.load_fallback)
        # resume continuity: -n is the TOTAL iteration budget; continue the
        # monotone numbering recorded in this run's metrics.jsonl
        start_iter = completed_iterations(coach.cfg.checkpoint_dir) + 1
        if start_iter > 1:
            log.info("resuming at iteration %d of %d", start_iter,
                     coach.cfg.num_iters)
    if args.profile:
        coach.cfg = CoachConfig(**{**vars(coach.cfg), "num_iters": 1,
                                   "games_per_iter": coach.cfg.selfplay_batch})
        with profiling.trace("./torch-trace") as prof:
            coach.learn()
        print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                        row_limit=25))
        print(json.dumps(profiling.counters()))
    else:
        coach.learn(start_iter=start_iter)


if __name__ == "__main__":
    main()
