"""Standalone supervised training on saved self-play examples.

Port of ``alphazero_tpu/cli/train_offline.py`` (the same flags, plus
``--device``) on the port's ``trainer.fit``: the counterpart of the
reference's `GenericNNetWrapper.__main__` (GenericNNetWrapper.py:352-419):
load a replay-examples file (and optionally a held-out test file),
warm-start from a checkpoint, train for N epochs with per-epoch validation
metrics, and save the result in the JAX package's checkpoint format.

Usage:
    python -m alphazero_tpu_torch.cli.train_offline \\
        -T runs/r1/checkpoint.examples -i runs/r1/best.pt -o runs/offline \\
        -p 4 -b 256
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..games.splendor import adapter as A
from ..games.splendor import env as E
from ..models import splendor_net as N
from ..train import trainer as TR
from ..train.replay import ReplayBuffer
from ..utils import checkpoint as CKPT
from ..utils.device import resolve_device

log = logging.getLogger(__name__)


def build_parser():
    p = argparse.ArgumentParser(description="offline supervised trainer")
    p.add_argument("--input", "-i", default=None, help="checkpoint to warm-start")
    p.add_argument("--output", "-o", default="./offline",
                   help="output checkpoint dir")
    p.add_argument("--training", "-T", required=True,
                   help=".examples file to train on")
    p.add_argument("--test", "-t", default=None,
                   help="optional held-out .examples file (validation); "
                        "without it a 5%% split of the training file is used")
    p.add_argument("--numPlayers", "-np", type=int, default=2)
    p.add_argument("--learn-rate", "-l", type=float, default=3e-4)
    p.add_argument("--dropout", "-d", type=float, default=0.3)
    p.add_argument("--epochs", "-p", type=int, default=2)
    p.add_argument("--batch-size", "-b", type=int, default=32)
    p.add_argument("--nn-version", "-V", type=int, default=1)
    p.add_argument("--vl-weight", "-v", type=float, default=10.0)
    p.add_argument("--surprise-weight", "-W", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device to run on: 'cuda' (the default; raises "
                        "without a GPU) or 'cpu'")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    env_cfg = E.SplendorConfig(num_players=args.numPlayers)
    net_cfg = A.net_config_for(env_cfg, dropout=args.dropout,
                               nn_version=args.nn_version)
    train_cfg = TR.TrainConfig(
        learn_rate=args.learn_rate, vl_weight=args.vl_weight,
        batch_size=args.batch_size, epochs=args.epochs,
        val_split=0.0 if args.test else 0.05)

    state = TR.init_train_state(
        net_cfg, torch.Generator().manual_seed(args.seed), device)
    if args.input:
        target, target_bs = N.to_flax(state.net.state_dict())
        ckpt = CKPT.load_network(os.path.dirname(args.input) or ".",
                                 os.path.basename(args.input), target,
                                 target_batch_stats=target_bs)
        state.net.load_state_dict(N.from_flax(ckpt["params"],
                                              ckpt["batch_stats"]))
        log.info("warm-started from %s (%s)", args.input, ckpt["load_mode"])
    log.info("number of params: %.2e", N.count_params(state.net))

    replay = ReplayBuffer.load(args.training, history=10 ** 9)
    log.info("training examples: %d", len(replay))
    step = TR.make_train_step(env_cfg, net_cfg, train_cfg)
    eval_step = TR.make_eval_step(env_cfg, net_cfg, train_cfg)

    test_batch = None
    if args.test:
        test = ReplayBuffer.load(args.test, history=10 ** 9)
        ids = np.arange(min(len(test), TR.TrainConfig().max_val_examples))
        test_batch = test.gather(ids)
        log.info("test examples: %d", len(ids))

    def on_epoch(epoch, st, metrics):
        if test_batch is not None:
            tm = eval_step(st, test_batch)
            metrics.update({f"test_{k}": float(v) for k, v in tm.items()})
        log.info("epoch %d: %s", epoch + 1,
                 {k: round(v, 4) for k, v in metrics.items()})

    state, metrics = TR.fit(
        state, step, replay, train_cfg, np.random.default_rng(args.seed),
        torch.Generator(device).manual_seed(args.seed + 1),
        surprise_weight=args.surprise_weight,
        eval_step_fn=eval_step, on_epoch_end=on_epoch)

    params, batch_stats = N.to_flax(state.net.state_dict())
    path = CKPT.save_checkpoint(args.output, "last.pt", params=params,
                                batch_stats=batch_stats,
                                meta={**vars(args), **metrics})
    log.info("saved %s", path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
