"""Env-steps/s scaling benchmark over the process group: port of
``alphazero_tpu/cli/bench_scaling.py``.

Measures the vectorized Splendor step's throughput on one device against
all ranks, each stepping its own ``--batch-per-device`` boards, and
reports the scaling efficiency.  Every rank runs the one-device pass at
the same time, as the JAX benchmark's processes do; the all-ranks figure
is the sum of the ranks' rates (an all-reduce), printed by rank 0 with the
JAX benchmark's JSON keys.

The JAX benchmark runs its steps inside one jitted ``lax.scan``; here each
step is a Python iteration of PyTorch ops (valid moves, the first valid
action, the chance uniforms, the step), synchronized once at the end.

Usage:
    python -m alphazero_tpu_torch.cli.bench_scaling [--batch-per-device 4096]
    torchrun --nproc-per-node 2 -m alphazero_tpu_torch.cli.bench_scaling \\
        --distributed --device cpu --batch-per-device 256 --steps 20
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from ..games.splendor import env as E
from ..parallel import distributed as D
from ..utils.device import resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def throughput(env_cfg: E.SplendorConfig, batch: int, steps: int, device,
               seed: int = 0) -> float:
    """Env steps/s of ``batch`` boards stepped ``steps`` times on
    ``device`` (after one warm-up pass of the same steps)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    states = E.initial_state(env_cfg, batch, gen, dev)

    def run(s):
        for _ in range(steps):
            a = torch.argmax(E.valid_moves(env_cfg, s, 0).to(torch.int8), -1)
            u = torch.rand((batch, 2), generator=gen, device=dev)
            s, _ = E.step(env_cfg, s, a, 0, u, False)
        return s
    out = run(states)
    _sync(dev)
    t0 = time.perf_counter()
    run(out)
    _sync(dev)
    return batch * steps / (time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-per-device", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--players", type=int, default=2)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; one GPU per rank) or 'cpu'")
    args = ap.parse_args(argv)

    if args.distributed:
        D.initialize(device=args.device)
    dev = resolve_device(args.device)
    env_cfg = E.SplendorConfig(num_players=args.players)
    n = D.world_size()

    t1 = throughput(env_cfg, args.batch_per_device, args.steps, dev)
    D.sync_hosts("one device")
    tn = throughput(env_cfg, args.batch_per_device, args.steps, dev)
    if n > 1:
        total = torch.tensor([tn], dtype=torch.float64,
                             device=D.comm_device())
        dist.all_reduce(total)
        tn = float(total[0])
    out = {"metric": "env_steps_per_s", "devices": n,
           "one_device": round(t1, 1), "all_devices": round(tn, 1),
           "scaling_efficiency": round(tn / (t1 * n), 3)}
    if D.is_primary():
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
