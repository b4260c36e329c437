"""Multi-process dry run of the data-parallel paths: the port's counterpart
of ``__graft_entry__.py::dryrun_multichip``.

On every rank of a process group: a sharded train step against the
single-process step on the same global batch (recomputed on each rank),
a sharded env step against the unsharded step (exact), and a few moves of
sharded self-play with tree reuse and playout-cap randomization, whose
gathered examples must number the sum of the ranks' own.  ``spawn`` runs a
function in W local processes wired by a file rendezvous, with a time
limit on the whole group; the CPU tests use it too.

    python -m alphazero_tpu_torch.parallel.dryrun --spawn 2 --device cpu
    torchrun --nproc-per-node 2 -m alphazero_tpu_torch.parallel.dryrun \\
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from ..games.splendor import adapter as A
from ..games.splendor import env as E
from ..train import selfplay as SP
from ..train import trainer as TR
from . import distributed as D
from . import mesh as MP


def _entry(rank, world, init_file, device, fn, args):
    torch.set_num_threads(1)
    D.initialize(f"file://{init_file}", world, rank, device=device,
                 local_rank=rank)
    try:
        fn(*args)
    finally:
        D.shutdown()


def spawn(fn, world: int, args=(), device="cpu", timeout_s: float = 120.0):
    """``fn(*args)`` in ``world`` new processes (spawned), each joined to
    one process group (gloo on ``cpu``, NCCL on ``cuda``, rank r on
    ``cuda:r``) through a file rendezvous.  Raises if a process fails or
    the group outlives ``timeout_s``; no process outlives the call."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_entry,
                             args=(r, world, init, device, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout_s)
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} still ran after {timeout_s} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with {codes}")


def sample_batch(env_cfg, B, seed):
    """A training batch of B real positions (seeded random legal play)."""
    rng = np.random.default_rng(seed)
    s = E.init_with_uniforms(
        env_cfg, torch.from_numpy(rng.random((B, 24), dtype=np.float32)),
        torch.from_numpy(np.stack([rng.permutation(10)[:env_cfg.num_nobles]
                                   for _ in range(B)])))
    for _ in range(int(rng.integers(4, 12))):
        v = E.valid_moves(env_cfg, s, 0).numpy()
        acts = np.array([rng.choice(np.flatnonzero(r)) for r in v])
        s, nxt = E.step(env_cfg, s, torch.from_numpy(acts), 0,
                        torch.from_numpy(rng.random((B, 2), np.float32)),
                        False)
        s = E.swap_players(env_cfg, s, nxt)
    valids = E.valid_moves(env_cfg, s, 0).numpy()
    pi = rng.random(valids.shape) * valids
    n = env_cfg.num_players
    return {"boards": s.numpy(),
            "pi": (pi / pi.sum(1, keepdims=True)).astype(np.float16),
            "winner": np.where(rng.random((B, n)) < 0.5, -1.0,
                               1.0).astype(np.float16),
            "scdiff": rng.integers(-15, 15, (B, n)).astype(np.int8),
            "valids": valids}


def dryrun(device="cuda", batch: int = 16, seed: int = 0) -> dict:
    """The three checks on this rank of the initialized process group
    (a width-48 net, self-play for 4 moves); raises on a disagreement.
    Returns this rank's numbers."""
    width, moves = 48, 4
    dev = torch.device(device)
    env_cfg = E.SplendorConfig()
    mesh = MP.make_mesh()
    world = D.world_size()
    out = {"rank": D.rank(), "world": world}

    # train step: dropout and augmentation on, against one process
    net_cfg = A.net_config_for(env_cfg, width=width)
    tcfg = TR.TrainConfig(batch_size=batch)
    b = sample_batch(env_cfg, batch, seed)
    states = []
    for m in (mesh, None):
        st = TR.init_train_state(net_cfg, torch.Generator().manual_seed(seed),
                                 dev)
        step = TR.make_train_step(env_cfg, net_cfg, tcfg, m)
        st, met = step(st, b, 1e-3, 10.0,
                       torch.Generator(device=dev).manual_seed(seed + 1))
        states.append((st, {k: float(v) for k, v in met.items()}))
    (sh, sh_m), (one, one_m) = states
    loss_err = abs(sh_m["loss"] - one_m["loss"]) / abs(one_m["loss"])
    with torch.no_grad():
        param_err = max(float(((a - c).abs() / (2e-6 + 2e-4 * c.abs())).max())
                        for a, c in zip(sh.net.parameters(),
                                        one.net.parameters()))
    flat = torch.cat([p.detach().reshape(-1) for p in sh.net.parameters()])
    same = D.gather_objects(flat.cpu())
    if loss_err > 2e-5 or param_err > 1.0:
        raise AssertionError(f"sharded train step: loss rel err {loss_err}, "
                             f"param err {param_err} (1 = the tolerance)")
    if not all(torch.equal(same[0], f) for f in same):
        raise AssertionError("params differ across ranks")
    out.update(train_loss=sh_m["loss"], train_loss_rel_err=loss_err)

    # env step: this rank's rows, gathered, against the whole batch
    s = torch.from_numpy(b["boards"]).to(dev)
    a = torch.argmax(torch.from_numpy(b["valids"]).to(dev).to(torch.int8), 1)
    u = torch.rand((batch, 2), generator=torch.Generator().manual_seed(seed)
                   ).to(dev)
    local = MP.shard_batch(mesh, {"s": s, "a": a, "u": u})
    s2, nxt = MP.make_sharded_selfplay_step(env_cfg, mesh)(
        local["s"], local["a"], local["u"])
    got = D.host_local_to_global(mesh, {"s": s2.cpu().numpy(),
                                        "n": nxt.cpu().numpy()})
    want_s, want_n = E.step(env_cfg, s, a, 0, u, False)
    if not (np.array_equal(got["s"], want_s.cpu().numpy())
            and np.array_equal(got["n"], want_n.cpu().numpy())):
        raise AssertionError("sharded env step differs from the unsharded")

    # self-play with tree reuse and PCR, a few moves
    sp = SP.SelfPlayConfig(batch_size=2 * world, num_sims=8, ratio_full=4,
                           prob_full=0.5, max_moves=moves, chunk_moves=moves,
                           forced_playouts=True, tree_reuse=True)
    eng = SP.SelfPlayEngine(env_cfg, A.make_eval_fn(net_cfg), sp,
                            device=dev, mesh=mesh)
    local = eng.run_local_games(sh.net.eval(),
                                D.rank_generator(seed, D.rank(), dev))
    it, stats = SP.gather_games(mesh, *local)
    counts = D.gather_objects(local[1]["examples"])
    if stats["examples"] != sum(counts) or len(it or ()) != sum(counts):
        raise AssertionError(f"self-play gathered {stats['examples']} "
                             f"examples, the ranks made {counts}")
    out.update(selfplay_examples=stats["examples"], rank_examples=counts,
               selfplay_rollouts=stats["rollouts"])
    return out


def _run_and_write(device, out_dir, kw):
    rec = dryrun(device, **kw)
    with open(os.path.join(out_dir, f"dryrun_{rec['rank']}.json"), "w") as f:
        json.dump(rec, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spawn", type=int, default=0,
                    help="run in N local processes (else under torchrun's "
                         "variables)")
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args(argv)
    kw = {"batch": args.batch}
    if args.spawn:
        with tempfile.TemporaryDirectory() as tmp:
            spawn(_run_and_write, args.spawn, (args.device, tmp, kw),
                  device=args.device, timeout_s=600)
            recs = [json.load(open(os.path.join(tmp, f"dryrun_{r}.json")))
                    for r in range(args.spawn)]
    else:
        D.initialize(device=args.device)
        try:
            recs = [dryrun(args.device, **kw)]
        finally:
            D.shutdown()
    for rec in recs:
        print(json.dumps(rec))
    print(f"dryrun ok: {recs[0]['world']} ranks")


if __name__ == "__main__":
    main()
