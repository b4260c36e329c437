"""Rank bodies for the port's 2-process tests (``test_torch_port_parallel``
and ``test_torch_port_multiprocess``), run by
``alphazero_tpu_torch.parallel.dryrun.spawn`` inside a gloo process group.

They import the port only (never JAX), read their inputs from a pickle
that the test wrote, and write each rank's results to ``<out>/rank<r>.pkl``
for the test to compare against the JAX package and the port's
single-process path."""

import os
import pickle

import numpy as np
import torch


def _dump(out_dir, obj):
    from alphazero_tpu_torch.parallel import distributed as D
    with open(os.path.join(out_dir, f"rank{D.rank()}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def _step_once(mesh, axis, case, chunk=None):
    """One sharded train step of ``case`` (with ``chunk``, its K stacked
    minibatches at its K rates through ``make_train_chunk``): the new
    params and statistics (Flax layout), the metrics and the flat
    parameters."""
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.models import splendor_net as N
    from alphazero_tpu_torch.parallel import mesh as MP
    from alphazero_tpu_torch.train import trainer as TR
    net_cfg = N.NetConfig(**case["net_cfg"])
    state = TR.init_train_state(net_cfg, device="cpu")
    state.net.load_state_dict(N.from_flax(case["params"], case["bs"]))
    tcfg = TR.TrainConfig(**case["tcfg"])
    gen = torch.Generator().manual_seed(case["seed"])
    if chunk is None:
        step = MP.make_sharded_train_step(E.SplendorConfig(), net_cfg, tcfg,
                                          mesh, axis)
        state, metrics = step(state, case["batch"], case["lr"], 10.0, gen)
    else:
        run = TR.make_train_chunk(E.SplendorConfig(), net_cfg, tcfg, mesh,
                                  axis)
        state, metrics = run(state, chunk["batches"], chunk["lrs"], 10.0, gen)
    params, bs = N.to_flax(state.net.state_dict())
    flat = torch.cat([p.detach().reshape(-1) for p in state.net.parameters()])
    return {"params": params, "bs": bs,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "flat": flat.numpy()}


def sharded_steps(in_path, out_dir):
    """Every train-step case on the 1-D mesh, the first on the (host, env)
    mesh too; the sharded env step; the host-local <-> global round trip
    and the single-process helpers."""
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.parallel import distributed as D
    from alphazero_tpu_torch.parallel import mesh as MP
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    mesh = MP.make_mesh(2)
    out = {"steps": [_step_once(mesh, "env", c) for c in inp["cases"]],
           "chunk": _step_once(mesh, "env", inp["cases"][1], inp["chunk"])}
    mesh2 = D.make_2d_mesh()
    out["mesh2d_shape"] = tuple(mesh2.mesh.shape)
    out["step2d"] = _step_once(mesh2, ("host", "env"), inp["cases"][0])

    cfg = E.SplendorConfig()
    env = {k: torch.from_numpy(v) for k, v in inp["env"].items()}
    local = MP.shard_batch(mesh, env)
    s2, nxt = MP.make_sharded_selfplay_step(cfg, mesh)(
        local["states"], local["actions"], local["uniforms"])
    valid = MP.make_sharded_valid_fn(cfg, mesh)(local["states"])
    out["env"] = D.host_local_to_global(
        mesh, {"states": s2.numpy(), "next": nxt.numpy(),
               "valids": valid.numpy()})

    local_np = {"x": np.arange(32, dtype=np.float32).reshape(16, 2)
                + 100 * D.rank(), "y": np.full((16,), D.rank(), np.int8)}
    glob = D.host_local_to_global(mesh, local_np)
    back = D.global_to_host_local(glob, mesh)
    out["roundtrip"] = {"global": glob, "local": local_np, "back": back}
    out["primary"] = D.is_primary()
    D.sync_hosts("probe")
    out["from_host0"] = D.replicate_from_host0({"a": np.full(3, D.rank())})
    net = MP.replicate(mesh, torch.nn.Linear(3, 2).requires_grad_(False)
                       .apply(lambda m: m.weight.fill_(D.rank())))
    out["replicated"] = net.weight.numpy().copy()
    _dump(out_dir, out)


def sharded_selfplay(out_dir, batch, seed, kw):
    """``run_games`` of a sharded engine (uniform evaluator) on this rank's
    generator from ``(seed, rank)``."""
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.parallel import distributed as D
    from alphazero_tpu_torch.parallel import mesh as MP
    from alphazero_tpu_torch.train import selfplay as SP
    cfg = E.SplendorConfig()
    eng = SP.SelfPlayEngine(cfg, A.make_uniform_eval_fn(cfg),
                            SP.SelfPlayConfig(batch_size=batch, **kw),
                            device="cpu", mesh=MP.make_mesh())
    it, stats = eng.run_games(None, D.rank_generator(seed, D.rank(), "cpu"))
    _dump(out_dir, {"it": it, "stats": stats})


def cli_main(argv, out_dir):
    """On this rank: a ``Coach`` whose batches W does not divide (its
    error), ``bench_scaling`` at a tiny size, then ``cli.main.main(argv)``,
    counting the checkpoint files it writes."""
    from alphazero_tpu_torch.cli import bench_scaling as BS
    from alphazero_tpu_torch.cli import main as CLI
    from alphazero_tpu_torch.train import coach as CO
    from alphazero_tpu_torch.utils import checkpoint as C
    out = {}
    try:
        CO.Coach(CO.CoachConfig(selfplay_batch=3, batch_size=16,
                                checkpoint_dir=out_dir), device="cpu")
    except ValueError as e:
        out["uneven"] = str(e)
    out["bench"] = BS.main(["--device", "cpu", "--batch-per-device", "8",
                            "--steps", "2"])
    saved, save = [], C.save_checkpoint

    def counted(folder, filename, **kw):
        saved.append(filename)
        return save(folder, filename, **kw)
    C.save_checkpoint = counted
    try:
        CLI.main(argv)
    finally:
        C.save_checkpoint = save
    out["saved"] = saved
    _dump(out_dir, out)
