#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--out RECORD.json]

Phases (each raises on failure):
1. print the card's name and power limit, build the CUDA kernels;
2. hold every kernel against its plain PyTorch version on the card, on the
   operands a main-path search gives it, and time both on the device;
3. search: B=1024 boards, 64 sims, root noise on, with the v1 width-128
   net of ``runs/r6/best.pt``; asserts the visit counts and that the
   backup kernel ran once per simulation;
4. self-play: the actor at B=256, 128 sims, playout-cap randomization and
   forced playouts, 12 moves;
5. the same small search on the CPU (plain versions) and on the card, as
   the reference check;
then one JSON line with every kernel's launches, error and times, and the
last line ``{"ok": true, "device": {...}}``.  It exits non-zero, printing
no result, when there is no CUDA device.  With ``--out``, the full
measurements are also written to that JSON file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside tensor cores


def _sync():
    import torch
    torch.cuda.synchronize()


def _device_ms(fn, name=None, reps=5, warmup=2, per_call=1):
    """Device time per unit of work from the profiler's kernel durations:
    each of ``reps`` profiled calls of ``fn`` does ``per_call`` units, and
    its kernels' durations are summed; the median of those sums is divided
    by ``per_call``.  With ``name`` only the kernels whose name contains it
    count, and there must be one per unit.  CUDA events around the calls
    would also count the gaps in which the device waits for the host to
    launch the next kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    _sync()
    sums = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            _sync()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and (name is None or name in e.name)]
        if not us:
            raise AssertionError(f"the profiler saw no kernel {name!r}")
        if name is not None and len(us) != per_call:
            raise AssertionError(f"{len(us)} {name} kernels for {per_call} "
                                 f"units")
        sums.append(sum(us))
    return statistics.median(sums) / per_call / 1e3


def _time_host_ms(fn, reps=5):
    """Median wall time of ``reps`` synchronized calls."""
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_build():
    from alphazero_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {sorted(libs)} in {build_s:.2f} s", flush=True)
    return smi, build_s


def _split_inputs(B, M, A, S1, g, dev):
    import torch
    stats = torch.randn((B, M, 4, A), generator=g, device=dev)
    path_p = torch.randint(0, M + 1, (B, S1), generator=g, device=dev)
    path_a = torch.randint(0, A, (B, S1), generator=g, device=dev)
    # repeated (p, a) pairs inside one board's path
    path_p[:, 1::4] = path_p[:, 0:S1 - 1:4]
    path_a[:, 1::4] = path_a[:, 0:S1 - 1:4]
    w = torch.randn((B, S1, 2), generator=g, device=dev)
    child_p = torch.randint(0, M, (B,), generator=g, device=dev)
    child_a = torch.randint(0, A, (B,), generator=g, device=dev)
    child_v = (torch.randint(0, 2, (B,), generator=g, device=dev)
               * torch.randint(1, M, (B,), generator=g, device=dev)).float()
    pv = torch.randn((B, A), generator=g, device=dev)
    slot = torch.randint(0, M, (B,), generator=g, device=dev).int()
    return (stats, path_p.int(), path_a.int(), w, child_p.int(),
            child_a.int(), child_v, pv, slot)


def _main_search(device="cuda", B=1024, S=64):
    """The main path's search: B boards, S sims, root noise on, the r6 net;
    returns ``(env config, net, search, roots, generator)``."""
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.search import mcts as M
    cfg = E.SplendorConfig(num_players=2)
    net = _r6_net(cfg, device)
    search = M.build_search(
        M.MCTSConfig(num_sims=S, add_noise=True, dirichlet_alpha=0.2,
                     prior_temp=1.25), 2,
        A.make_eval_fn(A.net_config_for(cfg)), A.make_search_step_fn(cfg),
        A.make_valid_fn(cfg), device=device)
    g = torch.Generator(device=device).manual_seed(1)
    roots = E.initial_state(cfg, B, g, device=device)
    return cfg, net, search, roots, g


def _search_backup_operands(**kw):
    """The packed backup's operands of every simulation of one main-path
    search, in order, and the stats array as the last simulation found
    it."""
    import torch
    from alphazero_tpu_torch.search import mcts as M
    _, net, search, roots, g = _main_search(**kw)
    real, ops, base = M.packed_backup, [], []

    def record(stats, *args):
        ops.append(tuple(a.clone() if torch.is_tensor(a) else a
                         for a in args))
        base[:] = [stats.clone()]
        return real(stats, *args)

    M.packed_backup = record
    try:
        search(net, roots, generator=g)
    finally:
        M.packed_backup = real
    _sync()
    return base[0], ops


def _packed_flat(stats, path_p, path_a, w, child_p, child_a, child_v, row,
                 slot):
    """Flat indices and values of every element the packed update adds to
    (for the library yardstick and the byte count)."""
    import torch
    B, M, _, C = stats.shape
    A = C - 2
    dev = stats.device
    b = torch.arange(B, device=dev)[:, None].expand_as(path_p)
    keep = path_p < M
    bb, pp, aa = b[keep].long(), path_p[keep].long(), path_a[keep].long()
    base = (bb * M + pp) * 4
    idx = [(base + 2) * C + aa, (base + 3) * C + aa,
           (base + 2) * C + A, (base + 3) * C + A]
    val = [w[..., 0][keep], w[..., 1][keep]] * 2
    inst = child_v != 0
    bi = torch.arange(B, device=dev)[inst]
    idx.append(((bi * M + child_p[inst].long()) * 4 + 1) * C
               + child_a[inst].long())
    val.append(child_v[inst])
    r0 = (torch.arange(B, device=dev) * M + slot) * 4 * C
    idx.append((r0[:, None] + torch.arange(4 * C, device=dev)[None]).reshape(-1))
    val.append(row.reshape(-1))
    return torch.cat(idx), torch.cat(val)


def _packed_work(stats, path_p, path_a, w, child_p, child_a, child_v, row,
                 slot):
    """``(bytes, adds)`` that one packed update needs at least: path_p,
    child_v, the row and the per-board slot read in full, path_a and w only
    at live levels, child_p and child_a only where a child is installed,
    and every stats element it adds to read and written once."""
    import torch
    M, B = stats.shape[1], path_p.shape[0]
    live = int(((path_p >= 0) & (path_p < M)).sum())
    inst = int((child_v != 0).sum())
    idx, _ = _packed_flat(stats, path_p, path_a, w, child_p, child_a,
                          child_v, row, slot)
    nbytes = (path_p.numel() * 4 + live * (4 + 8) + child_v.numel() * 4
              + inst * (4 + 4) + row.numel() * 4 + B * 4
              + torch.unique(idx).numel() * 8)
    return nbytes, idx.numel()


def phase_kernels():
    """Every kernel of the path against its plain version, on the card."""
    import torch
    from alphazero_tpu_torch.ops import fused_backup as FB
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # split contract (the Pallas kernel's), repeated pairs included
    args = _split_inputs(1024, 65, 409, 65, g, dev)
    got = FB.fused_backup(args[0].clone(), *args[1:])
    want = FB.fused_backup_plain(args[0].clone(), *args[1:])
    _sync()
    err_split = (got - want).abs().max().item()
    print(f"fused_backup split [1024,65,4,409] S1=65: max |kernel - plain| = "
          f"{err_split:.3g}", flush=True)
    if not err_split <= 1e-6:
        raise AssertionError(f"split contract disagrees: {err_split}")
    st = args[0].clone()
    split_ms = _device_ms(lambda: FB.fused_backup(st, *args[1:]),
                          "fused_backup_kernel")
    split_plain_ms = _device_ms(lambda: FB.fused_backup_plain(st, *args[1:]),
                                warmup=1)
    del args, got, want, st

    # packed contract (the search's): the operands of all 64 simulations of
    # a main-path search, applied in order to the stats the last one found
    base, ops = _search_backup_operands()
    node_col = base.shape[3] - 2
    live = torch.stack([(op[0] < base.shape[1]).sum(1) for op in ops]).float()
    got, want, err_packed = base.clone(), base.clone(), 0.0
    for op in ops:
        FB.packed_backup(got, *op)
        FB.fused_backup_plain(want, *op, node_col=node_col)
        if not torch.equal(got, want):
            err_packed = max(err_packed, (got - want).abs().max().item())
    print(f"fused_backup packed {list(base.shape)} S1={ops[0][0].shape[1]}, "
          f"{len(ops)} sims of a search (live levels per board: mean "
          f"{live.mean().item():.2f}, max {int(live.max())}): max |kernel - "
          f"plain| = {err_packed:.3g}", flush=True)
    if err_packed != 0.0:
        raise AssertionError(f"packed contract disagrees: {err_packed}")
    del got, want
    n, st = len(ops), base.clone()

    def kernel():
        for op in ops:
            FB.packed_backup(st, *op)

    def plain():
        for op in ops:
            FB.fused_backup_plain(st, *op, node_col=node_col)
    ms = _device_ms(kernel, "fused_backup_kernel", per_call=n)
    plain_ms = _device_ms(plain, warmup=1, per_call=n)
    plain_wall_ms = _time_host_ms(plain) / n
    flats = [_packed_flat(base, *op) for op in ops]
    flat = st.view(-1)

    def library():
        for idx, val in flats:
            flat.index_put_((idx,), val, accumulate=True)
    library_ms = _device_ms(library, per_call=n)
    # least work, as the mean over the search's launches
    work = [_packed_work(base, *op) for op in ops]
    nbytes = sum(b for b, _ in work) / n
    adds = sum(a for _, a in work) / n
    bound_ms = max(nbytes / HBM_BYTES_PER_S, adds / FP32_OPS_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= adds / FP32_OPS_PER_S
                else "operations")
    print(f"fused_backup device ms per launch: split kernel {split_ms:.4f}, "
          f"split plain {split_plain_ms:.3f}; packed kernel {ms:.4f}, packed "
          f"plain {plain_ms:.3f} (host wall {plain_wall_ms:.3f}), index_put_ "
          f"{library_ms:.4f}, bound {bound_ms:.5f} ({nbytes:.0f} bytes, "
          f"{bound_by})", flush=True)
    out["fused_backup"] = dict(
        max_abs_err=max(err_split, err_packed), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        plain_wall_ms=plain_wall_ms, split_ms=split_ms,
        split_plain_ms=split_plain_ms, bytes=nbytes, adds=adds,
        live_levels_mean=live.mean().item(), live_levels_max=int(live.max()))
    del base, ops, st, flat, flats
    torch.cuda.empty_cache()
    return out


def _r6_net(cfg, device):
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.models import splendor_net as N
    from alphazero_tpu_torch.utils import checkpoint as C
    ckpt = C.load_checkpoint(os.path.join(ROOT, "runs", "r6"), "best.pt")
    net = N.build_net(A.net_config_for(cfg, nn_version=1, width=128), device)
    net.load_state_dict(N.from_flax(ckpt["params"], ckpt["batch_stats"]))
    return net


def _profile(fn):
    """One profiled call of ``fn``: host time per ``mcts.*`` span, device
    busy time (union of kernel intervals) against the wall time, and the
    kernels with the most device time.  Device numbers are None when the
    profiler saw no kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels, intervals = {}, {}, []
    for e in prof.events():
        span = e.name.startswith("mcts.")
        if e.device_type == DeviceType.CPU and span:
            spans[e.name] = (spans.get(e.name, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
        # the spans show up on the device timeline too, as annotations
        elif e.device_type == DeviceType.CUDA and not span:
            intervals.append((e.time_range.start, e.time_range.end))
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3 if intervals else None
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "spans_host_ms": spans,
            "device_busy_ms": busy_ms,
            "device_idle_share": (None if busy_ms is None
                                  else 1.0 - busy_ms / wall_ms),
            "kernel_launches": len(intervals),
            "top_kernels_ms": dict(top)}


def phase_search(reps=5):
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.ops import fused_backup as FB
    B, S = 1024, 64
    cfg, net, search, roots, g = _main_search(B=B, S=S)
    search(net, roots, generator=g)                       # warm-up
    _sync()
    FB.fused_backup.launches = 0
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        res = search(net, roots, generator=g)
        _sync()
        times.append(time.perf_counter() - t0)
    launches = FB.fused_backup.launches
    raw = res.raw_counts
    valid = A.make_valid_fn(cfg)(roots)
    if not bool((raw.sum(1) == S).all()):
        raise AssertionError("root visit counts do not sum to num_sims")
    if bool((raw * ~valid).any()):
        raise AssertionError("visits on invalid root actions")
    if not bool(torch.isfinite(res.q).all()):
        raise AssertionError("non-finite root q")
    if launches != reps * S:
        raise AssertionError(f"backup kernel launched {launches} times for "
                             f"{reps * S} sims")
    rps = B * S / statistics.median(times)
    print(f"search B={B} S={S}: {rps:.1f} rollouts/s (median of {reps}, "
          f"{statistics.median(times) * 1e3:.1f} ms/search); backup launches "
          f"{launches}", flush=True)
    prof = _profile(lambda: search(net, roots, generator=g))
    spans = ", ".join(f"{k} {v:.1f}" for k, v in
                      sorted(prof["spans_host_ms"].items()))
    print(f"search profile: wall {prof['wall_ms']:.1f} ms; host ms per span: "
          f"{spans}; device busy {prof['device_busy_ms']} ms, idle share "
          f"{prof['device_idle_share']}, {prof['kernel_launches']} kernels",
          flush=True)
    return {"rollouts_per_s": rps, "search_ms": statistics.median(times) * 1e3,
            "launches": launches, "reps": reps, "batch": B, "sims": S,
            "times_s": times, "profile": prof}


def phase_selfplay():
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.ops import fused_backup as FB
    from alphazero_tpu_torch.train import selfplay as SP
    cfg = E.SplendorConfig(num_players=2)
    net = _r6_net(cfg, "cuda")
    sp = SP.SelfPlayConfig(batch_size=256, num_sims=128, ratio_full=4,
                           prob_full=0.25, temp_threshold=10,
                           forced_playouts=True, max_moves=12,
                           chunk_moves=12)
    eng = SP.SelfPlayEngine(cfg, A.make_eval_fn(A.net_config_for(cfg)), sp,
                            device="cuda")
    FB.fused_backup.launches = 0
    _sync()
    t0 = time.perf_counter()
    it, stats = eng.run_games(net, torch.Generator(device="cuda")
                              .manual_seed(2))
    _sync()
    dt = time.perf_counter() - t0
    launches = FB.fused_backup.launches
    moves = 12                       # no 2-player game ends within 12 moves
    if launches != moves * (sp.num_sims + eng.fast_sims):
        raise AssertionError(f"backup kernel launched {launches} times in "
                             f"{moves} moves")
    n = len(it)
    if n != moves * eng.b_full or stats["examples"] != n:
        raise AssertionError(f"{n} examples, expected {moves * eng.b_full}")
    pi = it.pi.astype("float32")
    if not (abs(pi.sum(1) - 1.0) < 2e-3).all() or (it.pi[~it.valids] != 0).any():
        raise AssertionError("policy targets are not distributions over "
                             "valid actions")
    if it.boards.shape != (n, cfg.rows, 7) or it.winner.shape != (n, 2):
        raise AssertionError("Iteration shapes")
    rps = stats["rollouts"] / dt
    print(f"self-play B=256 S=128 PCR: {rps:.1f} rollouts/s, {n} examples in "
          f"{dt:.2f} s; backup launches {launches}", flush=True)
    return {"rollouts_per_s": rps, "seconds": dt, "examples": n,
            "rollouts": stats["rollouts"], "launches": launches}


def phase_reference():
    """The same small searches on the CPU (plain versions) and the card."""
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.search import mcts as M
    cfg = E.SplendorConfig(num_players=2)
    g = torch.Generator().manual_seed(4)
    roots = E.initial_state(cfg, 8, g, device="cpu")
    out = {}
    for name, evaluator in (("uniform", None), ("r6", "r6")):
        res = {}
        for dev in ("cpu", "cuda"):
            if evaluator is None:
                params, eval_fn = None, A.make_uniform_eval_fn(cfg)
            else:
                params = _r6_net(cfg, dev)
                eval_fn = A.make_eval_fn(A.net_config_for(cfg))
            search = M.build_search(M.MCTSConfig(num_sims=16), 2, eval_fn,
                                    A.make_search_step_fn(cfg),
                                    A.make_valid_fn(cfg), device=dev)
            res[dev] = search(params, roots.to(dev))
        cpu, gpu = res["cpu"], res["cuda"]
        if evaluator is None:
            if not torch.equal(cpu.raw_counts, gpu.raw_counts.cpu()):
                raise AssertionError("uniform search: card and CPU differ")
        err = (cpu.root_value - gpu.root_value.cpu()).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"{name} root values differ by {err}")
        same = int((cpu.raw_counts == gpu.raw_counts.cpu()).all(1).sum())
        out[name] = {"root_value_err": err, "boards_equal_counts": same}
        print(f"reference {name}: root value |cpu - card| {err:.3g}, "
              f"{same}/8 boards with equal counts", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full record to this "
                    "JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi, build_s = phase_build()
    kernels = phase_kernels()
    search = phase_search()
    selfplay = phase_selfplay()
    reference = phase_reference()

    kb = kernels["fused_backup"]
    line = {"kernels": [{
        "name": "fused_backup", "route": "cuda",
        "source": "alphazero_tpu_torch/ops/csrc/fused_backup.cu",
        "replaces": "alphazero_tpu/ops/fused_backup.py:118",
        "launches": search["launches"] + selfplay["launches"],
        "max_abs_err": kb["max_abs_err"], "ms": kb["ms"],
        "plain_ms": kb["plain_ms"], "bound_ms": kb["bound_ms"],
        "bound_by": kb["bound_by"], "library_ms": kb["library_ms"]}]}
    record = {"card": smi, "build_s": build_s, "kernels": kernels,
              "search": search, "selfplay": selfplay, "reference": reference,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
