#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Its kernels held to their plain versions, launch counts on every path,
and each kernel's device time:

    python3 chip_smoke.py [--out RECORD.json]

Phases, in the order they run (each raises on failure):

- ``phase_build``: the card's name and power limit; the CUDA kernels built.
- ``phase_kernels``: the backup (split, entry and operand contracts), the
  descent and the env step, float32 and bf16, each equal to its plain
  version on made-up inputs and on every simulation of searches at the
  main path's and self-play's shapes; their device time per launch beside
  the bound, the L2 latency and the launch floor (``l2_chase.cu``), the
  plain version's device and host time and ``index_put_``'s.
- ``phase_search``: the main path's search (B=1024, S=64, r6): visit
  counts, one backup, descent and env-step launch per simulation, one
  profiled search; the plain step's search equal in visit counts.
- ``phase_selfplay``, ``phase_bench``, ``phase_bf16``: fresh self-play
  (B=256, S=128, PCR), ``cli.bench`` and ``cli.bench_selfplay``'s rows,
  and the search and self-play on bf16 stats, launches = simulations.
- ``phase_reuse``: the reusing search, self-play with reuse and
  ``cli.main --tree-reuse``; backups and descents held to plain on
  carried trees, a reroot equal on the card and the CPU.
- ``phase_reference``: small searches equal on the CPU and the card.
- ``phase_graphs``, ``phase_bt4_dense``: the graphed leaf evaluator bit
  for bit against ``apply_inference`` (r6, r12, the BT4 cell's net), the
  replay's kernels equal to the eager forward's; each biased BT4 trunk
  Dense one GEMM with no bias add of its own.
- ``phase_train``, ``phase_coach``, ``phase_pit``, ``phase_export``,
  ``phase_distributed``, ``phase_tooling``: ``fit``, a coach iteration,
  the pit, export, ``--distributed`` at W=1 and the tools on the card,
  each search path's backups and descents held to plain in a spread of
  launches and counted against its simulations.

Then a line with the bench rows, one JSON line with every kernel's
launches, error and times, the card's line and last ``{"ok": true,
"device": {...}}``.  It exits non-zero, printing no result, when there is
no CUDA device.  With ``--out``, the full record is written to that file.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import logging
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

from h100bench import peaks
from h100bench.work import env_step_bytes

ROOT = os.path.dirname(os.path.abspath(__file__))
PADS = 16                  # spin kernels that open a profiled window


def _sync():
    import torch
    torch.cuda.synchronize()


@contextlib.contextmanager
def _installed(owner, **values):
    """While open, ``owner``'s attributes named in ``values`` are those
    values (a recording wrapper in place of a package function); the old
    ones are restored on exit."""
    saved = {k: getattr(owner, k) for k in values}
    for k, v in values.items():
        setattr(owner, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(owner, k, v)


# profiled calls that kept too few records (see ``_profile``): (kernel
# name, records wanted, kept), or (None, "agreeing windows", the device
# records each whole window kept), printed before the last line
PROFILER_SHORT = []


def _profile(fn, name=None, per_call=None, counter=None, host=False,
             shapes=False):
    """One profiled call of ``fn``: its wall time; with ``host`` the host
    ms per ``mcts.*`` span, and with ``shapes`` each op that launched
    kernels with its input shapes and those kernels' µs (``ops``); device
    busy time (the union of kernel, copy and memset intervals), their sum,
    idle share, device ops and kernels (copies and memsets left out)
    counted, the kernels with the most device time, and with ``name`` the
    µs of each kernel whose name holds it (``named_us``).  The profiler
    loses records: on the H100's hosts the first 6-9 of a window, now and
    then some 50, and now and then a run inside a window.  So each window
    opens with spin kernels, ``PADS`` of them and twice as many at each
    retry, and is whole when it kept one of them or more (what was lost at
    its start was pads) and, with ``name``, nine tenths of its
    ``per_call`` records of that kernel.  Where the call does ``per_call``
    units of work (a time, a median over calls) the first whole window is
    taken; where not (a profile, a count of kernels), the first two whole
    windows that kept as many device records.  Eight windows are profiled
    at most; failing that, the whole window that kept the most records is
    taken, else the window that kept the most of ``name`` if it kept a
    quarter of them, either logged in ``PROFILER_SHORT``; else this
    raises.  With ``counter`` every profiled call must raise that
    wrapper's launch count by ``per_call``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    whole, best = {}, (0, None)
    for attempt in range(8):
        _sync()
        before = None if counter is None else counter.launches
        with profile(activities=acts, record_shapes=shapes) as prof:
            for _ in range(PADS << attempt):
                torch.cuda._sleep(100)
            t0 = time.perf_counter()
            fn()
            _sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if before is not None and counter.launches - before != per_call:
            raise AssertionError(f"{counter.launches - before} {name!r} "
                                 f"launches counted for {per_call} units")
        events = prof.events()
        # annotations (the mcts.* spans, Optimizer.step#...) show up on the
        # device timeline too, under the name of their host range
        host_names = {e.name for e in events
                      if e.device_type == DeviceType.CPU}
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in host_names]
        pads = sum("spin_kernel" in e.name for e in dev)
        dev = [e for e in dev if "spin_kernel" not in e.name]
        named = [e.time_range.elapsed_us() for e in dev
                 if name is not None and name in e.name]
        if name is not None and len(named) > per_call:
            raise AssertionError(f"the profiler saw {len(named)} {name!r} "
                                 f"kernels for {per_call} units")
        window = (events, dev, named, wall_ms)
        if pads and (name is None or len(named) >= 0.9 * per_call):
            if per_call is not None or len(dev) in whole:
                break
            whole[len(dev)] = window
        elif len(named) > best[0]:
            best = (len(named), window)
    else:
        if whole:
            window = whole[max(whole)]
            PROFILER_SHORT.append((name, "agreeing windows", sorted(whole)))
        elif name is not None and 4 * best[0] >= per_call:
            window = best[1]
            PROFILER_SHORT.append((name, per_call, best[0]))
        else:
            raise AssertionError(f"no whole window in 8, the best kept "
                                 f"{best[0]} of {per_call} {name!r} records")
    events, dev, named, wall_ms = window
    spans, by_name = {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("mcts."):
            spans[e.name] = (spans.get(e.name, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3 if dev else None
    out = {"wall_ms": wall_ms, "spans_host_ms": spans,
           "device_busy_ms": busy_ms, "device_ms": sum(by_name.values()),
           "device_idle_share": (None if busy_ms is None
                                 else 1.0 - busy_ms / wall_ms),
           "kernel_launches": len(dev),
           "kernels": sum(not e.name.startswith(("Memcpy", "Memset"))
                          for e in dev),
           "top_kernels_ms": dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:8]),
           "named_us": named}
    if shapes:
        out["ops"] = []
        for e in events:
            ks = [(k.name, k.duration) for k in e.kernels
                  if "spin_kernel" not in k.name]
            if ks:
                out["ops"].append((e.name, e.input_shapes, ks))
    return out


def _device_ms(fn, name=None, reps=5, warmup=2, per_call=1, counter=None):
    """Device time per unit of work from the profiler's kernel durations:
    each of ``reps`` profiled calls of ``fn`` (``_profile``'s windows) does
    ``per_call`` units; the result is the median over the calls.  Without
    ``name`` a call's time is the sum of all its kernels' durations over
    ``per_call``.  With ``name`` only the kernels whose name contains it
    count, one per unit, and a call's time is their mean duration: a lost
    record costs a sample, not the time of the ones kept.  What no record
    is needed for is held exactly: with ``name`` every profiled call must
    raise the wrapper's launch count (``counter``, by default
    ``fused_backup``'s) by ``per_call``.  CUDA events around the calls
    would also count the gaps in which the device waits for the host to
    launch the next kernel."""
    from alphazero_tpu_torch.ops import fused_backup as FB
    if name is not None and counter is None:
        counter = FB.fused_backup
    for _ in range(warmup):
        fn()
    per_unit = []
    for _ in range(reps):
        p = _profile(fn, name, per_call, counter)
        us = p["named_us"]
        per_unit.append(p["device_ms"] / per_call if name is None
                        else sum(us) / len(us) / 1e3)
    return statistics.median(per_unit)


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


def _made_up_entry_args(B, M, A, S1, P, g, dev, slot):
    """Arguments of ``backprop_packed`` that a tree never gives: random
    paths up to ``S1`` levels deep whose nodes repeat at other actions, live
    levels at the slot's node, and child pointers into the slot's row."""
    import torch

    def ri(lo, hi, *shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=dev).to(dtype)
    stats = torch.randn((B, M, 4, A + 2), generator=g, device=dev)
    if slot == "per_board":
        slot = ri(1, M, B, dtype=torch.int32)
    else:                                              # one slot on all boards
        slot = torch.full((B,), slot, dtype=torch.int32, device=dev)
    path_p = ri(0, M + 1, B, S1, dtype=torch.int32)
    path_p[:, 1::3] = path_p[:, 0:S1 - 1:3]            # repeats of p
    path_p[::2, 2] = slot[::2]                         # a live p == slot
    path_p[::4, S1 - 1] = slot[::4]                    # ... in the last chunk
    depth = ri(0, S1 + 1, B, dtype=torch.int32)
    depth[::4] = S1
    parent = ri(0, M, B)
    parent[::3] = slot[::3]                            # child into the row
    return (stats, path_p, ri(0, A, B, S1, dtype=torch.int32),
            ri(0, P, B, S1, dtype=torch.int32), depth,
            torch.randn((B, P), generator=g, device=dev), ri(0, P, B),
            parent, ri(0, A, B), ri(0, 2, B).bool(), slot,
            torch.rand((B, A), generator=g, device=dev), ri(0, 2, B).bool(),
            ri(0, P, B), torch.randn((B, P), generator=g, device=dev)[:, 0],
            torch.randn((B, P), generator=g, device=dev))


def _main_search(device="cuda", B=1024, S=64, stats_dtype="auto",
                 step=None):
    """The main path's search: B boards, S sims, root noise on, the r6 net,
    stats in ``stats_dtype``, the transition ``step(cfg, states, actions)``
    (by default the search's own, ``adapter.make_search_step_fn``);
    returns ``(env config, net, search, roots, generator)``."""
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.search import mcts as M
    cfg = E.SplendorConfig(num_players=2)
    net = _r6_net(cfg, device)
    step_fn = (A.make_search_step_fn(cfg) if step is None
               else functools.partial(step, cfg))
    search = M.build_search(
        M.MCTSConfig(num_sims=S, add_noise=True, dirichlet_alpha=0.2,
                     prior_temp=1.25, stats_dtype=stats_dtype), 2,
        A.make_eval_fn(A.net_config_for(cfg)), step_fn, A.make_valid_fn(cfg),
        device=device)
    g = torch.Generator(device=device).manual_seed(1)
    roots = E.initial_state(cfg, B, g, device=device)
    return cfg, net, search, roots, g


def _search_backup_args(**kw):
    """``backprop_packed``'s arguments in every simulation of one main-path
    search, in order, and the stats array as the last simulation found
    it."""
    import torch
    from alphazero_tpu_torch.search import mcts as M
    _, net, search, roots, g = _main_search(**kw)
    real, raws, base = M.backprop_packed, [], []

    def record(stats, *args):
        raws.append(tuple(a.clone() if torch.is_tensor(a) else a
                          for a in args))
        base[:] = [stats.clone()]
        return real(stats, *args)

    with _installed(M, backprop_packed=record):
        search(net, roots, generator=g)
    _sync()
    return base[0], raws


def _touched(stats, path_p, path_a, w, child_p, child_a, child_v, row, slot,
             node_col=None, live=None, row_elems=None):
    """Flat indices and values of every element an update adds to (for the
    library yardstick and the byte count): the live levels' edge elements
    and, with ``node_col``, node elements, the installed child pointers, and
    the row, of which ``row_elems`` (offsets into the node's four lanes)
    selects a part."""
    import torch
    B, M, _, C = stats.shape
    dev = stats.device
    ar = torch.arange(B, device=dev)
    b = ar[:, None].expand_as(path_p)
    keep = (path_p >= 0) & (path_p < M) if live is None else live
    bb, pp, aa = b[keep].long(), path_p[keep].long(), path_a[keep].long()
    base = (bb * M + pp) * 4
    idx = [(base + 2) * C + aa, (base + 3) * C + aa]
    val = [w[..., 0][keep], w[..., 1][keep]]
    if node_col is not None:
        idx += [(base + 2) * C + node_col, (base + 3) * C + node_col]
        val += val
    inst = child_v != 0
    idx.append(((ar[inst] * M + child_p[inst].long()) * 4 + 1) * C
               + child_a[inst].long())
    val.append(child_v[inst])
    row = row.reshape(B, -1)
    if row_elems is None:
        row_elems = torch.arange(row.shape[1], device=dev)
    r0 = (ar * M + slot) * 4 * C
    idx.append((r0[:, None] + row_elems[None]).reshape(-1))
    val.append(row[:, row_elems].reshape(-1))
    return torch.cat(idx), torch.cat(val), int(keep.sum()), int(inst.sum())


def _bound(nbytes, adds):
    by_bytes = nbytes / peaks.HBM_BYTES_PER_S
    by_ops = adds / peaks.FP32_FLOPS
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def _operand_work(stats, *ops, node_col=None):
    """``(bytes, adds)`` that one update of the operand contracts needs at
    least: path_p, child_v, the row and the per-board slot read in full,
    path_a and w only at live levels, child_p and child_a only where a
    child is installed, and every stats element it adds to read and written
    once."""
    import torch
    path_p, child_v, row = ops[0], ops[5], ops[6]
    idx, _, live, inst = _touched(stats, *ops, node_col=node_col)
    nbytes = (path_p.numel() * 4 + live * (4 + 8) + child_v.numel() * 4
              + inst * (4 + 4) + row.numel() * 4 + path_p.shape[0] * 4
              + torch.unique(idx).numel() * 8)
    return nbytes, idx.numel()


def _entry_touched(stats, *raw):
    """``_touched`` for ``backprop_packed``: the PVALID lane of the slot's
    row and its node scalars, not the lanes that receive zeros."""
    import torch
    from alphazero_tpu_torch.ops import fused_backup as FB
    C = stats.shape[3]
    A, P = C - 2, raw[4].shape[1]
    dev = stats.device
    path_p, depth = raw[0], raw[3]
    live = ((torch.arange(path_p.shape[1], device=dev)[None] < depth[:, None])
            & (path_p >= 0) & (path_p < stats.shape[1]))
    elems = torch.cat([
        torch.arange(A + 1, device=dev),                 # PVALID, flag
        torch.tensor([FB.CHILD * C + A, FB.EW * C + A], device=dev),
        torch.arange(P, device=dev) * C + A + 1])
    return _touched(stats, *FB.packed_operands(stats, *raw), node_col=A,
                    live=live, row_elems=elems)


def _entry_work(stats, *raw):
    """``(bytes, adds)`` that one ``backprop_packed`` needs at least: the
    per-board scalars, value_vec, term_vec and pvalid_new read in full, the
    three path arrays only at live levels, parent and action only where a
    child is installed, every stats element that receives a term read and
    written once, and the per-board slot."""
    import torch
    B, A, P = stats.shape[0], stats.shape[3] - 2, raw[4].shape[1]
    idx, _, live, inst = _entry_touched(stats, *raw)
    per_board = 4 + 8 + 1 + 1 + 8 + 4 + 2 * 4 * P + 4 * A + 4
    nbytes = (B * per_board + live * 12 + inst * 16
              + torch.unique(idx).numel() * 2 * stats.element_size())
    return nbytes, idx.numel() + B * A


def _check_made_up(FB, dev, g):
    """Both packed contracts against their plain versions on made-up cases
    with repeats, collisions and paths of three chunks, the last with rows
    wider than the kernels hold in registers; returns the largest
    difference."""
    import torch
    worst = 0.0
    for B, A, P, slot in ((512, 409, 2, 7), (512, 409, 3, "per_board"),
                          (512, 409, 4, 1), (64, 2101, 2, "per_board")):
        args = _made_up_entry_args(B, 40, A, 70, P, g, dev, slot)
        want = FB.backprop_packed_plain(args[0].clone(), *args[1:])
        ops = FB.packed_operands(*args)
        for got in (FB.backprop_packed(args[0].clone(), *args[1:]),
                    FB.packed_backup(args[0].clone(), *ops)):
            if not torch.equal(got, want):
                worst = max(worst, (got - want).abs().max().item())
    return worst


def _check_replay(FB, base, raws, ops):
    """A search's backups replayed in order on copies of ``base``: the entry
    on the raw arguments, the operand contract on the operands built from
    them, and the plain version.  Returns the largest difference of each
    kernel from the plain version, over all simulations, and raises unless
    both are 0."""
    import torch
    got, got_ops, want = base.clone(), base.clone(), base.clone()
    err_entry = err_packed = 0.0
    for raw, op in zip(raws, ops):
        FB.backprop_packed(got, *raw)
        FB.packed_backup(got_ops, *op)
        FB.backprop_packed_plain(want, *raw)
        if not torch.equal(got, want):
            err_entry = max(err_entry, (got - want).abs().max().item())
        if not torch.equal(got_ops, want):
            err_packed = max(err_packed, (got_ops - want).abs().max().item())
    live = torch.stack([raw[3] for raw in raws]).float()
    print(f"fused_backup packed {list(base.shape)} S1={raws[0][0].shape[1]}, "
          f"{len(raws)} sims of a search (live levels per board: mean "
          f"{live.mean().item():.2f}, max {int(live.max())}): max |kernel - "
          f"plain| = {err_entry:.3g} (entry), {err_packed:.3g} (operand "
          f"contract)", flush=True)
    if err_entry != 0.0 or err_packed != 0.0:
        raise AssertionError(f"packed contracts disagree: entry {err_entry}, "
                             f"operands {err_packed}")
    return live


def phase_kernels():
    """Every kernel of the path against its plain version, on the card."""
    import torch
    from alphazero_tpu_torch.ops import fused_backup as FB
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    kname = "fused_backup_"
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

    def split():
        for _ in range(16):
            FB.fused_backup(st, *args[1:])
    split_ms = _device_ms(split, kname, per_call=16)
    split_plain_ms = _device_ms(lambda: FB.fused_backup_plain(st, *args[1:]),
                                warmup=1)
    idx, val, _, _ = _touched(st, *args[1:])
    flat = st.view(-1)
    split_library_ms = _device_ms(
        lambda: flat.index_put_((idx,), val, accumulate=True))
    split_bytes, split_adds = _operand_work(st, *args[1:])
    split_bound_ms, split_bound_by = _bound(split_bytes, split_adds)
    del args, got, want, st, flat, idx, val

    # made-up collisions and repeats, both packed contracts
    err_made_up = _check_made_up(FB, dev, g)
    print(f"fused_backup made-up repeats and slot collisions, entry and "
          f"operand contract: max |kernel - plain| = {err_made_up:.3g}",
          flush=True)
    if err_made_up != 0.0:
        raise AssertionError(f"made-up case disagrees: {err_made_up}")

    # packed contracts (the search's): the arguments of all 64 simulations
    # of a main-path search, applied in order to the stats the last one found
    base, raws = _search_backup_args()
    if base.dtype != torch.float32:
        raise AssertionError(f'stats_dtype "auto" gave {base.dtype} stats '
                             f'on cuda, not float32')
    print('stats_dtype "auto" on cuda: float32 (the main-path search)',
          flush=True)
    node_col = base.shape[3] - 2
    n = len(raws)
    ops = [FB.packed_operands(base, *raw) for raw in raws]
    live = _check_replay(FB, base, raws, ops)
    st = base.clone()

    def entry():
        for raw in raws:
            FB.backprop_packed(st, *raw)

    def operand():
        for op in ops:
            FB.packed_backup(st, *op)

    def plain():                  # a Python loop over levels: every 8th sim
        for raw in raws[::8]:
            FB.backprop_packed_plain(st, *raw)
    entry_ms = _device_ms(entry, kname, per_call=n)
    operand_ms = _device_ms(operand, kname, per_call=n)
    plain_ms = _device_ms(plain, warmup=1, per_call=len(raws[::8]))
    plain_wall_ms = _time_host_ms(plain) / len(raws[::8])
    # the host's share: what one backup costs the caller, synchronized
    host_entry_ms = _time_host_ms(entry) / n
    flat = st.view(-1)
    flats = [_entry_touched(base, *raw)[:2] for raw in raws]
    flats_ops = [_touched(base, *op, node_col=node_col)[:2] for op in ops]

    def library(pairs):
        for idx, val in pairs:
            flat.index_put_((idx,), val, accumulate=True)
    library_ms = _device_ms(lambda: library(flats), per_call=n)
    operand_library_ms = _device_ms(lambda: library(flats_ops), per_call=n)
    del flats, flats_ops
    # least work, as the mean over the search's launches
    work = [_entry_work(base, *raw) for raw in raws]
    nbytes, adds = (sum(x[i] for x in work) / n for i in (0, 1))
    bound_ms, bound_by = _bound(nbytes, adds)
    work = [_operand_work(base, *op, node_col=node_col) for op in ops]
    op_bytes, op_adds = (sum(x[i] for x in work) / n for i in (0, 1))
    operand_bound_ms, operand_bound_by = _bound(op_bytes, op_adds)
    del base, raws, ops, st, flat
    torch.cuda.empty_cache()

    # both packed contracts at self-play's shapes (at S1=128 a path has four
    # chunks of levels and a block has an SM to itself), held to the plain
    # version there too; what stays of the B=1024 time is latency, what
    # falls with B is bytes
    small_ms = {}
    for B, S in ((192, 32), (64, 128)):
        base, raws = _search_backup_args(B=B, S=S)
        ops = [FB.packed_operands(base, *raw) for raw in raws]
        _check_replay(FB, base, raws, ops)

        def small_entry():
            for raw in raws:
                FB.backprop_packed(base, *raw)

        def small_operand():
            for op in ops:
                FB.packed_backup(base, *op)
        work = [_entry_work(base, *raw) for raw in raws]
        small_bytes = sum(x[0] for x in work) / len(work)
        small_bound_ms, small_bound_by = _bound(
            small_bytes, sum(x[1] for x in work) / len(work))
        small_ms[f"B{B}_M{S + 1}"] = {
            "entry": _device_ms(small_entry, kname, per_call=len(raws)),
            "operand": _device_ms(small_operand, kname, per_call=len(raws)),
            "bound_ms": small_bound_ms, "bound_by": small_bound_by,
            "bytes": small_bytes}
        del base, raws, ops
    torch.cuda.empty_cache()

    def us(ms):
        return f"{ms * 1e3:.3f}"
    print(f"fused_backup device us per launch at B=1024: entry "
          f"{us(entry_ms)}, bound {bound_ms * 1e3:.4f} ({nbytes:.0f} bytes, "
          f"{bound_by}), plain {plain_ms * 1e3:.1f} (host wall "
          f"{plain_wall_ms * 1e3:.1f}), index_put_ {library_ms * 1e3:.1f}; "
          f"operand contract {us(operand_ms)}, bound "
          f"{operand_bound_ms * 1e3:.4f} ({op_bytes:.0f} bytes, "
          f"{operand_bound_by}), index_put_ {operand_library_ms * 1e3:.1f}; "
          f"split {us(split_ms)}, bound {split_bound_ms * 1e3:.4f} "
          f"({split_bytes} bytes, {split_bound_by}), plain "
          f"{split_plain_ms * 1e3:.1f}, index_put_ "
          f"{split_library_ms * 1e3:.1f}", flush=True)
    print("fused_backup device us per launch at self-play's shapes, entry / "
          "operand contract (entry bound): "
          + ", ".join(f"{k} {v['entry'] * 1e3:.3f} / {v['operand'] * 1e3:.3f}"
                      f" (bound {v['bound_ms'] * 1e3:.4f}, {v['bytes']:.0f} "
                      f"bytes, {v['bound_by']})"
                      for k, v in small_ms.items()), flush=True)
    print(f"backup host us per launch, synchronized (median of 5 replays of "
          f"{n} sims): entry {host_entry_ms * 1e3:.1f}", flush=True)
    out["fused_backup"] = dict(
        # the replays raise unless they are exact, so they add 0
        max_abs_err=max(err_split, err_made_up),
        ms=entry_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms, small_ms=small_ms,
        plain_wall_ms=plain_wall_ms, bytes=nbytes, adds=adds,
        operand_ms=operand_ms, operand_bound_ms=operand_bound_ms,
        operand_bound_by=operand_bound_by, operand_bytes=op_bytes,
        operand_library_ms=operand_library_ms,
        split_ms=split_ms, split_plain_ms=split_plain_ms,
        split_bound_ms=split_bound_ms, split_bound_by=split_bound_by,
        split_bytes=split_bytes, split_library_ms=split_library_ms,
        host_entry_ms=host_entry_ms,
        live_levels_mean=live.mean().item(), live_levels_max=int(live.max()))
    out["descent"] = _descent_kernel_phase(g)
    out["env_step"] = _env_step_kernel_phase(
        torch.Generator(device=dev).manual_seed(12),
        out["descent"]["launch_floor_ms"])
    out["descent_bf16"], out["fused_backup_bf16"] = _bf16_kernel_phase(
        g, out["descent"]["l2_latency_ms"])
    return out


DESCENT_OUTPUTS = ("parent", "action", "existing", "depth", "parent_rot",
                   "path_p", "path_a", "path_r")

# the descent's replayed searches, (B, S, kind, keep every n-th sim's tree
# for timing): the main path's search, self-play's full search at its batch
# and at its PCR share (forced playouts, depth cap 64), and review (B=1,
# no depth cap)
DESCENT_SHAPES = ((1024, 64, "search", 8), (256, 128, "selfplay", 16),
                  (64, 128, "selfplay", 16), (1, 1600, "review", 100))


def _outputs_diff(got, want):
    """Largest |kernel - plain| over the descent's eight outputs; raises
    where a dtype or shape differs."""
    worst = 0.0
    for name, a, b in zip(DESCENT_OUTPUTS, got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"descent {name}: kernel {a.dtype} "
                                 f"{tuple(a.shape)}, plain {b.dtype} "
                                 f"{tuple(b.shape)}")
        if a.numel() and not bool((a == b).all()):
            worst = max(worst, float((a.long() - b.long()).abs().max()))
    return worst


def _made_up_trees(g, dev):
    """Descent cases a search rarely gives, as ``(cfg, stats, sim_idx,
    depth_cap)``: random child pointers (some terminal, some -0.0, cycles
    that run to the cap), priors and values on coarse grids (ties in u),
    NaN value sums on some visited edges of every 11th board,
    rows with one prior on every valid edge and no visits (exact ties),
    all-invalid rows at the root and below, fpu > 0, = 0 and < 0, forced
    playouts on and off, caps of 0, 1 and 6 levels, rows of 700 edges
    (24,624 bytes of the kernel's shared memory per block) and of 1,600
    (53,424 bytes: above the 48 KB a kernel may use without opting in)."""
    import torch
    from alphazero_tpu_torch.ops import descent as D
    from alphazero_tpu_torch.search import mcts as M

    def r(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev).float()

    def tree(B, Mx, A, p_child):
        st = torch.zeros((B, Mx, 4, A + 2), device=dev)
        shape = (B, Mx, A)
        st[:, :, D.PVALID, :A] = torch.where(r(*shape) < 0.3, -1.0,
                                             ri(0, 8, *shape) / 8)
        en = ri(0, 5, *shape) * (r(*shape) < 0.6)
        st[:, :, D.EN, :A] = en
        st[:, :, D.EW, :A] = en * ri(-2, 3, *shape) / 2
        sign = torch.where(r(*shape) < 1 / 6, -1.0, 1.0)
        st[:, :, D.CHILD, :A] = (ri(1, Mx, *shape) * (r(*shape) < p_child)
                                 * sign)
        st[:, :, D.EN, A] = ri(0, 60, B, Mx)
        st[:, :, D.EW, A] = ri(-20, 21, B, Mx) / 4
        st[:, :, D.CHILD, A] = ri(0, 3, B, Mx)
        tie = st[1::5, :, D.PVALID, :A]
        st[1::5, :, D.PVALID, :A] = torch.where(tie >= 0, 0.25, -1.0)
        st[1::5, :, D.EN, :A] = 0.0
        st[2::9, 0, D.PVALID, :A] = -1.0
        st[3::7, 1:, D.PVALID, :A] = -1.0
        nan = (r(*shape) < 0.05) & (en > 0)
        st[4::11, :, D.EW, :A] = torch.where(
            nan[4::11], torch.nan, st[4::11, :, D.EW, :A])
        return st

    cases = []
    for B, Mx, A, fpu, forced, cap, p_child, sim in (
            (512, 40, 409, 0.25, True, 39, 0.5, 37),
            (512, 40, 409, -0.1, True, 39, 0.9, 50),
            (512, 40, 409, 0.0, False, 6, 0.9, 0),
            (512, 40, 409, 0.3, False, 39, 0.5, 5),
            (512, 40, 409, 0.0, True, 1, 0.9, 20),
            (64, 20, 409, 0.25, True, 0, 0.5, 9),
            (64, 20, 700, 0.25, True, 19, 0.7, 44),
            (16, 12, 1600, 0.25, True, 11, 0.7, 30)):
        cfg = M.MCTSConfig(cpuct=1.25, fpu=fpu, forced_playouts=forced,
                           k_forced=0.5)
        cases.append((cfg, tree(B, Mx, A, p_child), sim, cap))
    return cases


def _descent_search(B, S, kind, stats_dtype="auto"):
    """A search of ``DESCENT_SHAPES`` (or of self-play's fast search,
    ``kind="fast"``) on the card with the r6 net: returns ``(search, net,
    roots, generator)``."""
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import board_dsl as BD
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.search import mcts as M
    from alphazero_tpu_torch.train import selfplay as SP
    cfg = E.SplendorConfig(num_players=2)
    kw = {}
    if kind == "search":
        kw = dict(add_noise=True, dirichlet_alpha=0.2, prior_temp=1.25)
    elif kind == "selfplay":
        sp = SP.SelfPlayConfig()
        kw = dict(cpuct=sp.cpuct, fpu=sp.fpu, forced_playouts=True,
                  add_noise=True, dirichlet_alpha=sp.dirichlet_alpha,
                  prior_temp=sp.prior_temp, max_depth=sp.max_depth)
    elif kind == "fast":            # self-play's fast (PCR) search
        sp = SP.SelfPlayConfig()
        kw = dict(cpuct=sp.cpuct, fpu=sp.fpu, max_depth=sp.max_depth)
    g = torch.Generator(device="cuda").manual_seed(1)
    if kind == "review":
        roots = torch.as_tensor(BD.spec_to_state(REVIEW_SPEC, 2, 0),
                                device="cuda")[None]
    else:
        roots = E.initial_state(cfg, B, g, device="cuda")
    search = M.build_search(
        M.MCTSConfig(num_sims=S, stats_dtype=stats_dtype, **kw), 2,
        A.make_eval_fn(A.net_config_for(cfg)), A.make_search_step_fn(cfg),
        A.make_valid_fn(cfg), device="cuda")
    return search, _r6_net(cfg, "cuda"), roots, g


def _check_descent_search(B, S, kind, every, stats_dtype="auto"):
    """One search of ``DESCENT_SHAPES`` whose every descent runs the kernel
    and the plain version (with the search's level bound) on the same tree,
    held equal in every output.  Returns the trees of every ``every``-th
    sim and the last, with their arguments and the kernel's depths, and
    the largest difference."""
    from alphazero_tpu_torch.ops import descent as D
    from alphazero_tpu_torch.search import mcts as M
    search, net, roots, g = _descent_search(B, S, kind, stats_dtype)
    kept, worst, calls = [], [0.0], [0]

    def checked(cfg, stats, i, cap, levels):
        got = D.select(cfg, stats, i, cap, levels)
        want = D.select_plain(cfg, stats, i, cap, levels)
        worst[0] = max(worst[0], _outputs_diff(got, want))
        calls[0] += 1
        if i % every == 0 or i == S - 1:
            kept.append((cfg, stats.clone(), i, cap, levels, got[3].clone()))
        return got
    with _installed(M, _select=checked):
        search(net, roots, generator=g)
        _sync()
    if calls[0] != S:
        raise AssertionError(f"{calls[0]} descents for {S} simulations")
    return kept, worst[0]


def _chase(nxt, steps):
    """``ops/csrc/l2_chase.cu``: one thread follows ``steps`` links of the
    index chain ``nxt`` (int32 on the card, every entry an index of it)."""
    import ctypes
    import torch
    from alphazero_tpu_torch.ops import _build
    launch = _build.load("l2_chase").l2_chase_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
    sink = torch.empty(1, dtype=torch.int32, device=nxt.device)
    err = launch(nxt.data_ptr(), steps, sink.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"l2_chase launch failed: CUDA error {err}")


def _l2_latency_ms():
    """One dependent L2 load on this card, in ms: ``_chase`` over a random
    cycle through 2**20 int32 (4 MB, well inside the 50 MB L2, walked once
    before) for 2**17 links, timed with CUDA events (one launch of ~20 ms:
    the launch's own cost is lost in it); median of 3."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(3)
    N, steps = 1 << 20, 1 << 17
    perm = torch.randperm(N, generator=g, device="cuda")
    nxt = torch.empty(N, dtype=torch.int32, device="cuda")
    nxt[perm] = perm.roll(-1).int()
    _chase(nxt, N)
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _chase(nxt, steps)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / steps


def _noop():
    """``ops/csrc/l2_chase.cu``'s empty kernel, launched once; ``_noop.
    launches`` counts the launches, as a kernel wrapper's count does."""
    import ctypes
    import torch
    from alphazero_tpu_torch.ops import _build
    launch = _build.load("l2_chase").noop_launch
    launch.argtypes = [ctypes.c_void_p]
    err = launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"noop launch failed: CUDA error {err}")
    _noop.launches += 1


_noop.launches = 0


def _launch_floor_ms():
    """The device time of an empty kernel (``_noop``), timed as
    ``_descent_times`` times the descent: the median over 5 profiled calls
    of 64 launches."""
    def calls():
        for _ in range(64):
            _noop()
    return _device_ms(calls, "noop_kernel", per_call=64, counter=_noop)


def _descent_times(kept, l2_ms, reps=5, launches=64):
    """The kernel's device ms per launch on the kept trees and its
    synchronized host ms per ``select`` call (median of 3 calls of 64+
    launches each), the plain version's device ms and synchronized host ms
    per call, and the least time ``bound_ms``, the largest of three: bytes
    (per board, per level visited, the three edge lanes, three node scalars
    and the child pointer read, in the stats' dtype, and the outputs
    written once) and 6 float operations per edge visited at the peaks of
    ``h100bench/peaks.py`` (those two are ``work_bound_ms``, the kernels
    line's bound), and the latency floor, one dependent L2 load per level
    of the deepest path; means over the kept launches."""
    from alphazero_tpu_torch.ops import descent as D
    n = len(kept)
    # the profiler may lose a tenth of the records of one profiled call, so
    # each call launches the kernel on the kept trees in turn ``launches``
    # times or more
    rounds = -(-launches // n)

    def kernel():
        for _ in range(rounds):
            for cfg, st, i, cap, lv, _ in kept:
                D.select(cfg, st, i, cap, lv)

    def plain():
        for cfg, st, i, cap, lv, _ in kept:
            D.select_plain(cfg, st, i, cap, lv)
    out = {"ms": _device_ms(kernel, "descent_kernel", per_call=rounds * n,
                            counter=D.select, reps=reps),
           "host_ms": _time_host_ms(kernel, reps=3) / (rounds * n),
           "plain_ms": _device_ms(plain, warmup=1, per_call=n, reps=reps),
           "plain_host_ms": _time_host_ms(plain, reps=3) / n}
    nbytes = ops = floor = levels = deepest = 0.0
    for _, st, _, cap, _, depth in kept:
        B, A, e = st.shape[0], st.shape[3] - 2, st.element_size()
        lv, dp = int(depth.sum()), int(depth.max())
        nbytes += lv * (3 * A + 4) * e + B * (4 * 8 + 4 + 3 * cap * 4)
        ops += lv * A * 6
        floor += dp * l2_ms
        levels += lv / B
        deepest = max(deepest, dp)
    work_ms, work_by = _bound(nbytes / n, ops / n)
    bound_ms, bound_by = max((work_ms, work_by), (floor / n, "latency"))
    out.update(bound_ms=bound_ms, bound_by=bound_by, work_bound_ms=work_ms,
               work_bound_by=work_by, bytes=nbytes / n,
               latency_floor_ms=floor / n, mean_levels=levels / n,
               deepest=deepest, launches_timed=n)
    return out


def _descent_kernel_phase(g):
    """The descent kernel against ``select_plain`` on the card: made-up
    trees, then every simulation of a search at each of ``DESCENT_SHAPES``;
    its device time at those shapes beside its bound and the plain
    version's times."""
    import torch
    from alphazero_tpu_torch.ops import descent as D
    dev = torch.device("cuda")
    worst, capped, n_cases = 0.0, 0, 0
    for cfg, st, sim, cap in _made_up_trees(g, dev):
        got = D.select(cfg, st, sim, cap, cap)
        want = D.select_plain(cfg, st, sim, cap, cap)
        worst = max(worst, _outputs_diff(got, want))
        capped += int((got[3] == cap).sum()) if cap else 0
        n_cases += 1
    print(f"descent made-up trees ({n_cases} cases, {capped} boards at their "
          f"depth cap): max |kernel - plain| = {worst:.3g} over all outputs",
          flush=True)
    if worst != 0.0:
        raise AssertionError(f"descent made-up case disagrees: {worst}")
    l2_ms = _l2_latency_ms()
    floor_ms = _launch_floor_ms()
    print(f"dependent L2 load latency {l2_ms * 1e6:.1f} ns (l2_chase over "
          f"2**17 links); launch floor {floor_ms * 1e3:.3f} us (the device "
          f"time of an empty kernel, median of 5 calls of 64)", flush=True)
    shapes, err = {}, worst
    for B, S, kind, every in DESCENT_SHAPES:
        kept, e = _check_descent_search(B, S, kind, every)
        M_ = kept[0][1].shape[1]
        print(f"descent replay {kind} B={B} M={M_} depth cap {kept[0][3]}: "
              f"{S} sims held to plain, max |kernel - plain| = {e:.3g}",
              flush=True)
        if e != 0.0:
            raise AssertionError(f"descent replay B={B} disagrees: {e}")
        err = max(err, e)
        t = shapes[f"B{B}_M{M_}"] = _descent_times(kept, l2_ms)
        print(f"descent B={B} M={M_}: kernel {t['ms'] * 1e3:.3f} us/launch "
              f"(bound {t['bound_ms'] * 1e3:.4f} us by {t['bound_by']}: "
              f"{t['bytes']:.0f} bytes and their operations "
              f"{t['work_bound_ms'] * 1e3:.4f} us, {t['work_bound_by']}; "
              f"latency floor {t['latency_floor_ms'] * 1e3:.4f} us at "
              f"{t['deepest']:.0f} levels deepest; mean levels "
              f"{t['mean_levels']:.3f}; launch floor "
              f"{floor_ms * 1e3:.3f} us), kernel host "
              f"{t['host_ms'] * 1e3:.1f} us per select call, plain "
              f"device {t['plain_ms'] * 1e3:.1f} us, host "
              f"{t['plain_host_ms'] * 1e3:.1f} us per call", flush=True)
        del kept
        torch.cuda.empty_cache()
    main = shapes["B1024_M65"]
    return dict(max_abs_err=err, made_up_cases=n_cases, capped=capped,
                l2_latency_ms=l2_ms, launch_floor_ms=floor_ms,
                shapes=shapes, **{
                    k: main[k] for k in ("ms", "plain_ms", "work_bound_ms",
                                         "work_bound_by", "latency_floor_ms")})


# the in-tree transition's checks: the CPU test's configs
# (tests/test_torch_port_env_step.py), the playout plies whose states are
# kept (past round 127 from ply 128 on), and the timed batch sizes
ENV_STEP_CONFIGS = (
    dict(num_players=2), dict(num_players=3), dict(num_players=4),
    dict(num_players=2, enable_noble_select=True),
    dict(num_players=4, enable_noble_select=True, token_limit=8),
    dict(num_players=3, enable_reserve=False),
    dict(num_players=2, enable_giveback=False))
ENV_STEP_KEEP = (3, 40, 90, 135, 180, 230)
ENV_STEP_SHAPES = (1024, 256, 64, 1)


def _env_step_playouts(num_players, g, boards=64, per_ply=2):
    """States of playouts on the card (the port's env, its default rules at
    ``num_players``, chance on, a random legal action per board that buys
    when a coin says so), each in the mover's canonical frame: ``per_ply``
    boards at each ply of ``ENV_STEP_KEEP``."""
    import torch
    from alphazero_tpu_torch.games.splendor import env as E
    cfg = E.SplendorConfig(num_players=num_players)
    s = E.initial_state(cfg, boards, g, device="cuda")
    buy = torch.zeros(409, dtype=torch.bool, device="cuda")
    buy[:12] = buy[27:30] = True
    kept = []
    for t in range(max(ENV_STEP_KEEP) + 1):
        valid = E.valid_moves(cfg, s, 0)
        coin = torch.rand((boards, 1), generator=g, device="cuda") < 0.6
        score = torch.rand((boards, 409), generator=g, device="cuda")
        a = torch.where(valid, score + (buy & coin), -1.0).argmax(1)
        u = torch.rand((boards, 2), generator=g, device="cuda")
        s, nxt = E.step(cfg, s, a, 0, u, False)
        s = E.swap_players(cfg, s, nxt)
        if t in ENV_STEP_KEEP:
            kept.append(s[:per_ply])
    return torch.cat(kept)


def _pending_nobles(cfg, state, flags=(0, 1)):
    """``state`` with made-up nobles (two for the default ``flags``, else
    three) and the pending-choice flags of ``flags`` set; the default is
    as two nobles earned at once leave it (the CPU test's made-up state)."""
    import torch
    s = state.clone()
    rn = cfg.row_nobles
    s[rn:rn + cfg.num_nobles] = 0
    n = 2 if flags == (0, 1) else 3
    s[rn:rn + n, :5] = torch.tensor([[3, 3, 3, 0, 0], [0, 0, 4, 4, 0],
                                     [0, 3, 3, 3, 0]][:n], dtype=torch.int8)
    s[rn:rn + n, 6] = 3
    for i in flags:
        s[rn + i, 5] = 1
    return s


def _step_diff(got, want):
    """The largest |kernel - plain| over the transition's four outputs; the
    terminal vectors are compared bit for bit (differing bits of equal
    values count as inf)."""
    import torch
    worst = 0.0
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            return float("inf")
        if a.dtype == torch.float32:
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                worst = max(worst, (a - b).abs().max().item() or float("inf"))
        elif not torch.equal(a, b):
            worst = max(worst, (a.long() - b.long()).abs().max().item())
    return worst


def _env_step_players_inputs(states, num_players, g, B=1024, n=8):
    """``n`` transitions of ``B`` boards at ``num_players`` players (default
    rules): boards drawn from the playout ``states``, each with a random
    legal action, as a search's would be."""
    import torch
    from alphazero_tpu_torch.games.splendor import env as E
    cfg = E.SplendorConfig(num_players=num_players)
    ins = []
    for _ in range(n):
        pick = torch.randint(0, states.shape[0], (B,), generator=g,
                             device="cuda")
        s = states[pick].contiguous()
        score = torch.rand((B, 409), generator=g, device="cuda")
        a = torch.where(E.valid_moves(cfg, s, 0), score, -1.0).argmax(1)
        ins.append((s, a))
    return cfg, ins


def _env_step_search_inputs(every=8):
    """The transition's inputs in every ``every``-th simulation of one
    main-path search (B=1024, S=64, r6), recorded by the search's step
    function as the search runs."""
    from alphazero_tpu_torch.ops import env_step as ES
    kept, calls = [], [0]

    def recording(cfg, states, actions):
        if calls[0] % every == 0:
            kept.append((states.clone(), actions.clone()))
        calls[0] += 1
        return ES.search_step(cfg, states, actions)
    cfg, net, search, roots, g = _main_search(step=recording)
    search(net, roots, generator=g)
    _sync()
    if calls[0] != 64:
        raise AssertionError(f"{calls[0]} transitions in a search of 64 sims")
    return cfg, kept


def _env_step_times(cfg, ins, reps=5, launches=64):
    """The kernel's device ms per launch on the inputs ``ins`` (median of
    ``reps`` profiled calls of 64+ launches) and its wrapper's synchronized
    host ms per call, the plain version's device and host ms per call, and
    the least time: the bytes one launch must move (``h100bench.work.
    env_step_bytes``) at the peak of ``h100bench/peaks.py``.  The
    operations are integer compares and adds, for which the table of peaks
    has no rate, so they give no bound."""
    from alphazero_tpu_torch.ops import env_step as ES
    n = len(ins)
    rounds = -(-launches // n)

    def kernel():
        for _ in range(rounds):
            for s, a in ins:
                ES.search_step(cfg, s, a)

    def plain():
        for s, a in ins:
            ES.search_step_plain(cfg, s, a)
    nbytes = env_step_bytes(ins[0][0].shape[0], cfg.num_players)
    return {"ms": _device_ms(kernel, "env_step_kernel", per_call=rounds * n,
                             counter=ES.search_step, reps=reps),
            "host_ms": _time_host_ms(kernel, reps=3) / (rounds * n),
            "plain_ms": _device_ms(plain, warmup=1, per_call=n, reps=reps),
            "plain_host_ms": _time_host_ms(plain, reps=3) / n,
            "bytes": nbytes, "bound_ms": nbytes / peaks.HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def _env_step_kernel_phase(g, floor_ms):
    """The env-step kernel against ``search_step_plain`` on the card, byte
    for byte: playout states x all 409 actions on every config of
    ``ENV_STEP_CONFIGS`` (made-up pending noble choices added under noble
    select), then every 8th simulation's transition of the main path's
    search; its device time at ``ENV_STEP_SHAPES`` (boards of that search)
    and at B=1024 on 3- and 4-player playout states with legal actions
    (held to plain too) beside its bound and the launch floor
    ``floor_ms``, and the plain version's device and host times."""
    import torch
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.ops import env_step as ES
    t0 = time.perf_counter()
    # 64 boards kept per ply: the first 2 are the checked states, all of
    # them the pool the 3- and 4-player timings draw from
    play = {p: _env_step_playouts(p, g, per_ply=64) for p in (2, 3, 4)}
    states = {p: s.view(len(ENV_STEP_KEEP), 64, *s.shape[1:])[:, :2]
              .reshape(-1, *s.shape[1:]) for p, s in play.items()}
    worst, boards = 0.0, 0
    for kw in ENV_STEP_CONFIGS:
        cfg = E.SplendorConfig(**kw)
        st = states[cfg.num_players]
        if cfg.enable_noble_select:
            # pending choices of two nobles, and of one, three, and the
            # first and third (not reached by play; the kernel reads the
            # flags' running count)
            st = torch.cat([st] + [
                _pending_nobles(cfg, st[4 + i], flags)[None]
                for i, flags in enumerate(((0, 1), (0,), (0, 1, 2),
                                           (0, 2)))])
        rounds = st[:, 0, 6].int() & 0xFF
        if not bool((rounds > 127).any()):
            raise AssertionError(f"env_step {kw}: no state past round 127")
        n = st.shape[0]
        inputs = st.repeat_interleave(409, 0)
        actions = torch.arange(409, device="cuda").repeat(n)
        e = _step_diff(ES.search_step(cfg, inputs, actions),
                       ES.search_step_plain(cfg, inputs, actions))
        _sync()
        boards += inputs.shape[0]
        worst = max(worst, e)
        print(f"env_step {kw}: {n} playout states x 409 actions = "
              f"{inputs.shape[0]} boards (rounds up to {int(rounds.max())}, "
              f"{int((rounds > 127).sum())} states past 127): max |kernel - "
              f"plain| = {e:.3g} over the four outputs", flush=True)
    if worst != 0.0:
        raise AssertionError(f"env_step kernel disagrees: {worst}")
    del states
    cfg, kept = _env_step_search_inputs()
    replay = max(_step_diff(ES.search_step(cfg, s, a),
                            ES.search_step_plain(cfg, s, a))
                 for s, a in kept)
    print(f"env_step replay of the search B=1024 S=64: {len(kept)} "
          f"transitions (every 8th sim) held to plain, max |kernel - plain| "
          f"= {replay:.3g}", flush=True)
    if replay != 0.0:
        raise AssertionError(f"env_step replay disagrees: {replay}")
    shapes = {}
    for B in ENV_STEP_SHAPES:
        ins = [(s[:B].contiguous(), a[:B].contiguous()) for s, a in kept]
        t = shapes[f"B{B}"] = _env_step_times(cfg, ins)
        print(f"env_step B={B}: kernel {t['ms'] * 1e3:.3f} us/launch (bound "
              f"{t['bound_ms'] * 1e3:.4f} us by bytes: {t['bytes']} bytes; "
              f"launch floor {floor_ms * 1e3:.3f} us), kernel host "
              f"{t['host_ms'] * 1e3:.1f} us per search_step call, plain "
              f"device {t['plain_ms'] * 1e3:.1f} us, host "
              f"{t['plain_host_ms'] * 1e3:.1f} us per call", flush=True)
    for p in (3, 4):
        pcfg, ins = _env_step_players_inputs(play[p], p, g)
        e = max(_step_diff(ES.search_step(pcfg, s, a),
                           ES.search_step_plain(pcfg, s, a)) for s, a in ins)
        if e != 0.0:
            raise AssertionError(f"env_step {p} players disagrees: {e}")
        t = shapes[f"P{p}_B1024"] = _env_step_times(pcfg, ins)
        print(f"env_step {p} players B=1024 (playout states, legal "
              f"actions, held to plain: max |kernel - plain| = {e:.3g}): "
              f"kernel {t['ms'] * 1e3:.3f} us/launch (bound "
              f"{t['bound_ms'] * 1e3:.4f} us by bytes: {t['bytes']} bytes; "
              f"launch floor {floor_ms * 1e3:.3f} us), plain device "
              f"{t['plain_ms'] * 1e3:.1f} us", flush=True)
    del play
    main = shapes["B1024"]
    seconds = time.perf_counter() - t0
    print(f"env_step phase {seconds:.1f} s", flush=True)
    return dict(max_abs_err=max(worst, replay), boards_checked=boards,
                replayed=len(kept), launch_floor_ms=floor_ms, shapes=shapes,
                seconds=seconds, **{k: main[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by")})


def _r6_net(cfg, device, dtype="float32"):
    """r6's net, its trunk in ``dtype`` (the weights stay float32)."""
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.models import splendor_net as N
    from alphazero_tpu_torch.utils import checkpoint as C
    net = C.load_net(os.path.join(ROOT, "runs", "r6", "best.pt"), cfg,
                     device)[0]
    if dtype == "float32":
        return net
    other = N.build_net(A.net_config_for(cfg, dtype=dtype), device)
    other.load_state_dict(net.state_dict())
    return other


def _zero_launches():
    """Set the search kernels' launch counts to 0."""
    from alphazero_tpu_torch.ops import descent as D
    from alphazero_tpu_torch.ops import env_step as ES
    from alphazero_tpu_torch.ops import fused_backup as FB
    FB.fused_backup.launches = D.select.launches = 0
    ES.search_step.launches = 0


def _descents():
    from alphazero_tpu_torch.ops import descent as D
    return D.select.launches


def _steps():
    from alphazero_tpu_torch.ops import env_step as ES
    return ES.search_step.launches


def _counts():
    """The backup, descent and env-step launch counts."""
    from alphazero_tpu_torch.ops import fused_backup as FB
    return FB.fused_backup.launches, _descents(), _steps()


def _check_launches(what, sims, backups, descents, steps):
    """One backup, one descent and one env-step launch per simulation
    ``what`` ran."""
    if backups != sims or descents != sims or steps != sims or sims == 0:
        raise AssertionError(f"{what}: {backups} backup, {descents} descent "
                             f"and {steps} env-step launches for {sims} "
                             f"simulations")


def _run_checked_search(cfg, net, search, roots, g, S, what, reps=1):
    """One warm-up search, then ``reps`` timed searches with the launch
    counts set to 0 just before them; checks that every board's root visits
    sum to ``S`` with none on an invalid action, that q is finite, that the
    results are float32, and one backup and one descent launch per
    simulation.  Returns the last result, each search's seconds and the
    backup, descent and env-step launches."""
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    search(net, roots, generator=g)                       # warm-up
    _sync()
    _zero_launches()
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        res = search(net, roots, generator=g)
        _sync()
        times.append(time.perf_counter() - t0)
    launches, descents, steps = _counts()
    raw = res.raw_counts
    valid = A.make_valid_fn(cfg)(roots)
    if not bool((raw.sum(1) == S).all()):
        raise AssertionError(f"{what}: root visit counts do not sum to "
                             f"num_sims")
    if bool((raw * ~valid).any()):
        raise AssertionError(f"{what}: visits on invalid root actions")
    if not bool(torch.isfinite(res.q).all()):
        raise AssertionError(f"{what}: non-finite root q")
    if not res.q.dtype == res.counts.dtype == torch.float32:
        raise AssertionError(f"{what}: results are {res.q.dtype}, "
                             f"{res.counts.dtype}")
    _check_launches(what, reps * S, launches, descents, steps)
    return res, times, launches, descents, steps


def phase_search(reps=5):
    """The main path's search, checked and timed (``_run_checked_search``),
    one profiled search, and a search with the plain step
    (``search_step_plain`` as its step function) equal in visit counts to
    one with the kernel from the same roots, net and root noise."""
    import torch
    from alphazero_tpu_torch.ops import env_step as ES
    B, S = 1024, 64
    cfg, net, search, roots, g = _main_search(B=B, S=S)
    _, times, launches, descents, steps = _run_checked_search(
        cfg, net, search, roots, g, S, "search", reps)
    rps = B * S / statistics.median(times)
    print(f"search B={B} S={S}: {rps:.1f} rollouts/s (median of {reps}, "
          f"{statistics.median(times) * 1e3:.1f} ms/search); backup launches "
          f"{launches}, descent launches {descents}, env-step launches "
          f"{steps}", flush=True)
    prof = _profile(lambda: search(net, roots, generator=g), host=True)
    spans = ", ".join(f"{k} {v:.1f}" for k, v in
                      sorted(prof["spans_host_ms"].items()))
    print(f"search profile: wall {prof['wall_ms']:.1f} ms; host ms per span: "
          f"{spans}; device busy {prof['device_busy_ms']} ms, idle share "
          f"{prof['device_idle_share']}, {prof['kernel_launches']} kernels "
          f"({prof['kernel_launches'] / S:.2f} per simulation)", flush=True)
    plain = _main_search(B=B, S=S, step=ES.search_step_plain)[2]
    counts = []
    for run, want in ((plain, 0), (search, S)):
        before = _steps()
        counts.append(run(net, roots, generator=torch.Generator(
            device="cuda").manual_seed(5)).raw_counts)
        if _steps() - before != want:
            raise AssertionError(f"{_steps() - before} env-step launches in "
                                 f"a search, not {want}")
    if not torch.equal(*counts):
        raise AssertionError("the searches with the plain step and with the "
                             "kernel gave different visit counts")
    print(f"search B={B} S={S}: visit counts equal with the plain step and "
          f"with the env_step kernel", flush=True)
    return {"rollouts_per_s": rps, "search_ms": statistics.median(times) * 1e3,
            "launches": launches, "descents": descents, "steps": steps,
            "reps": reps, "batch": B, "sims": S, "times_s": times,
            "profile": prof}


class _MaskedVisits(logging.Handler):
    """Counts the root visits the self-play actor's backstop masked (its
    "masking N root visits" warning)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.visits = 0

    def emit(self, record):
        if record.getMessage().startswith("masking"):
            self.visits += int(record.args[0])


def _selfplay_engine(tree_reuse, moves, stats_dtype="auto"):
    """The self-play actor at B=256, 128 sims, PCR 4 / 0.25 and forced
    playouts, for ``moves`` moves."""
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.train import selfplay as SP
    cfg = E.SplendorConfig(num_players=2)
    sp = SP.SelfPlayConfig(batch_size=256, num_sims=128, ratio_full=4,
                           prob_full=0.25, temp_threshold=10,
                           forced_playouts=True, max_moves=moves,
                           chunk_moves=moves, tree_reuse=tree_reuse,
                           stats_dtype=stats_dtype)
    return cfg, SP.SelfPlayEngine(cfg, A.make_eval_fn(A.net_config_for(cfg)),
                                  sp, device="cuda")


def _check_reuse_selfplay(net, moves=4):
    """Self-play with ``tree_reuse=True`` for ``moves`` moves, its searches'
    backups recorded (a spread of launches at each shape, per-board slots
    from the second move on) and held exactly to the plain version; one
    launch per simulation.  Returns the largest difference."""
    import torch
    samples, sims = {}, [0]
    with _checked_path(sims, samples) as calls:
        _, eng = _selfplay_engine(True, moves)
        _zero_launches()
        eng.run_games(net, torch.Generator(device="cuda").manual_seed(2))
        _sync()
        launches, descents, steps = _counts()
    _check_launches("reuse self-play", sims[0], launches, descents, steps)
    err, differing = _check_recorded(samples, calls, "reuse self-play")
    if differing == 0:
        raise AssertionError("no recorded reuse self-play backup had slots "
                             "that differ across boards")
    if not any(r[2] for r in calls["descent"].values()):
        raise AssertionError("no checked reuse self-play descent ran on a "
                             "carried tree")
    return err


def phase_selfplay(tree_reuse=False, stats_dtype="auto"):
    """The self-play actor at B=256, 128 sims, PCR 4 / 0.25 and forced
    playouts for 12 moves with the r6 net: rollouts/s, examples, launches
    (one per simulation its searches ran), masked root visits and peak
    device memory; with ``tree_reuse``, first a checked 4-move run
    (``_check_reuse_selfplay``), and the share of reroots (boards x moves)
    that kept more than the root."""
    import torch
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.train import selfplay as SP
    moves = 12                       # no 2-player game ends within 12 moves
    net = _r6_net(E.SplendorConfig(num_players=2), "cuda")
    backup_err = _check_reuse_selfplay(net) if tree_reuse else 0.0
    sims, hits = [0], []
    with _checked_path(sims):
        cfg, eng = _selfplay_engine(tree_reuse, moves, stats_dtype)
    if tree_reuse:
        reroot = eng.rs_full.reroot

        def counted(*args):
            tree, n = reroot(*args)
            hits.append((n > 1).sum())
            return tree, n
        eng.rs_full = eng.rs_full._replace(reroot=counted)
    masked = _MaskedVisits()
    SP.log.addHandler(masked)
    try:
        _zero_launches()
        _sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        it, stats = eng.run_games(net, torch.Generator(device="cuda")
                                  .manual_seed(2))
        _sync()
        dt = time.perf_counter() - t0
        launches, descents, steps = _counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        SP.log.removeHandler(masked)
    _check_launches(f"self-play, {moves} moves", sims[0], launches, descents,
                    steps)
    if masked.visits:
        raise AssertionError(f"{masked.visits} root visits on invalid "
                             f"actions were masked")
    n = len(it)
    if n != moves * eng.b_full or stats["examples"] != n:
        raise AssertionError(f"{n} examples, expected {moves * eng.b_full}")
    pi = it.pi.astype("float32")
    if not (abs(pi.sum(1) - 1.0) < 2e-3).all() or (it.pi[~it.valids] != 0).any():
        raise AssertionError("policy targets are not distributions over "
                             "valid actions")
    if it.boards.shape != (n, cfg.rows, 7) or it.winner.shape != (n, 2):
        raise AssertionError("Iteration shapes")
    rec = {"rollouts_per_s": stats["rollouts"] / dt, "seconds": dt,
           "examples": n, "rollouts": stats["rollouts"], "launches": launches,
           "descents": descents, "steps": steps,
           "simulations": sims[0], "masked_visits": masked.visits,
           "peak_bytes": peak, "backup_max_abs_err": backup_err}
    if tree_reuse:
        B = eng.cfg.batch_size
        rec["hit_share"] = int(sum(hits)) / (moves * B)
        if len(hits) != moves or rec["hit_share"] <= 0:
            raise AssertionError(f"{len(hits)} reroots, hit share "
                                 f"{rec['hit_share']}")
    print(f"self-play B=256 S=128 PCR{' tree reuse' if tree_reuse else ''}"
          f"{' bf16 stats' if stats_dtype == 'bfloat16' else ''}: "
          f"{rec['rollouts_per_s']:.1f} rollouts/s, {n} examples in "
          f"{dt:.2f} s; backup, descent and env-step launches {launches} = "
          f"simulations {sims[0]}; "
          f"masked root visits {masked.visits}; peak memory "
          f"{peak / 2**30:.3f} GiB"
          + (f"; reuse hit share {rec['hit_share']:.4f}" if tree_reuse
             else ""), flush=True)
    return rec, it


def _bf16_chain_tree(dev):
    """bf16 stats of 63 boards of 65 nodes whose every board descends
    through every node, each level picking column A - 1: with B * M odd
    the tensor's last row begins on a 16-byte boundary and ends 8 bytes
    past one, and on every even row the pick's value sum lies in those
    last 8 bytes, which the kernel reads beside its bulk copy."""
    import torch
    from alphazero_tpu_torch.ops import descent as D
    from alphazero_tpu_torch.search import mcts as M
    B, Mx, A = 63, 65, 409
    st = torch.zeros((B, Mx, 4, A + 2), device=dev)
    st[:, :, D.PVALID, :A] = 0.25
    st[:, :, D.CHILD, :A] = torch.arange(1, Mx + 1, device=dev)[None, :, None]
    st[:, -1, D.CHILD, :A] = 0.0
    st[:, :, D.EN, A - 1] = 1.0
    st[:, :, D.EW, A - 1] = 5.0
    st[:, :, D.EN, A] = 4.0
    st[:, :, D.EW, A] = 1.0
    return M.MCTSConfig(cpuct=1.25, fpu=0.2), st.to(torch.bfloat16), 3, Mx


def _bf16_kernel_checks(g, dev):
    """Both bf16 kernels against their plain versions on made-up inputs:
    the descent on ``_made_up_trees`` in bf16 and ``_bf16_chain_tree``, the
    backup entry on ``_made_up_entry_args`` in bf16.  Returns the largest
    differences and raises unless both are 0."""
    import torch
    from alphazero_tpu_torch.ops import descent as D
    from alphazero_tpu_torch.ops import fused_backup as FB
    worst_d, n = 0.0, 0
    cases = [(cfg, st.to(torch.bfloat16), sim, cap)
             for cfg, st, sim, cap in _made_up_trees(g, dev)]
    cases.append(_bf16_chain_tree(dev))
    for cfg, st, sim, cap in cases:
        got = D.select(cfg, st, sim, cap, cap)
        want = D.select_plain(cfg, st, sim, cap, cap)
        worst_d = max(worst_d, _outputs_diff(got, want))
        n += 1
    A = cases[-1][1].shape[3] - 2
    chain_ok = bool((got[1] == A - 1).all() and (got[3] == cap).all())
    worst_b = 0.0
    for B, A, P, slot in ((512, 409, 2, 7), (512, 409, 3, "per_board"),
                          (512, 409, 4, 1), (64, 2101, 2, "per_board")):
        args = list(_made_up_entry_args(B, 40, A, 70, P, g, dev, slot))
        args[0] = args[0].to(torch.bfloat16)
        want = FB.backprop_packed_plain(args[0].clone(), *args[1:])
        got = FB.backprop_packed(args[0].clone(), *args[1:])
        if not torch.equal(got, want):
            worst_b = max(worst_b, (got.float() - want.float()).abs().max()
                          .item())
    _sync()
    # a bf16 tensor the kernels cannot take (not 16-byte aligned) raises:
    # no fallback to the plain version
    cfg, st, sim, cap = cases[-1]
    shifted = torch.empty(st.numel() + 8, dtype=st.dtype, device=dev)[1:]
    shifted = shifted[:st.numel()].view(st.shape)
    refused = 0
    for call in (lambda: D.select(cfg, shifted, sim, cap, cap),
                 lambda: FB.backprop_packed(
                     shifted, *_made_up_entry_args(
                         st.shape[0], st.shape[1], st.shape[3] - 2, 4, 2, g,
                         dev, 1)[1:])):
        launched = D.select.launches + FB.fused_backup.launches
        try:
            call()
        except ValueError:
            refused += launched == D.select.launches + FB.fused_backup.launches
    if refused != 2:
        raise AssertionError("a misaligned bf16 tensor was not refused")
    print(f"bf16 made-up: descent {n} cases (the last a chain to the "
          f"tensor's last row, picks from the rows' last 8 bytes: "
          f"{chain_ok}), max |kernel - plain| = {worst_d:.3g}; backup entry "
          f"on 4 made-up cases, max |kernel - plain| = {worst_b:.3g}; a "
          f"misaligned bf16 tensor refused by both wrappers", flush=True)
    if worst_d != 0.0 or worst_b != 0.0 or not chain_ok:
        raise AssertionError(f"bf16 made-up cases disagree: descent "
                             f"{worst_d}, backup {worst_b}, chain {chain_ok}")
    return worst_d, worst_b


def _bf16_backup_replay(B, S, timed=True):
    """Every backup of a bf16 search at ``B`` boards and ``S`` sims replayed
    on the stats the last one found, by the kernel and the plain version,
    held equal; then, if ``timed``, the entry's device time per launch
    beside its bound, the plain version's and ``index_put_``'s (medians of
    3 profiled calls)."""
    import torch
    from alphazero_tpu_torch.ops import fused_backup as FB
    base, raws = _search_backup_args(B=B, S=S, stats_dtype="bfloat16")
    if base.dtype != torch.bfloat16:
        raise AssertionError(f"a bf16 search's stats are {base.dtype}")
    got, want, err = base.clone(), base.clone(), 0.0
    for raw in raws:
        FB.backprop_packed(got, *raw)
        FB.backprop_packed_plain(want, *raw)
        if not torch.equal(got, want):
            err = max(err, (got.float() - want.float()).abs().max().item())
    if err != 0.0:
        raise AssertionError(f"bf16 backup replay B={B} disagrees: {err}")
    n, st = len(raws), base.clone()
    if not timed:
        print(f"fused_backup entry bf16 B={B} M={S + 1}: {n} sims replayed, "
              f"max |kernel - plain| = {err:.3g} (not timed)", flush=True)
        return dict(max_abs_err=err, sims=n)

    def entry():
        for raw in raws:
            FB.backprop_packed(st, *raw)

    def plain():
        for raw in raws[::16]:
            FB.backprop_packed_plain(st, *raw)
    flat = st.view(-1)
    flats = [_entry_touched(base, *raw)[:2] for raw in raws]

    def library():
        for idx, val in flats:
            flat.index_put_((idx,), val.to(flat.dtype), accumulate=True)
    work = [_entry_work(base, *raw) for raw in raws]
    nbytes, adds = (sum(x[i] for x in work) / n for i in (0, 1))
    bound_ms, bound_by = _bound(nbytes, adds)
    out = dict(max_abs_err=err, sims=n, bytes=nbytes, bound_ms=bound_ms,
               bound_by=bound_by,
               ms=_device_ms(entry, "fused_backup_", per_call=n, reps=3),
               plain_ms=_device_ms(plain, warmup=1, per_call=len(raws[::16]),
                                   reps=3),
               library_ms=_device_ms(library, per_call=n, reps=3))
    print(f"fused_backup entry bf16 B={B} M={S + 1}: {n} sims replayed, max "
          f"|kernel - plain| = {err:.3g}; kernel {out['ms'] * 1e3:.3f} "
          f"us/launch (bound {bound_ms * 1e3:.4f} us, {nbytes:.0f} bytes, "
          f"{bound_by}), plain {out['plain_ms'] * 1e3:.1f} us, index_put_ "
          f"{out['library_ms'] * 1e3:.1f} us", flush=True)
    del base, raws, got, want, st, flat, flats
    torch.cuda.empty_cache()
    return out


# the bf16 replays, (B, S, kind, keep every n-th sim's tree, timed): the
# main path's search and the first two of ``DESCENT_SHAPES``, timed, then
# self-play's two PCR searches (full at B=64, fast at B=192), checked only
BF16_DESCENT_SHAPES = ((1024, 64, "search", 8, True),
                       (256, 128, "selfplay", 16, True),
                       (64, 128, "selfplay", 128, False),
                       (192, 32, "fast", 32, False))
# the bf16 backup replays, (B, S, timed): the main path's search and
# self-play's two PCR shapes
BF16_BACKUP_SHAPES = ((1024, 64, True), (64, 128, True), (192, 32, False))


def _bf16_kernel_phase(g, l2_ms):
    """Both kernels' bf16 instantiations against their plain versions on
    the card: made-up inputs (``_bf16_kernel_checks``), then every
    simulation of bf16 searches at ``BF16_DESCENT_SHAPES`` and
    ``BF16_BACKUP_SHAPES``, the timed ones with their device times beside
    their bounds (medians of 3 profiled calls)."""
    import torch
    t0 = time.perf_counter()
    err_d, err_b = _bf16_kernel_checks(g, torch.device("cuda"))
    descent = {}
    for B, S, kind, every, timed in BF16_DESCENT_SHAPES:
        kept, e = _check_descent_search(B, S, kind, every, "bfloat16")
        if kept[0][1].dtype != torch.bfloat16 or e != 0.0:
            raise AssertionError(f"bf16 descent replay {kind} B={B}: {e}, "
                                 f"{kept[0][1].dtype}")
        err_d = max(err_d, e)
        head = (f"descent bf16 {kind} B={B} M={S + 1}: {S} sims held to "
                f"plain, max |kernel - plain| = {e:.3g}")
        if not timed:
            print(f"{head} (not timed)", flush=True)
            del kept
            continue
        t = descent[f"B{B}_M{S + 1}"] = _descent_times(kept, l2_ms, reps=3,
                                                       launches=128)
        print(f"{head}; kernel {t['ms'] * 1e3:.3f} "
              f"us/launch (bound {t['bound_ms'] * 1e3:.4f} us by "
              f"{t['bound_by']}: {t['bytes']:.0f} bytes, "
              f"{t['work_bound_ms'] * 1e3:.4f} us; latency floor "
              f"{t['latency_floor_ms'] * 1e3:.4f} us; mean levels "
              f"{t['mean_levels']:.3f}), kernel host "
              f"{t['host_ms'] * 1e3:.1f} us per call, plain device "
              f"{t['plain_ms'] * 1e3:.1f} us", flush=True)
        del kept
        torch.cuda.empty_cache()
    backup = {f"B{B}_M{S + 1}": _bf16_backup_replay(B, S, timed)
              for B, S, timed in BF16_BACKUP_SHAPES}
    err_b = max([err_b] + [v["max_abs_err"] for v in backup.values()])
    print(f"bf16 kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    return (dict(max_abs_err=err_d, shapes=descent),
            dict(max_abs_err=err_b, shapes=backup))


def phase_bf16():
    """The main path on bf16 stats (``stats_dtype="bfloat16"``, the JAX
    package's TPU default at the bench shapes): the search at B=1024,
    S=64 and 12 moves of fresh self-play at B=256, S=128, each with one
    descent and one backup launch per simulation.  (Phase 2 holds the bf16
    kernels to their plain versions.)"""
    t_phase = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_phase - sum(marks.values())

    # the main path on bf16 stats: the search, then fresh self-play
    B, S = 1024, 64
    cfg, net, search, roots, g = _main_search(B=B, S=S,
                                              stats_dtype="bfloat16")
    _, times, launches, descents, steps = _run_checked_search(
        cfg, net, search, roots, g, S, "bf16 search")
    search_ms = times[0] * 1e3
    print(f"search bf16 stats B={B} S={S}: {search_ms:.1f} ms; backup "
          f"launches {launches}, descent and env-step launches {descents} = "
          f"simulations "
          f"{S}", flush=True)
    mark("search")
    selfplay, _ = phase_selfplay(stats_dtype="bfloat16")
    mark("self-play")
    seconds = time.perf_counter() - t_phase
    print(f"bf16 phase {seconds:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in marks.items())
          + f" s); backup, descent and env-step launches on its bf16 paths: "
          f"{launches + selfplay['launches']} = simulations "
          f"{S + selfplay['simulations']}", flush=True)
    return dict(search_ms=search_ms,
                launches=launches + selfplay["launches"],
                descents=descents + selfplay["descents"],
                steps=steps + selfplay["steps"], selfplay=selfplay,
                seconds=seconds, seconds_by_step=marks)


def _r6_train_state(net_cfg, device):
    """A train state holding ``runs/r6/best.pt`` (strict) with its Adam
    moments, read by the port's own load chain."""
    from alphazero_tpu_torch.models import splendor_net as N
    from alphazero_tpu_torch.train import trainer as TR
    from alphazero_tpu_torch.utils import checkpoint as C
    state = TR.init_train_state(net_cfg, device=device)
    target, _ = N.to_flax(state.net.state_dict())
    ck = C.load_network(os.path.join(ROOT, "runs", "r6"), "best.pt", target,
                        fallback=False)
    if ck["load_mode"] != "strict":
        raise AssertionError(f"r6 loaded {ck['load_mode']}")
    state.net.load_state_dict(N.from_flax(ck["params"], ck["batch_stats"]))
    return TR.load_opt_state(state, ck["opt_state"])


def _card_vs_cpu_step(cfg, replay, lr=3e-4):
    """One train step from r6 (its Adam moments included) on the same
    batch on the card and on the CPU: fixed symmetry choices, dropout 0.
    Returns the largest parameter difference; raises past the CPU parity
    test's tolerance (atol 1e-5, rtol 1e-4)."""
    import numpy as np
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import symmetry as SYM
    from alphazero_tpu_torch.models import splendor_net as N
    from alphazero_tpu_torch.train import trainer as TR
    from alphazero_tpu_torch.utils.checkpoint import tree_items
    rng = np.random.default_rng(7)
    b = replay.sample(64, rng)
    boards, pi, valids = SYM.apply_symmetry(
        cfg, torch.from_numpy(b["boards"]), torch.from_numpy(b["pi"]),
        torch.from_numpy(b["valids"]), rng.integers(0, 4, (64, 3)),
        rng.integers(0, 3, (64, cfg.num_players)))
    b.update(boards=boards.numpy(), pi=pi.numpy(), valids=valids.numpy())
    net_cfg = A.net_config_for(cfg, dropout=0.0)
    tcfg = TR.TrainConfig(batch_size=64, augment=False)
    params = {}
    for dev in ("cpu", "cuda"):
        st = _r6_train_state(net_cfg, dev)
        st, _ = TR.make_train_step(cfg, net_cfg, tcfg)(
            st, b, lr, 10.0, torch.Generator(device=dev))
        params[dev] = dict(tree_items(N.to_flax(st.net.state_dict())[0]))
    want, got = params["cpu"], params["cuda"]
    err = 0.0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        err = max(err, float(diff.max()))
        if not (diff <= 1e-5 + 1e-4 * np.abs(w)).all():
            raise AssertionError(f"card and CPU step differ at {k}: "
                                 f"{float(diff.max())}")
    return err


def phase_train(it):
    """``fit`` at the r6 model's full width on the self-play examples."""
    import numpy as np
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.train import replay as R
    from alphazero_tpu_torch.train import trainer as TR
    cfg = E.SplendorConfig(num_players=2)
    net_cfg = A.net_config_for(cfg, dropout=0.3, nn_version=1, width=128)
    B, K = 64, 64
    tcfg = TR.TrainConfig(learn_rate=3e-4, vl_weight=10.0, batch_size=B,
                          epochs=1, augment=True)
    replay = R.ReplayBuffer()
    replay.add_iteration(it)
    chunk = TR.make_train_chunk(cfg, net_cfg, tcfg)
    step = TR.make_train_step(cfg, net_cfg, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(5)

    def stacked():
        b = replay.sample(K * B, rng)
        return {k: v.reshape((K, B) + v.shape[1:]) for k, v in b.items()}
    lrs = [TR.onecycle_lr(j, K, tcfg.learn_rate) for j in range(K)]
    chunk(_r6_train_state(net_cfg, "cuda"), stacked(), lrs, 10.0, gen)
    _sync()                                           # warm-up, discarded
    state = _r6_train_state(net_cfg, "cuda")
    step0 = state.step
    t0 = time.perf_counter()
    state, metrics = TR.fit(state, step, replay, tcfg, rng, gen,
                            train_chunk_fn=chunk, chunk_steps=K)
    _sync()
    dt = time.perf_counter() - t0
    steps = state.step - step0
    if steps != K or not np.isfinite(metrics["loss"]):
        raise AssertionError(f"fit took {steps} steps, loss {metrics}")
    batches, out = stacked(), {}
    prof = _profile(lambda: out.update(series=chunk(
        state, batches, lrs, 10.0, gen, per_step=True)[1]), host=True)
    losses = out["series"]["loss"].tolist()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite train losses {losses}")
    err = _card_vs_cpu_step(cfg, replay)
    rec = {"examples_in_replay": len(replay), "steps": steps, "seconds": dt,
           "steps_per_s": steps / dt, "examples_per_s": steps * B / dt,
           "ms_per_step": dt / steps * 1e3, "fit_loss": metrics["loss"],
           "loss_first": losses[0], "loss_last": losses[-1],
           "chunk_profile": prof,
           "kernels_per_step": prof["kernel_launches"] / K,
           "device_busy_ms_per_step": (None if prof["device_busy_ms"] is None
                                       else prof["device_busy_ms"] / K),
           "card_vs_cpu_max_param_diff": err}
    print(f"train fit B={B} K={K} (r6, augment, dropout 0.3) on {len(replay)} "
          f"examples: {rec['steps_per_s']:.1f} steps/s, "
          f"{rec['examples_per_s']:.1f} examples/s, {rec['ms_per_step']:.3f} "
          f"ms/step; chunk loss first {losses[0]:.4f} last {losses[-1]:.4f}; "
          f"profiled chunk: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']} ms, idle share "
          f"{prof['device_idle_share']}, {rec['kernels_per_step']:.1f} "
          f"kernels/step; card vs CPU step max |dparam| {err:.3g}",
          flush=True)
    return rec


def _recording_backup(samples, first=4, every=32, cap=12):
    """``mcts.backprop_packed`` that also keeps, for a spread of its calls at
    each shape ``(B, M, S1)`` (the first ``first``, then every ``every``-th,
    ``cap`` at most), the stats it was given, its arguments and the stats
    the kernel left, in ``samples``.  It launches the kernel once per call,
    as the search's own backup does."""
    import torch
    from alphazero_tpu_torch.ops import fused_backup as FB
    calls = {}

    def record(stats, *args):
        key = (stats.shape[0], stats.shape[1], args[0].shape[1])
        i = calls[key] = calls.get(key, -1) + 1
        kept = samples.setdefault(key, [])
        keep = (i < first or i % every == 0) and len(kept) < cap
        before = stats.clone() if keep else None
        out = FB.backprop_packed(stats, *args)
        if keep:
            kept.append((before, tuple(a.clone() if torch.is_tensor(a) else a
                                       for a in args), out.clone()))
        return out
    return record, calls


def _recording_descent(results, per_search=4, cap=24):
    """``mcts._select`` that launches the kernel once per call, as the
    search's own descent does, and at each shape ``(B, M, depth_cap)`` also
    runs ``select_plain`` on the same stats and arguments for
    ``per_search`` sims spread over each search (sim ``i`` where ``i + 1``
    is a multiple of ``num_sims // per_search``), ``cap`` at most per
    shape, so that later searches (carried trees on a reusing path) are
    checked too.  ``results[shape]`` holds the calls, the checked calls,
    those on a carried tree (a root with more visits than the sim index)
    and the largest difference over the eight outputs."""
    from alphazero_tpu_torch.ops import descent as D

    def select(cfg, stats, i, depth_cap, levels):
        got = D.select(cfg, stats, i, depth_cap, levels)
        r = results.setdefault((stats.shape[0], stats.shape[1], depth_cap),
                               [0, 0, 0, 0.0])
        r[0] += 1
        if (i + 1) % max(1, cfg.num_sims // per_search) == 0 and r[1] < cap:
            want = D.select_plain(cfg, stats, i, depth_cap, levels)
            r[1] += 1
            r[2] += bool((stats[:, 0, D.EN, -2] > i).any())
            r[3] = max(r[3], _outputs_diff(got, want))
        return got
    return select


def _report_descents(results, what):
    """Print ``_recording_descent``'s checks per shape under ``what``;
    raises unless every shape had a checked call and every check was
    equal.  Returns the number of checked calls on carried trees."""
    worst, carried = 0.0, 0
    for (B, M_, cap), (n, k, c, err) in sorted(results.items()):
        print(f"descent in {what}, B={B} M={M_} depth cap {cap}: {k} of {n} "
              f"sims held to select_plain ({c} on carried trees), max "
              f"|kernel - plain| = {err:.3g}", flush=True)
        if k == 0:
            raise AssertionError(f"no descent of {what} checked at B={B} "
                                 f"M={M_}")
        worst, carried = max(worst, err), carried + c
    if worst != 0.0 or not results:
        raise AssertionError(f"the descents of {what}: max |kernel - plain| "
                             f"= {worst} over {len(results)} shapes")
    return carried


def _check_recorded(samples, calls, what):
    """The kept backups of ``_recording_backup`` against the plain version
    on the stats and arguments each call was given, printed per shape under
    ``what``, then the descents ``_checked_path`` checked.  Returns the
    largest difference and the number of kept calls whose slots differ
    across boards; raises unless every difference is 0."""
    import torch
    from alphazero_tpu_torch.ops import fused_backup as FB
    worst, differing = 0.0, 0
    for key, kept in sorted(samples.items()):
        err, diff = 0.0, 0
        for before, raw, got in kept:
            want = FB.backprop_packed_plain(before.clone(), *raw)
            if not torch.equal(got, want):
                err = max(err, (got - want).abs().max().item())
            diff += bool((raw[9] != raw[9][0]).any())
        print(f"fused_backup entry in {what}, B={key[0]} M={key[1]} "
              f"S1={key[2]}: {len(kept)} of {calls[key] + 1} sims held to "
              f"plain ({diff} with slots that differ across boards), max "
              f"|kernel - plain| = {err:.3g}", flush=True)
        worst = max(worst, err)
        differing += diff
    if worst != 0.0:
        raise AssertionError(f"the backups of {what} disagree: {worst}")
    _report_descents(calls["descent"], what)
    return worst, differing


@contextlib.contextmanager
def _checked_path(sims, samples=None):
    """While open, every search that ``mcts.build_search`` or
    ``mcts.build_reusing_search`` builds adds its ``num_sims`` to
    ``sims[0]`` on each call; with ``samples``, the searches' backup is
    ``_recording_backup``'s and their descent ``_recording_descent``'s.
    Yields the backup recorder's call counts, with the descent's checks
    under ``"descent"``."""
    from alphazero_tpu_torch.search import mcts as M
    build, build_rs = M.build_search, M.build_reusing_search

    def counted(fn, n):
        def run(*a, **kw):
            sims[0] += n
            return fn(*a, **kw)
        return run

    def build_counted(mcfg, *a, **kw):
        return counted(build(mcfg, *a, **kw), mcfg.num_sims)

    def build_rs_counted(mcfg, *a, **kw):
        rs = build_rs(mcfg, *a, **kw)
        return rs._replace(run=counted(rs.run, mcfg.num_sims))
    calls, hooks = {}, {}
    if samples is not None:
        hooks["backprop_packed"], calls = _recording_backup(samples)
        calls["descent"] = {}
        hooks["_select"] = _recording_descent(calls["descent"])
    with _installed(M, build_search=build_counted,
                    build_reusing_search=build_rs_counted, **hooks):
        yield calls


def phase_coach(keep_dir):
    """One ``Coach.learn`` iteration on the card from the r6 weights; its
    ``temp.pt`` is copied into ``keep_dir``."""
    import shutil
    import numpy as np
    import torch
    from alphazero_tpu_torch.models import splendor_net as N
    from alphazero_tpu_torch.train.coach import Coach, CoachConfig
    from alphazero_tpu_torch.utils import checkpoint as C
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CoachConfig(num_players=2, num_iters=1, games_per_iter=16,
                          selfplay_batch=16, num_sims=32, ratio_full=4,
                          prob_full=0.25, forced_playouts=True,
                          arena_games=8, gate_num_sims=16, batch_size=64,
                          train_chunk_steps=8, checkpoint_dir=tmp, seed=0)
        sims, stage, seen, samples = [0], {}, {}, {}

        def timed(name, fn):
            def run(*a, **kw):
                _sync()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                _sync()
                stage[name] = time.perf_counter() - t0
                return out
            return run
        with _checked_path(sims, samples) as calls:
            coach = Coach(cfg, device="cuda")
            coach.load_checkpoint(os.path.join(ROOT, "runs", "r6"), "best.pt",
                                  load_examples=False)
            for name in ("self_play_iteration", "train_iteration", "gate"):
                setattr(coach, name, timed(name, getattr(coach, name)))
            _zero_launches()
            coach.learn(on_iteration=lambda it, sp, m, g, acc: seen.update(
                sp=sp, metrics=m, gate=g, accept=acc))
            _sync()
            launches, descents, steps = _counts()
        _check_launches("coach", sims[0], launches, descents, steps)
        # the kernel at the coach's own shapes, against its plain version
        backup_err, _ = _check_recorded(samples, calls, "the coach's searches")
        del samples
        nw, ow, dr = seen["gate"]
        if nw + ow + dr != cfg.arena_games or not np.isfinite(
                seen["metrics"]["loss"]):
            raise AssertionError(f"gate {seen['gate']}, train "
                                 f"{seen['metrics']}")
        # the file written on the card, read on the CPU
        name = "best.pt" if seen["accept"] else "temp.pt"
        ck = C.load_checkpoint(tmp, name)
        cpu_net = N.build_net(coach.net_cfg, "cpu")
        cpu_net.load_state_dict(N.from_flax(ck["params"], ck["batch_stats"]))
        b = coach.replay.sample(64, np.random.default_rng(3))
        boards = torch.from_numpy(b["boards"]).float()
        valids = torch.from_numpy(b["valids"])
        card = N.apply_inference(coach.bundle, boards.cuda(), valids.cuda())
        cpu = N.apply_inference(cpu_net, boards, valids)
        errs = [float((g.cpu() - w).abs().max()) for g, w in zip(card, cpu)]
        sd_ok = ((card[2].cpu() - cpu[2]).abs()
                 <= 1e-5 + 2e-6 * cpu[2].abs()).all()
        if max(errs[:2]) > 1e-5 or not bool(sd_ok):
            raise AssertionError(f"{name}: card vs CPU forward {errs}")
        shutil.copy(os.path.join(tmp, "temp.pt"), keep_dir)
    sp = seen["sp"]
    rec = {"stage_seconds": stage, "examples": sp["examples"],
           "games": sp["games"], "rollouts": sp["rollouts"],
           "rollouts_per_s": sp["rollouts_per_s"], "gate": [nw, ow, dr],
           "accepted": seen["accept"], "train_loss": seen["metrics"]["loss"],
           "simulations": sims[0], "launches": launches,
           "descents": descents, "steps": steps,
           "backup_max_abs_err": backup_err,
           "backup_shapes": {f"B{b}_M{m}_S1{s}": n + 1
                             for (b, m, s), n in sorted(
                                 kv for kv in calls.items()
                                 if kv[0] != "descent")},
           "checkpoint": name, "card_vs_cpu_forward_err": errs}
    print(f"coach 1 iteration: self-play {stage['self_play_iteration']:.2f} s "
          f"({sp['examples']} examples, {sp['rollouts_per_s']:.1f} "
          f"rollouts/s), train {stage['train_iteration']:.2f} s (loss "
          f"{seen['metrics']['loss']:.4f}), gate {stage['gate']:.2f} s "
          f"(new-old-draws {nw}-{ow}-{dr}, "
          f"{'accepted' if seen['accept'] else 'rejected'}); backup, "
          f"descent and env-step launches {launches} = simulations "
          f"{sims[0]}; {name} on "
          f"the CPU: forward "
          f"|card - cpu| {max(errs):.3g}", flush=True)
    return rec


def _reuse_moves(rs, net, roots, moves, on_reroot=None):
    """``moves`` moves of a reusing search from fresh trees at ``roots``:
    run, argmax action, its in-tree next state, reroot.  ``on_reroot(move,
    tree, actions, next_states)`` may time or check a reroot (it must not
    change the tree).  Returns the per-move n_kept and run seconds."""
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    step_fn = A.make_search_step_fn(E.SplendorConfig(num_players=2))
    g = torch.Generator(device="cuda").manual_seed(1)
    tree, n = rs.init_tree(roots)
    kept, run_s = [], []
    for move in range(moves):
        _sync()
        t0 = time.perf_counter()
        res, tree, n = rs.run(net, tree, n, generator=g)
        _sync()
        run_s.append(time.perf_counter() - t0)
        actions = torch.argmax(res.counts, -1)
        nxt = step_fn(tree.states[:, 0], actions)[0]
        if on_reroot is not None:
            on_reroot(move, tree, actions, nxt)
        tree, n = rs.reroot(tree, actions, nxt)
        kept.append(n)
    return torch.stack(kept), run_s


def phase_reuse():
    """Tree reuse at full width: the reusing search and reroot, self-play
    with reuse, and the training CLI with ``--tree-reuse``."""
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.ops import fused_backup as FB
    from alphazero_tpu_torch.search import mcts as M
    B, S, moves = 1024, 64, 4
    cfg = E.SplendorConfig(num_players=2)
    net = _r6_net(cfg, "cuda")
    fns = (A.make_eval_fn(A.net_config_for(cfg)), A.make_search_step_fn(cfg),
           A.make_valid_fn(cfg))
    mcfg = M.MCTSConfig(num_sims=S, add_noise=True, dirichlet_alpha=0.2,
                        prior_temp=1.25)
    rs = M.build_reusing_search(mcfg, 2, *fns, device="cuda")
    fresh = M.build_search(mcfg, 2, *fns, device="cuda")
    roots = E.initial_state(cfg, B, torch.Generator(device="cuda")
                            .manual_seed(1), device="cuda")

    # checked pass: up to 12 backups per move (the first 4, then every 8th)
    # held to the plain version on the stats and per-board slots each was
    # given, 4 descents per move (``_recording_descent``; moves 2-4 on
    # carried trees) held to ``select_plain``, the descent's levels summed,
    # and the second move's reroot done again on the CPU
    calls, checked, worst, depth_sum, differing = [0], [0], [0.0], [], [0]

    def record(stats, *args):
        i = calls[0] % S
        calls[0] += 1
        depth_sum.append(args[3].sum())
        if not (i < 4 or i % 8 == 0):
            return FB.backprop_packed(stats, *args)
        checked[0] += 1
        before = stats.clone()
        out = FB.backprop_packed(stats, *args)
        want = FB.backprop_packed_plain(before, *args)
        differing[0] += bool((args[9] != args[9][0]).any())
        if not torch.equal(out, want):
            worst[0] = max(worst[0], (out - want).abs().max().item())
        return out

    cpu_check = {}

    def on_reroot(move, tree, actions, nxt):
        cpu_check.setdefault("dtypes", set()).add(tree.stats.dtype)
        if move != 1:
            return
        t0 = time.perf_counter()
        card = rs.reroot(tree, actions, nxt)
        cpu = rs.reroot(M.Tree(*(t.cpu() for t in tree)), actions.cpu(),
                        nxt.cpu())
        cpu_check["equal"] = all(
            torch.equal(a.cpu(), b) for a, b in zip((*card[0], card[1]),
                                                    (*cpu[0], cpu[1])))
        cpu_check["seconds"] = time.perf_counter() - t0

    descents_checked = {}
    _zero_launches()
    with _installed(M, backprop_packed=record,
                    _select=_recording_descent(descents_checked)):
        kept, _ = _reuse_moves(rs, net, roots, moves, on_reroot)
    _sync()
    # and one more transition per move: the next state the reroot keeps
    backups, descents, steps = _counts()
    _check_launches("reusing search", moves * S, backups, descents,
                    steps - moves)
    if calls[0] != moves * S:
        raise AssertionError(f"{calls[0]} recorded backups for {moves * S} "
                             f"simulations")
    if worst[0] != 0.0 or differing[0] == 0:
        raise AssertionError(f"reusing search backups: max |kernel - plain| "
                             f"= {worst[0]}, {differing[0]} with slots that "
                             f"differ across boards")
    if not cpu_check.get("equal"):
        raise AssertionError("reroot on the card differs from the CPU's")
    if cpu_check["dtypes"] != {torch.float32}:
        raise AssertionError(f'stats_dtype "auto" gave {cpu_check["dtypes"]} '
                             f'carried stats on cuda, not float32')
    carried = _report_descents(descents_checked, "the reusing search")
    if carried < moves - 1:
        raise AssertionError(f"{carried} checked descents of the reusing "
                             f"search ran on a carried tree")
    levels = torch.stack(depth_sum).float().view(moves, S).sum(1) / (B * S)
    print(f"reuse B={B} S={S} (capacity {rs.capacity}): fused_backup with "
          f"per-board slot tensors: max |kernel - plain| = {worst[0]:.3g} "
          f"over {checked[0]} recorded launches ({differing[0]} with slots "
          f"that differ across boards); move 2's reroot card == CPU "
          f"({cpu_check['seconds']:.2f} s); stats_dtype \"auto\": float32 "
          f"carried trees", flush=True)

    # timed pass, the same computation without the checks; after each run
    # a fresh search of the same roots is timed beside it
    reroots, fresh_s = [], []
    g_fresh = torch.Generator(device="cuda").manual_seed(3)

    def timed_reroot(move, tree, actions, nxt):
        roots_m = tree.states[:, 0].clone()
        _sync()
        t0 = time.perf_counter()
        fresh(net, roots_m, generator=g_fresh)
        _sync()
        fresh_s.append(time.perf_counter() - t0)
        host_ms = _time_host_ms(lambda: rs.reroot(tree, actions, nxt), reps=3)
        prof = _profile(lambda: rs.reroot(tree, actions, nxt), host=True)
        reroots.append({"host_ms": host_ms,
                        "device_busy_ms": prof["device_busy_ms"],
                        "kernels": prof["kernel_launches"]})

    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    kept2, run_s = _reuse_moves(rs, net, roots, moves,
                                on_reroot=timed_reroot)
    _sync()
    launches, descents, steps = _counts()
    peak = torch.cuda.max_memory_allocated()
    _check_launches("reuse timed pass", 2 * moves * S, launches, descents,
                    steps - moves)
    if not torch.equal(kept, kept2):
        raise AssertionError(f"timed pass: n_kept {kept2.tolist()} vs "
                             f"{kept.tolist()}")
    per_move = []
    for m in range(moves):
        k = kept[m].float()
        per_move.append({
            "run_ms": run_s[m] * 1e3, "ms_per_sim": run_s[m] * 1e3 / S,
            "fresh_ms_per_sim": fresh_s[m] * 1e3 / S,
            **{f"reroot_{k_}": v for k_, v in reroots[m].items()},
            "kept_share": (k > 1).float().mean().item(),
            "kept_mean": k.mean().item(), "descent_levels": levels[m].item()})
        r = per_move[-1]
        print(f"reuse move {m + 1}: run {r['run_ms']:.1f} ms "
              f"({r['ms_per_sim']:.2f} ms/sim; a fresh search of the same "
              f"roots {r['fresh_ms_per_sim']:.2f}); reroot host "
              f"{r['reroot_host_ms']:.2f} ms, device "
              f"{r['reroot_device_busy_ms']} ms, {r['reroot_kernels']} "
              f"kernels; boards keeping > 1 node {r['kept_share']:.4f}, mean "
              f"n_kept {r['kept_mean']:.2f}; descent mean levels "
              f"{r['descent_levels']:.3f}", flush=True)
    carried_ms = statistics.median(run_s[1:]) * 1e3
    fresh_ms = statistics.median(fresh_s[1:]) * 1e3
    ratio = statistics.median(a / b for a, b in zip(run_s[1:], fresh_s[1:]))
    print(f"reuse search: {carried_ms / S:.2f} ms/sim on carried trees vs "
          f"{fresh_ms / S:.2f} fresh on the same roots (medians of moves "
          f"2-{moves}; median ratio {ratio:.3f}); backup, descent and env-step "
          f"launches {launches} = simulations of both; peak memory "
          f"{peak / 2**30:.3f} GiB",
          flush=True)
    capacity = rs.capacity
    del rs, fresh, net, roots, kept, kept2
    torch.cuda.empty_cache()

    selfplay, _ = phase_selfplay(tree_reuse=True)
    cli = _reuse_cli()
    return {"batch": B, "sims": S, "capacity": capacity,
            "moves": per_move, "carried_ms_per_sim": carried_ms / S,
            "fresh_ms_per_sim": fresh_ms / S, "carried_over_fresh": ratio,
            "launches": launches + selfplay["launches"] + cli["launches"],
            "descents": descents + selfplay["descents"] + cli["descents"],
            "steps": steps - moves + selfplay["steps"] + cli["steps"],
            "move_steps": moves,
            "max_abs_err": max(worst[0], selfplay["backup_max_abs_err"],
                               cli["backup_max_abs_err"]),
            "reroot_cpu_equal": True,
            "reroot_cpu_check_s": cpu_check["seconds"], "peak_bytes": peak,
            "selfplay": selfplay, "cli": cli}


class _IterLines(logging.Handler):
    """Keeps the messages of the coach's first iteration."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        if record.getMessage().startswith("Iter 1: "):
            self.lines.append(record.getMessage())


def _reuse_cli():
    """The training CLI's ``main`` with ``--tree-reuse`` on the card (the
    verify skill's CPU sizes), as ``python -m alphazero_tpu_torch.cli.main``
    runs it, in this process so that its searches' backups are counted
    against their simulations and a spread of them is held to the plain
    version at its shapes."""
    from alphazero_tpu_torch.cli import main as CLI
    from alphazero_tpu_torch.train import coach as CO
    samples, sims, iter_lines = {}, [0], _IterLines()
    level = CO.log.level
    CO.log.setLevel(logging.INFO)
    CO.log.addHandler(iter_lines)
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                _checked_path(sims, samples) as calls:
            _zero_launches()
            t0 = time.perf_counter()
            CLI.main(["-n", "1", "-e", "4", "--selfplayBatch", "4", "-m", "8",
                      "--arenaCompare", "4", "--gate-sims", "4", "-b", "16",
                      "-p", "1", "-C", tmp, "--tree-reuse"])
            _sync()
            cli_s = time.perf_counter() - t0
            launches, descents, steps = _counts()
    finally:
        CO.log.removeHandler(iter_lines)
        CO.log.setLevel(level)
    lines = iter_lines.lines
    if not any("ACCEPTED" in ln or "REJECTED" in ln for ln in lines):
        raise AssertionError(f"cli.main --tree-reuse logged {lines}")
    _check_launches("cli.main --tree-reuse", sims[0], launches, descents,
                    steps)
    err, _ = _check_recorded(samples, calls, "cli.main --tree-reuse")
    print(f"cli.main --tree-reuse on the card: {cli_s:.1f} s; backup, "
          f"descent and env-step launches {launches} = simulations "
          f"{sims[0]}; "
          + "; ".join(ln[len("Iter 1: "):][:80] for ln in lines), flush=True)
    return {"seconds": cli_s, "log": lines, "launches": launches,
            "descents": descents, "steps": steps, "simulations": sims[0],
            "backup_max_abs_err": err}


def phase_pit(coach_temp):
    """The batched pit CLI on the card: r6 against greedy, then a
    tournament of r6's ``best.pt`` and the coach phase's ``temp.pt`` with a
    Glicko-2 book."""
    import shutil
    from alphazero_tpu_torch.cli import pit as PIT
    r6 = os.path.join(ROOT, "runs", "r6", "best.pt")
    samples, sims = {}, [0]
    with tempfile.TemporaryDirectory() as tmp, \
            _checked_path(sims, samples) as calls:
        _zero_launches()
        t0 = time.perf_counter()
        out = PIT.main([r6, "greedy", "--batched", "-n", "4", "-m", "16"])
        pair_s = time.perf_counter() - t0
        for name, src in (("r6", r6), ("coach", coach_temp)):
            os.makedirs(os.path.join(tmp, name))
            shutil.copy(src, os.path.join(tmp, name, "best.pt"))
        t0 = time.perf_counter()
        book = PIT.main(["--batched", "--tournament", tmp, "-n", "2", "-m",
                         "8", "--ratings", os.path.join(tmp, "ratings.json")])
        tour_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "ratings.json")) as f:
            saved = json.load(f)
        _sync()
        launches, descents, steps = _counts()
    if out["games"] != 4 or out["wins"] + out["losses"] + out["draws"] != 4:
        raise AssertionError(f"pit record {out}")
    ratings = {k: vars(v) for k, v in book.ratings.items()}
    if sorted(saved) != ["coach/best.pt", "r6/best.pt"] or saved != ratings:
        raise AssertionError(f"tournament book {saved}")
    _check_launches("pit", sims[0], launches, descents, steps)
    err, _ = _check_recorded(samples, calls, "the pit's searches")
    print(f"pit: r6 vs greedy {out['wins']}-{out['losses']} "
          f"({out['draws']} draws) in {pair_s:.1f} s; tournament in "
          f"{tour_s:.1f} s; backup, descent and env-step launches {launches} = "
          f"simulations {sims[0]}", flush=True)
    return {"pair": out, "pair_seconds": pair_s, "tournament_seconds": tour_s,
            "ratings": ratings, "launches": launches, "descents": descents,
            "steps": steps,
            "simulations": sims[0], "backup_max_abs_err": err}


# the review phase's board, from the board DSL (the JAX board-DSL tests'
# demo spec): a mid-game position with reserved and bought cards
REVIEW_SPEC = {
    "Tier1": ["B3", "R21", "K22", "W4"],
    "Tier2": ["G322", "B5", "R53", "K6"],
    "Tier3": ["W5333", "G7", "B73", "R633"],
    "Bank": [4, 4, 3, 4, 4, 5],
    "Nobles": ["RG", "KW", "BW"],
    "Gems": [[1, 0, 2, 0, 0, 1], [0, 1, 0, 2, 0, 0]],
    "Cards": [[1, 0, 0, 0, 0], [0, 0, 1, 1, 0]],
    "Reserve": [["G21"], []],
    "PlayersCards": [["B1111", "R4"], ["K3", "W21", "G221"]],
    "PlayersNobles": [[], []],
}


def _entry_at(kept, device_ms=None):
    """The entry's device time per launch on the kept backups of one shape
    (``_recording_backup``'s samples), or ``device_ms`` when the caller
    measured it, beside its least time (the mean of ``_entry_work`` over
    them) and, when it is measured here, ``index_put_``'s time and the
    plain version's synchronized host time on the first kept backup."""
    from alphazero_tpu_torch.ops import fused_backup as FB
    work = [_entry_work(before, *raw) for before, raw, _ in kept]
    nbytes = sum(w[0] for w in work) / len(work)
    bound_ms, bound_by = _bound(nbytes, sum(w[1] for w in work) / len(work))
    out = {"ms": device_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": nbytes, "library_ms": None, "plain_host_ms": None}
    if device_ms is not None:
        return out
    st = kept[0][0].clone()
    raws = [raw for _, raw, _ in kept]

    def entry():
        for raw in raws:
            FB.backprop_packed(st, *raw)
    flat = st.view(-1)
    flats = [_entry_touched(before, *raw)[:2] for before, raw, _ in kept]

    def library():
        for idx, val in flats:
            flat.index_put_((idx,), val, accumulate=True)
    n = len(raws)
    out.update(ms=_device_ms(entry, "fused_backup_", per_call=n),
               library_ms=_device_ms(library, per_call=n),
               plain_host_ms=_time_host_ms(
                   lambda: FB.backprop_packed_plain(st, *raws[0])))
    return out


def phase_tooling(examples, review_sims=1600):
    """The tooling slice on the card, through its entry points: the
    sequential pit (r6 vs greedy, 2 games at 16 sims, recorded), ``analyze``
    on a recorded game, alpha-beta against r6 under ``--batched`` (its
    moves in a pool of CPU workers, r6's on the card), ``train_offline`` for
    one epoch on phase 4's examples from r6, and last ``review_position`` of
    a board from the board DSL at ``review_sims`` (B=1, no depth cap: a
    path buffer as wide) inside ``profiling.trace``, with its ``top_ops``.
    Every search's backups are counted against its simulations and a spread
    of them at each shape is held exactly to the plain version.  The
    entry's device time at B=1/M=17 is profiled on the pit's backups before
    the review; at B=1/M=1601 it is the review trace's own record of every
    launch: a trace of over a million kernels, after which this process's
    profiler may see no more kernels, so nothing is profiled after it."""
    import math
    import numpy as np
    from alphazero_tpu_torch.cli import analyze as ANALYZE
    from alphazero_tpu_torch.cli import pit as PIT
    from alphazero_tpu_torch.cli import review as REVIEW
    from alphazero_tpu_torch.cli import train_offline as TO
    from alphazero_tpu_torch.eval import ab_pool as AB
    from alphazero_tpu_torch.games.game_api import SplendorGame
    from alphazero_tpu_torch.games.splendor import board_dsl as D
    from alphazero_tpu_torch.ops import fused_backup as FB
    from alphazero_tpu_torch.train import replay as R
    from alphazero_tpu_torch.utils import checkpoint as C
    from alphazero_tpu_torch.utils import profiling as PROF
    from torch.profiler import ProfilerActivity
    r6 = os.path.join(ROOT, "runs", "r6", "best.pt")
    t_phase = time.perf_counter()
    samples, sims, rec = {}, [0], {}
    with tempfile.TemporaryDirectory() as tmp:
        with _checked_path(sims, samples) as calls:
            _zero_launches()
            # the sequential pit, its games recorded
            games = os.path.join(tmp, "games")
            t0 = time.perf_counter()
            wins, draws, scores = PIT.main([r6, "greedy", "-n", "2", "-m",
                                            "16", "--record-dir", games])
            rec["pit_seconds"] = time.perf_counter() - t0
            rec["pit"] = {"wins": wins, "draws": draws,
                          "scores": scores.tolist()}
            if sum(wins) + draws != 2:
                raise AssertionError(f"sequential pit: {wins} {draws}")
            # analyze one recorded game
            with open(os.path.join(games, "game_0.pkl"), "rb") as f:
                recorded = len(pickle.load(f))
            rows = ANALYZE.main([os.path.join(games, "game_0.pkl"), "-c", r6,
                                 "-o", os.path.join(tmp, "report.csv")])
            if len(rows) != recorded or not all(
                    math.isfinite(r["value"]) and math.isfinite(r["entropy"])
                    for r in rows):
                raise AssertionError(f"analyze: {len(rows)} rows for "
                                     f"{recorded} boards")
            rec["analyze_turns"] = len(rows)
            # alpha-beta under --batched against r6: a pool of 2 CPU
            # workers (one board per wave here; the default is one per CPU)
            with _installed(AB.AlphaBetaPool, __init__=functools.partialmethod(
                    AB.AlphaBetaPool.__init__, workers=2)):
                t0 = time.perf_counter()
                ab = PIT.main(["alphabeta", r6, "--batched", "-n", "2", "-m",
                               "8", "--ab-depth", "1", "--ab-deadline",
                               "0.5"])
                rec["alphabeta_seconds"] = time.perf_counter() - t0
            rec["alphabeta"] = ab
            if ab["games"] != 2:
                raise AssertionError(f"alphabeta --batched: {ab}")
            # the entry at the pit's shape, before any trace
            if (1, 17, 16) not in samples:
                raise AssertionError("no backup recorded at B=1, M=17")
            _sync()
            pit_launches, pit_descents, pit_steps = _counts()
            m17 = _entry_at(samples[1, 17, 16])
            FB.fused_backup.launches = pit_launches
            # offline training on phase 4's examples, warm-started from r6
            ex = os.path.join(tmp, "phase4.examples")
            replay = R.ReplayBuffer()
            replay.add_iteration(examples)
            replay.save(ex)
            out = os.path.join(tmp, "offline")
            t0 = time.perf_counter()
            TO.main(["-T", ex, "-i", r6, "-o", out, "-p", "1", "-b", "64"])
            rec["train_offline_seconds"] = time.perf_counter() - t0
            meta = C.load_checkpoint(out, "last.pt")["meta"]
            if not (math.isfinite(meta["loss"]) and "val_loss" in meta):
                raise AssertionError(f"train_offline: {meta}")
            rec["train_offline_loss"] = meta["loss"]
            # review a DSL board at full width, traced
            game = SplendorGame(2)
            board = D.spec_to_state(REVIEW_SPEC, 2, 0)
            net, _ = C.load_net(r6, game.cfg, game.device)
            trace_dir = os.path.join(tmp, "trace")
            _sync()
            # the kernels alone, all that is read back from this trace
            with PROF.trace(trace_dir, [ProfilerActivity.CUDA]):
                t0 = time.perf_counter()
                pi, q = REVIEW.review_position(game, net, board, review_sims)
                _sync()
                review_s = time.perf_counter() - t0
            review_launches = FB.fused_backup.launches - pit_launches
            review_descents = _descents() - pit_descents
            review_steps = _steps() - pit_steps
            launches, descents, steps = _counts()
            t0 = time.perf_counter()
            ops = PROF.top_ops(trace_dir, None)
            top_ops_s = time.perf_counter() - t0
    _check_launches("tooling", sims[0], launches, descents, steps)
    _check_launches("review", review_sims, review_launches, review_descents,
                    review_steps)
    entry_rows = [r for r in ops if "fused_backup_entry_kernel" in r[3]]
    if len(entry_rows) != 1 or not 0.9 * review_sims <= entry_rows[0][1]:
        raise AssertionError(f"review trace rows {entry_rows}")
    if not (abs(pi.sum() - 1.0) < 1e-6 and np.isfinite(q).all()):
        raise AssertionError(f"review: pi sums to {pi.sum()}, q {q}")
    err, _ = _check_recorded(samples, calls, "the tooling's searches")
    key = (1, review_sims + 1, review_sims)
    if key not in samples:
        raise AssertionError(f"no backup recorded at B, M, S1 = {key}")
    total_us, records = entry_rows[0][0], entry_rows[0][1]
    shapes = {"B1_M17": m17,
              f"B1_M{review_sims + 1}": _entry_at(
                  samples[key], device_ms=total_us / records / 1e3)}
    del samples
    top = [(int(a), float(pi[a])) for a in np.argsort(-pi)[:5]]
    rec["review"] = {"seconds": review_s,
                     "ms_per_sim": review_s * 1e3 / review_sims,
                     "top_ops_seconds": top_ops_s, "top": top,
                     "q": q.tolist(), "top_ops": ops[:8],
                     "entry_row": entry_rows[0],
                     "device_ops": sum(r[1] for r in ops)}
    rec.update(launches=launches, descents=descents, steps=steps,
               simulations=sims[0],
               backup_max_abs_err=err, entry_by_shape=shapes,
               seconds=time.perf_counter() - t_phase)
    r = rec["review"]
    print(f"tooling: sequential pit r6 vs greedy {wins} ({draws} draws) in "
          f"{rec['pit_seconds']:.1f} s; analyze {len(rows)} turns; "
          f"alphabeta vs r6 --batched {ab['wins']}-{ab['losses']} "
          f"({ab['draws']} draws) in {rec['alphabeta_seconds']:.1f} s; "
          f"train_offline 1 epoch {rec['train_offline_seconds']:.1f} s, "
          f"loss {meta['loss']:.4f}; review at {review_sims} sims (traced) "
          f"{review_s:.2f} s, {r['ms_per_sim']:.3f} ms/sim, root q "
          f"{[round(x, 3) for x in r['q']]}, top moves {top}", flush=True)
    print(f"tooling review top_ops ({r['device_ops']} device ops, read in "
          f"{top_ops_s:.1f} s; total_us, count, type, name): "
          + "; ".join(f"{t:.0f} {c} {ty} {n[:48]}" for t, c, ty, n in ops[:6])
          + f"; fused_backup_entry_kernel row: {total_us:.0f} us, "
          f"{records} records for {review_launches} launches", flush=True)
    print("fused_backup entry device us per launch at the tooling's shapes: "
          + ", ".join(f"{k} {v['ms'] * 1e3:.3f} (bound "
                      f"{v['bound_ms'] * 1e3:.4f}, {v['bytes']:.0f} bytes, "
                      f"{v['bound_by']})" for k, v in shapes.items())
          + f"; at B1_M17 index_put_ {m17['library_ms'] * 1e3:.1f}, plain "
          f"host {m17['plain_host_ms'] * 1e3:.1f}", flush=True)
    print(f"tooling: backup, descent and env-step launches {launches} = "
          f"simulations {sims[0]}; phase {rec['seconds']:.1f} s", flush=True)
    return rec


def phase_export():
    """r6 to ``.pt2`` on the card, reloaded and held to the live net at
    B=1, 7 and 1024; its forward at B=1024 timed beside the live net's;
    r6's ONNX from the port's writer run by ``tests/onnx_mini.py`` on 8
    boards against the card's forward."""
    import numpy as np
    import torch
    from alphazero_tpu_torch.cli import export as X
    from alphazero_tpu_torch.compat import onnx_export as OX
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.models import splendor_net as N
    from tests import onnx_mini
    t_phase = time.perf_counter()
    cfg = E.SplendorConfig(num_players=2)
    net = _r6_net(cfg, "cuda")
    r6 = os.path.join(ROOT, "runs", "r6", "best.pt")
    with tempfile.TemporaryDirectory() as tmp:
        pt2 = os.path.join(tmp, "r6.pt2")
        t0 = time.perf_counter()
        X.export_checkpoint(r6, pt2, device="cuda")
        export_s = time.perf_counter() - t0
        fn = X.load_exported(pt2)
        diffs = {B: X.check_roundtrip(fn, net, cfg, batches=(B,))
                 for B in (1, 7, 1024)}
        if max(diffs.values()) > 1e-5:
            raise AssertionError(f".pt2 vs the live net: {diffs}")
        g = torch.Generator(device="cuda").manual_seed(5)
        boards = E.initial_state(cfg, 1024, g, "cuda")
        valids = E.valid_moves(cfg, boards, 0)
        x = boards.to(torch.float32)

        def live():
            N.apply_inference(net, x, valids)

        def artifact():
            with torch.inference_mode():
                fn(x, valids)
        times = {}
        for name, f in (("live", live), ("pt2", artifact), ("pt2", artifact),
                        ("live", live)):
            for _ in range(3):
                f()
            times.setdefault(name, []).append(_time_host_ms(f, reps=20))

        onnx = os.path.join(tmp, "r6.onnx")
        OX.export_net(net, onnx)
        model = onnx_mini.load_model(onnx)
        with torch.inference_mode():
            log_pi, v, log_sd = net(x[:8], valids[:8])
        pi_o, v_o, sd_o = onnx_mini.run_model(
            model, {"board": x[:8].cpu().numpy(),
                    "valid_actions": valids[:8].cpu().numpy()})
        onnx_err = [float(np.abs(a - b.cpu().numpy()).max())
                    for a, b in ((pi_o, log_pi), (v_o, v), (sd_o, log_sd))]
        valid8 = valids[:8].cpu().numpy()
        onnx_err[0] = float(np.abs(pi_o - log_pi.cpu().numpy())[valid8].max())
        if onnx_err[0] > 1e-3 or onnx_err[1] > 1e-4 or onnx_err[2] > 1e-3:
            raise AssertionError(f"ONNX (onnx_mini) vs the card: {onnx_err}")
        sizes = {"pt2_bytes": os.path.getsize(pt2),
                 "onnx_bytes": os.path.getsize(onnx)}
    ms = {k: min(v) for k, v in times.items()}
    rec = {"export_s": export_s, "max_abs_diff": diffs, "forward_ms_b1024": ms,
           "forward_ms_b1024_reps": times, "onnx_mini_err": onnx_err,
           **sizes, "seconds": time.perf_counter() - t_phase}
    print(f"export: r6 -> .pt2 on the card in {export_s:.2f} s; reloaded vs "
          f"the live net max |diff| at B=1 {diffs[1]:.3g}, B=7 {diffs[7]:.3g}, "
          f"B=1024 {diffs[1024]:.3g}; forward at B=1024 .pt2 "
          f"{ms['pt2']:.3f} ms, live net {ms['live']:.3f} ms (best of 2 "
          f"turns of 20 synchronized calls); ONNX (port writer, "
          f"{sizes['onnx_bytes']} bytes) in onnx_mini on 8 boards vs the "
          f"card: log_pi {onnx_err[0]:.3g} (valid moves), v "
          f"{onnx_err[1]:.3g}, scdiffs {onnx_err[2]:.3g}; phase "
          f"{rec['seconds']:.1f} s", flush=True)
    return rec


# the distributed iteration, cut below the coach phase (8 games, 16 sims,
# 4 gate games at 8 sims, one epoch at batch 32) from the r6 weights
DIST_ARGV = ["-n", "1", "-e", "8", "--selfplayBatch", "8", "-m", "16",
             "--ratio-fullMCTS", "4", "--prob-fullMCTS", "0.25", "-F",
             "--arenaCompare", "4", "--gate-sims", "8", "-b", "32", "-p", "1",
             "-L", os.path.join(ROOT, "runs", "r6", "best.pt")]


def _cli_iteration(argv):
    """``cli.main.main(argv)`` in this process, its searches' backups
    counted against their simulations and a spread of them held to the
    plain version; each coach stage timed.  Returns its record."""
    from alphazero_tpu_torch.cli import main as CLI
    from alphazero_tpu_torch.train import coach as CO
    samples, sims, stage = {}, [0], {}

    def timed(name, fn):
        def run(*a, **kw):
            _sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync()
            stage[name] = time.perf_counter() - t0
            return out
        return run
    stages = {n: timed(n, getattr(CO.Coach, n))
              for n in ("self_play_iteration", "train_iteration", "gate")}
    with _installed(CO.Coach, **stages), \
            tempfile.TemporaryDirectory() as tmp, \
            _checked_path(sims, samples) as calls:
        _zero_launches()
        t0 = time.perf_counter()
        CLI.main(argv + ["-C", tmp])
        _sync()
        seconds = time.perf_counter() - t0
        launches, descents, steps = _counts()
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            record = json.loads(f.readline())
    _check_launches(" ".join(argv), sims[0], launches, descents, steps)
    err, _ = _check_recorded(samples, calls, "the CLI iteration")
    return {"seconds": seconds, "stage_seconds": stage, "launches": launches,
            "descents": descents, "steps": steps, "simulations": sims[0],
            "backup_max_abs_err": err,
            "record": record}


def _distributed_child(out_path):
    """The child of ``phase_distributed``: under torchrun's variables at
    W=1, ``cli.main --distributed`` (NCCL), then the sharded train step
    beside the plain one, the port's dry run, and ``bench_scaling``."""
    import torch
    from alphazero_tpu_torch.cli import bench_scaling as BS
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.parallel import distributed as D
    from alphazero_tpu_torch.parallel import dryrun as DR
    from alphazero_tpu_torch.parallel import mesh as MP
    from alphazero_tpu_torch.train import trainer as TR
    D.initialize(device="cuda")
    rec = {"backend": torch.distributed.get_backend(),
           "world": D.world_size()}
    rec["cli"] = _cli_iteration(DIST_ARGV + ["--distributed"])

    # one train step, sharded (W=1, NCCL) and plain, on the same batch
    cfg = E.SplendorConfig()
    net_cfg = A.net_config_for(cfg)
    tcfg = TR.TrainConfig(batch_size=64)
    batch = DR.sample_batch(cfg, 64, 0)
    mesh = MP.make_mesh()
    steps, params = {}, {}
    for name, m in (("plain", None), ("nccl", mesh), ("nccl", mesh),
                    ("plain", None)):
        st = TR.init_train_state(net_cfg, torch.Generator().manual_seed(0),
                                 "cuda")
        step = TR.make_train_step(cfg, net_cfg, tcfg, m)

        def one(st=st, step=step):
            step(st, batch, 3e-4, 10.0,
                 torch.Generator(device="cuda").manual_seed(1))
        one()
        params[name] = torch.cat([p.detach().reshape(-1)
                                  for p in st.net.parameters()])
        steps.setdefault(name, []).append(_time_host_ms(one, reps=20))
    rec["train_step_ms"] = {k: min(v) for k, v in steps.items()}
    rec["train_step_ms_reps"] = steps
    rec["train_step_max_abs_dparam"] = float(
        (params["nccl"] - params["plain"]).abs().max())

    _zero_launches()
    sims, samples = [0], {}
    with _checked_path(sims, samples) as calls:
        rec["dryrun"] = DR.dryrun("cuda")
        _sync()
    dry_launches, dry_descents, dry_steps = _counts()
    _check_launches("dry run", sims[0], dry_launches, dry_descents,
                    dry_steps)
    err, _ = _check_recorded(samples, calls, "the dry run's self-play")
    rec["dryrun"].update(launches=dry_launches, descents=dry_descents,
                         steps=dry_steps,
                         backup_max_abs_err=err)
    rec["bench_scaling"] = BS.main(["--batch-per-device", "4096",
                                    "--steps", "50"])
    D.shutdown()
    with open(out_path, "w") as f:
        json.dump(rec, f)


def phase_distributed():
    """``cli.main --distributed`` in a child process under torchrun's
    variables at W=1 (NCCL on the card), with the sharded train step, the
    dry run and ``bench_scaling`` there; the same CLI iteration without
    ``--distributed`` in this process, held to the child's."""
    import socket
    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port), "WORLD_SIZE": "1", "RANK": "0",
           "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "child.json")
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--distributed-child", out], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"distributed child exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        with open(out) as f:
            child = json.load(f)
    plain = _cli_iteration(DIST_ARGV)
    dist_rec, plain_rec = child["cli"]["record"], plain["record"]
    keys = ("selfplay_games", "selfplay_examples", "selfplay_rollouts",
            "gate_new", "gate_old", "gate_draws", "accepted",
            "replay_examples")
    same = {k: (dist_rec[k], plain_rec[k]) for k in keys}
    loss_rel = (abs(dist_rec["train_loss"] - plain_rec["train_loss"])
                / abs(plain_rec["train_loss"]))
    if any(a != b for a, b in same.values()) or loss_rel > 1e-5:
        raise AssertionError(f"--distributed at W=1 vs without: {same}, "
                             f"train loss rel diff {loss_rel}")
    c, ts, bs = child["cli"], child["train_step_ms"], child["bench_scaling"]
    rec = {"child": child, "plain_cli": plain, "train_loss_rel_diff":
           loss_rel, "launches": (c["launches"] + child["dryrun"]["launches"]
                                  + plain["launches"]),
           "descents": (c["descents"] + child["dryrun"]["descents"]
                        + plain["descents"]),
           "steps": (c["steps"] + child["dryrun"]["steps"] + plain["steps"]),
           "backup_max_abs_err": max(c["backup_max_abs_err"],
                                     child["dryrun"]["backup_max_abs_err"],
                                     plain["backup_max_abs_err"]),
           "seconds": time.perf_counter() - t_phase}
    st = c["stage_seconds"]
    print(f"distributed: cli.main --distributed at W=1 ({child['backend']}) "
          f"in a child: {c['seconds']:.1f} s (self-play "
          f"{st['self_play_iteration']:.2f} s, train "
          f"{st['train_iteration']:.2f} s, gate {st['gate']:.2f} s); backup, "
          f"descent and env-step launches {c['launches']} = simulations "
          f"{c['simulations']}; equal "
          f"to the same iteration without --distributed ({plain['seconds']:.1f}"
          f" s; examples {plain_rec['selfplay_examples']}, gate "
          f"{plain_rec['gate_new']}-{plain_rec['gate_old']}-"
          f"{plain_rec['gate_draws']}, train loss rel diff {loss_rel:.3g})",
          flush=True)
    print(f"distributed: train step B=64 sharded ({child['backend']}, "
          f"W={child['world']}) {ts['nccl']:.3f}"
          f" ms vs plain {ts['plain']:.3f} ms (best of 2 turns of 20), max "
          f"|dparam| {child['train_step_max_abs_dparam']:.3g}; dry run "
          f"{child['dryrun']['launches']} backup launches, sharded loss rel "
          f"err {child['dryrun']['train_loss_rel_err']:.3g}; bench_scaling "
          f"B=4096 {bs['one_device']} env steps/s on one device, "
          f"{bs['all_devices']} on {bs['devices']}; phase "
          f"{rec['seconds']:.1f} s", flush=True)
    return rec


# the keys of the benchmark entry points' JSON lines
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "value_best", "reps",
              "batch", "sims", "degraded", "stage_schedule",
              "pin_matmul_tflops", "pin_hbm_gbps", "pins_method", "sync",
              "selfplay"}
SELFPLAY_ROW_KEYS = {"value", "unit", "games_per_s", "examples_per_s",
                     "batch", "sims", "pcr"}
BENCH_SELFPLAY_KEYS = {"metric", "value", "unit", "vs_baseline",
                       "games_per_s", "moves_per_s", "examples_per_s",
                       "batch", "num_sims", "num_players", "tree_reuse",
                       "model_flops_per_s"}


def _check_row(what, row, keys, want):
    """``row``'s keys are ``keys``, its fields in ``want`` equal, and its
    rates finite and positive."""
    if set(row) != keys:
        raise AssertionError(f"{what}: keys {sorted(row)}, not "
                             f"{sorted(keys)}")
    got = {k: row[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: {got}, not {want}")
    for k in ("value", "games_per_s", "value_best"):
        if k in row and not 0.0 < row[k] < float("inf"):
            raise AssertionError(f"{what}: {k} = {row[k]}")


def phase_bench(moves=12):
    """The benchmark entry points.  ``cli.bench``'s search row in a child
    (``python -m alphazero_tpu_torch.cli.bench`` with
    ``BENCH_SKIP_SELFPLAY=1``) at B=1024, S=64, 5 reps: exit 0, one JSON
    line with its keys, not degraded.  Then in this process ``bench.
    selfplay_row`` and ``bench_selfplay.row`` (one timed run) at B=256,
    S=128, PCR, cut to ``moves`` moves as phases 4 and 8 are, each with one
    backup and one descent launch per simulation its searches ran."""
    from alphazero_tpu_torch.cli import bench as BENCH
    from alphazero_tpu_torch.cli import bench_selfplay as BSP
    t0 = time.perf_counter()
    env = dict(os.environ, BENCH_BATCH="1024", BENCH_SIMS="64",
               BENCH_REPS="5", BENCH_SKIP_SELFPLAY="1")
    child = subprocess.run(
        [sys.executable, "-m", "alphazero_tpu_torch.cli.bench"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)
    lines = child.stdout.strip().splitlines()
    if child.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"cli.bench exited {child.returncode} with "
                             f"{len(lines)} lines: {child.stdout[-2000:]}"
                             f"{child.stderr[-4000:]}")
    search = json.loads(lines[0])
    _check_row("cli.bench", search, BENCH_KEYS, {
        "metric": "mcts_rollouts_per_s_per_chip", "batch": 1024, "sims": 64,
        "reps": 5, "stage_schedule": [16, 16, 32], "selfplay": None,
        "sync": "cuda-synchronize"})
    if search["degraded"]:
        raise AssertionError(
            f"cli.bench: the card is degraded: pins "
            f"{search['pin_matmul_tflops']} TFLOP/s, "
            f"{search['pin_hbm_gbps']} GB/s against "
            f"{BENCH.HEALTHY_TFLOPS_MIN}, {BENCH.HEALTHY_GBPS_MIN}")
    print(f"cli.bench B=1024 S=64 (a child): {search['value']} rollouts/s "
          f"(best {search['value_best']}), pins "
          f"{search['pin_matmul_tflops']} TFLOP/s, {search['pin_hbm_gbps']} "
          f"GB/s, degraded {search['degraded']}; {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    cut = dict(max_moves=moves, chunk_moves=moves)
    rec = {"search": search, "launches": 0, "descents": 0, "steps": 0}
    rows = (("bench.selfplay_row", SELFPLAY_ROW_KEYS,
             {"batch": 256, "sims": 128, "pcr": True},
             lambda: BENCH.selfplay_row("cuda", cut)),
            ("bench_selfplay.row", BENCH_SELFPLAY_KEYS,
             {"batch": 256, "num_sims": 128, "tree_reuse": False},
             lambda: BSP.row("cuda", reps=1, sp_cfg_overrides=cut)))
    for name, keys, want, run in rows:
        sims = [0]
        with _checked_path(sims):
            _zero_launches()
            row = run()
            _sync()
            launches, descents, steps = _counts()
        _check_launches(name, sims[0], launches, descents, steps)
        _check_row(name, row, keys, want)
        rec[name] = dict(row, launches=launches, simulations=sims[0])
        rec["launches"] += launches
        rec["descents"] += descents
        rec["steps"] += steps
        print(f"{name} B=256 S=128 PCR, {moves} moves: {row['value']} "
              f"rollouts/s, {row['games_per_s']} games/s; backup, descent "
              f"and env-step launches {launches} = simulations {sims[0]}",
              flush=True)
    rec["seconds"] = time.perf_counter() - t0
    print(f"bench phase {rec['seconds']:.1f} s", flush=True)
    return rec


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


GRAPH_BATCHES = (1, 38, 77, 90, 128, 179, 256)


def _eager_eval_fn(net, states, valids):
    """The leaf evaluator without graphs: ``apply_inference`` on float32
    boards, the net's ~40 launches one by one."""
    import torch
    from alphazero_tpu_torch.models import splendor_net as N
    probs, v, _ = N.apply_inference(net, states.to(torch.float32), valids)
    return probs, v


def _graph_at(net, B):
    """The net's captured forward for int8 boards of batch ``B``."""
    import torch
    from alphazero_tpu_torch.models import splendor_net as N
    [g] = [g for k, g in N._GRAPHS[net].graphs.items()
           if k[0][0] == B and k[1] == torch.int8]
    return g


def _graph_inputs(num_players, g, n=768):
    """``n`` playout states (``_env_step_playouts``) and their valid masks."""
    from alphazero_tpu_torch.games.splendor import env as E
    cfg = E.SplendorConfig(num_players=num_players)
    s = _env_step_playouts(num_players, g, boards=256,
                           per_ply=n // len(ENV_STEP_KEEP))
    return s, E.valid_moves(cfg, s, 0)


def _pick(states, valids, B, g):
    import torch
    i = torch.randperm(states.shape[0], generator=g,
                       device="cuda")[:B]
    return states[i], valids[i]


def _check_graphed(net, states, valids, g, batches, what):
    """At each batch size, three calls of the evaluator (eager, captured,
    replayed) on other boards each, every output held to
    ``apply_inference`` bit for bit, the SDIFF head's too (read from the
    graph after its replay).  Returns the calls checked."""
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.models import splendor_net as N
    eval_fn, calls = A.make_eval_fn(net.cfg), 0
    for B in batches:
        for _ in range(3):
            b, m = _pick(states, valids, B, g)
            probs, v = eval_fn(net, b, m)
            want = N.apply_inference(net, b.to(torch.float32), m)
            if not (torch.equal(probs, want[0]) and torch.equal(v, want[1])):
                raise AssertionError(f"{what}, B={B}: the graphed evaluator "
                                     f"differs from apply_inference")
            calls += 1
        if not torch.equal(_graph_at(net, B).out[2], want[2]):
            raise AssertionError(f"{what}, B={B}: the graph's log_sdiff "
                                 f"differs from apply_inference's")
    return calls


def _recorded_results(search, log):
    def run(params, roots, generator=None, noise_gamma=None):
        res = search(params, roots, generator=generator,
                     noise_gamma=noise_gamma)
        log.append(res)
        return res
    return run


def _same_results(got, want, what):
    if len(got) != len(want) or not got:
        raise AssertionError(f"{what}: {len(got)} searches against "
                             f"{len(want)}")
    import torch
    for k, (a, b) in enumerate(zip(got, want)):
        for f in ("counts", "raw_counts", "q", "root_prior", "root_value"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"{what}: search {k}'s {f} differs "
                                     f"from the eager evaluator's")


def phase_graphs():
    """The graphed leaf evaluator (``splendor_net.infer``) on the card:
    bit for bit against ``apply_inference`` at every batch of
    ``GRAPH_BATCHES`` with r6's net (float32 and bf16 trunk) and r12's
    4-player net, after an in-place Adam step, and with two nets in turns;
    a search's root values unchanged by later replays; self-play plies and
    B=1 searches equal to searches over an eager evaluator; the replay's
    kernels equal to the eager forward's in a trace."""
    import dataclasses
    import numpy as np
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.models import splendor_net as N
    from alphazero_tpu_torch.search import mcts as M
    from alphazero_tpu_torch.train import selfplay as SP
    from alphazero_tpu_torch.utils import checkpoint as C
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(16)
    cfg2, cfg4 = (E.SplendorConfig(num_players=p) for p in (2, 4))
    s2, v2 = _graph_inputs(2, g)
    s4, v4 = _graph_inputs(4, g)
    r12 = C.load_net(os.path.join(ROOT, "runs", "r12_4p", "best.pt"), cfg4,
                     "cuda")[0]
    out = {"checked_calls": 0}
    for what, net, s, v in (("r6", _r6_net(cfg2, "cuda"), s2, v2),
                            ("r6 bf16", _r6_net(cfg2, "cuda", "bfloat16"),
                             s2, v2),
                            ("r12", r12, s4, v4)):
        out["checked_calls"] += _check_graphed(net, s, v, g, GRAPH_BATCHES,
                                               what)

    # an in-place Adam step keeps the graphs, which read the new weights
    net, other = _r6_net(cfg2, "cuda"), _r6_net(cfg2, "cuda")
    out["checked_calls"] += _check_graphed(net, s2, v2, g, (77, 179),
                                           "r6 before Adam")
    graphs = dict(N._GRAPHS[net].graphs)
    b, m = _pick(s2, v2, 64, g)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    (log_pi, val, _), _ = N.apply_train(
        net, b.to(torch.float32), m, torch.Generator(device="cuda")
        .manual_seed(0))
    (val.square().sum() - torch.where(m, log_pi, 0.0).sum()).backward()
    opt.step()
    moved = not torch.equal(net.dense_0.weight, other.dense_0.weight)
    eval_fn = A.make_eval_fn(net.cfg)
    for B in (77, 179):
        for _ in range(2):
            b, m = _pick(s2, v2, B, g)
            probs, val = eval_fn(net, b, m)
            want = N.apply_inference(net, b.to(torch.float32), m)
            if not (torch.equal(probs, want[0])
                    and torch.equal(val, want[1])):
                raise AssertionError(f"B={B}: the graphed evaluator differs "
                                     f"from apply_inference after Adam")
            out["checked_calls"] += 1
    if not moved or dict(N._GRAPHS[net].graphs) != graphs:
        raise AssertionError("the Adam step moved no weight, or the graphs "
                             "were captured again")
    # two nets in turns, each held to its own eager forward
    for k in range(8):
        B = (77, 1)[k % 2]
        for n_ in (net, other):
            b, m = _pick(s2, v2, B, g)
            probs, val = eval_fn(n_, b, m)
            want = N.apply_inference(n_, b.to(torch.float32), m)
            if not (torch.equal(probs, want[0])
                    and torch.equal(val, want[1])):
                raise AssertionError(f"two nets in turns, B={B}: the "
                                     f"graphed evaluator differs")
            out["checked_calls"] += 1

    # a search's root values outlive later replays
    mcfg = M.MCTSConfig(num_sims=16)
    search = M.build_search(mcfg, 2, eval_fn, A.make_search_step_fn(cfg2),
                            A.make_valid_fn(cfg2), device="cuda")
    roots, _ = _pick(s2, v2, 77, g)
    first = search(other, roots)
    kept = first.root_value.clone()
    search(other, _pick(s2, v2, 77, g)[0])
    want = N.apply_inference(other, roots.to(torch.float32),
                             E.valid_moves(cfg2, roots, 0))[1]
    if not (torch.equal(first.root_value, kept)
            and torch.equal(kept, want)):
        raise AssertionError("a search's root values changed after later "
                             "replays")

    # self-play plies and B=1 searches: graphed against eager
    r6 = _r6_net(cfg2, "cuda")
    logs = {}
    for name, fn in (("graphed", A.make_eval_fn(r6.cfg)),
                     ("eager", _eager_eval_fn)):
        sp = SP.SelfPlayConfig(batch_size=256, num_sims=128, ratio_full=4,
                               prob_full=0.3, forced_playouts=True,
                               max_moves=3, chunk_moves=3)
        eng = SP.SelfPlayEngine(cfg2, fn, sp, device="cuda")
        logs[name] = log = []
        eng.search_full = _recorded_results(eng.search_full, log)
        eng.search_fast = _recorded_results(eng.search_fast, log)
        it, _ = eng.run_games(r6, torch.Generator(device="cuda")
                              .manual_seed(3))
        logs[name + " examples"] = it
    _same_results(logs["graphed"], logs["eager"], "self-play")
    for f in dataclasses.fields(logs["graphed examples"]):
        if not np.array_equal(getattr(logs["graphed examples"], f.name),
                              getattr(logs["eager examples"], f.name)):
            raise AssertionError(f"self-play examples' {f.name} differ")
    b1 = {}
    for name, fn in (("graphed", A.make_eval_fn(r12.cfg)),
                     ("eager", _eager_eval_fn)):
        search = M.build_search(M.MCTSConfig(num_sims=128, fpu=0.3), 4, fn,
                                A.make_search_step_fn(cfg4),
                                A.make_valid_fn(cfg4), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        b1[name] = [search(r12, s4[k:k + 1], generator=gen)
                    for k in range(0, 64, 8)]
    _same_results(b1["graphed"], b1["eager"], "B=1 searches")

    # the replay runs the eager forward's kernels; the evaluator adds
    # the copies in and out
    kernels = {}
    graphed_fn = A.make_eval_fn(r6.cfg)
    for B in (1, 77, 179, 256):
        b, m = _pick(s2, v2, B, g)
        for _ in range(2):                  # captured, if it was not
            graphed_fn(r6, b, m)
        graph = _graph_at(r6, B)
        x = b.to(torch.float32)
        eager = _profile(lambda: N._forward(r6, x, m))["kernels"]
        replay = _profile(graph.graph.replay)["kernels"]
        whole = _profile(lambda: graphed_fn(r6, b, m))["kernels"]
        if replay != eager or replay == 0:
            raise AssertionError(f"B={B}: the traced replay ran {replay} "
                                 f"kernels, the eager forward {eager}")
        kernels[B] = {"eager_forward": eager, "replay": replay,
                      "graphed_evaluation": whole,
                      "eager_evaluation": _profile(
                          lambda: _eager_eval_fn(r6, b, m))["kernels"]}
    out.update(kernels=kernels, seconds=time.perf_counter() - t0)
    print(f"graphs: {out['checked_calls']} evaluations bit-equal to "
          f"apply_inference; kernels {kernels}; {out['seconds']:.0f} s",
          flush=True)
    return out


BT4_BATCHES = (77, 179, 256)       # the BT4 cell's leaf batches


def _bt4_net():
    """The BT4 cell's net on the card (width 1024, 15 layers, 32 heads, FFN
    1536, smolgen 32 / 256 / 256, bf16 trunk, 2 players), every bias, norm
    affine and gating drawn off its initial value from a seeded
    generator."""
    import torch
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.models import splendor_net as N
    cfg = A.net_config_for(E.SplendorConfig(num_players=2), nn_version=3,
                           width=1024, dtype="bfloat16", dropout=0.0)
    net = N.build_net(cfg, "cuda", torch.Generator().manual_seed(18))
    g = torch.Generator(device="cuda").manual_seed(19)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("bias", "add")):
                p.normal_(0.0, 0.2, generator=g)
            elif p.dim() == 1 or name.endswith("mul"):
                p.normal_(1.0, 0.2, generator=g)
    return net


def _trunk_addmm(shapes, B):
    """Whether an ``aten::addmm`` of these input shapes is a biased Dense of
    the BT4 trunk at batch ``B`` (per token: M = 56 B; smolgen's per-board
    ``dense_5`` / ``dense_6``: 1792 -> 256, 256 -> 8192); the heads' run
    at M = B from width 1024."""
    bias, (M, K), (_, Nn) = shapes[0], shapes[1], shapes[2]
    return len(bias) == 1 and (M == 56 * B or (K, Nn) in ((1792, 256),
                                                          (256, 8192)))


def _kinds(rows):
    """Device µs of one evaluation by kind: the bias adds (an ``aten::add``
    with a 1-D operand), the attention output's transpose copy (a 4-D
    ``aten::copy_``), the other copies and casts, GEMMs (under ``mm``,
    ``addmm``, ``bmm``), attention, layer norms, the rest."""
    kinds = {}
    for op, shapes, kernel, us in ((o, sh, k, us) for o, sh, ks in rows
                                   for k, us in ks):
        if op == "aten::add" and len(shapes) > 1 and len(shapes[1]) == 1:
            kind = "bias add"
        elif op == "aten::copy_" and len(shapes[0]) == 4:
            kind = "transpose copy"
        elif op == "aten::copy_":
            kind = "cast or copy"
        elif op in ("aten::mm", "aten::addmm", "aten::bmm"):
            kind = "gemm"
        elif "sdpa" in kernel or "attention" in op:
            kind = "attention"
        elif "layer_norm" in op:
            kind = "layer norm"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + us
    return {k: round(v, 1) for k, v in sorted(kinds.items())}


def phase_bt4_dense(check=True):
    """Version 3's Dense on the card, at the BT4 cell's leaf batches: each
    biased Dense of the trunk one GEMM with the bias in its epilogue.  For
    the cell's net (``_bt4_net``) at each of ``BT4_BATCHES``: the graphed
    evaluator bit for bit against ``apply_inference`` (``_check_graphed``),
    the replay's kernels equal to the eager forward's; ``1 + 6 * layers``
    trunk ``aten::addmm``, each launching one GEMM (cuBLASLt's memset of
    its workspace aside; the shapes where more ran); no bias add on its
    own; kernels per evaluation and device time by kind.  With ``check``
    it raises, after printing, where a check failed."""
    import torch
    from alphazero_tpu_torch.models import splendor_net as N
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(18)
    s2, v2 = _graph_inputs(2, g)
    net = _bt4_net()
    failed = []
    checked = _check_graphed(net, s2, v2, g, BT4_BATCHES, "BT4")
    out = {"checked_calls": checked, "batches": {}}
    for B in BT4_BATCHES:
        b, m = _pick(s2, v2, B, g)
        x = b.to(torch.float32)
        k_replay = _profile(_graph_at(net, B).graph.replay)["kernels"]
        eager = _profile(lambda: N._forward(net, x, m), host=True,
                         shapes=True)
        k_once, rows = eager["kernels"], eager["ops"]
        dense, extra, memset = 0, {}, []
        for op, shapes, kernels in rows:
            if op == "aten::addmm" and _trunk_addmm(shapes, B):
                dense += 1
                names = [k for k, _ in kernels]
                launched = [k for k in names
                            if not k.startswith(("Memset", "Memcpy"))]
                if len(launched) != 1:
                    extra[str(shapes)] = names
                elif len(names) > 1:
                    memset.append(f"{shapes[1]} x {shapes[2]}")
        adds = sum(1 for op, sh, _ in rows
                   if op == "aten::add" and len(sh) > 1 and len(sh[1]) == 1)
        kinds = _kinds(rows)
        out["batches"][B] = {
            "kernels_once": k_once, "kernels_replay": k_replay,
            "trunk_addmm": dense, "fused": dense - len(extra),
            "not_fused": extra, "gemm_after_memset": memset,
            "bias_adds": adds, "kinds_us_once": kinds}
        print(f"bt4 dense B={B}: {dense - len(extra)} of {dense} trunk addmm "
              f"one kernel (not fused: {extra}; a memset before the GEMM: "
              f"{memset}); kernels per evaluation {k_once}, replay "
              f"{k_replay}; bias adds {adds}; device µs by kind {kinds}",
              flush=True)
        if k_replay != k_once:
            failed.append(f"B={B}: replay ran {k_replay} kernels, the eager "
                          f"forward {k_once}")
        if dense != 1 + 6 * net.cfg.layers or adds or extra:
            failed.append(f"B={B}: {dense} trunk addmm ({len(extra)} not one "
                          f"GEMM), {adds} bias adds")
    out["seconds"] = time.perf_counter() - t0
    print(f"bt4 dense phase {out['seconds']:.0f} s", flush=True)
    if check and failed:
        raise AssertionError("; ".join(failed))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full record to this "
                    "JSON file")
    ap.add_argument("--distributed-child", metavar="OUT",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if args.distributed_child:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _distributed_child(args.distributed_child)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi, build_s = phase_build()
    kernels = phase_kernels()
    t_kernels = time.perf_counter() - t0
    search = phase_search()
    selfplay, examples = phase_selfplay()
    bench = phase_bench()
    bf16 = phase_bf16()
    reuse = phase_reuse()
    reference = phase_reference()
    graphs = phase_graphs()
    bt4_dense = phase_bt4_dense()
    train = phase_train(examples)
    with tempfile.TemporaryDirectory() as keep:
        coach = phase_coach(keep)
        pit = phase_pit(os.path.join(keep, "temp.pt"))
    export = phase_export()
    distributed = phase_distributed()
    tooling = phase_tooling(examples)
    total_s = time.perf_counter() - t0
    print(f"kernel phase {t_kernels:.0f} s of {total_s:.0f} s", flush=True)
    print(f"profiled calls that kept too few records in 8 windows: "
          f"{PROFILER_SHORT}", flush=True)

    kb = kernels["fused_backup"]
    line = {"kernels": [{
        "name": "fused_backup", "route": "cuda",
        "source": "alphazero_tpu_torch/ops/csrc/fused_backup.cu",
        "replaces": "alphazero_tpu/ops/fused_backup.py:118",
        "launches": (search["launches"] + selfplay["launches"]
                     + bench["launches"] + coach["launches"]
                     + reuse["launches"] + pit["launches"]
                     + distributed["launches"] + tooling["launches"]),
        "max_abs_err": max(kb["max_abs_err"], coach["backup_max_abs_err"],
                           reuse["max_abs_err"], pit["backup_max_abs_err"],
                           distributed["backup_max_abs_err"],
                           tooling["backup_max_abs_err"]),
        "ms": kb["ms"],
        "plain_ms": kb["plain_ms"], "bound_ms": kb["bound_ms"],
        "bound_by": kb["bound_by"], "library_ms": kb["library_ms"]}]}
    kd = kernels["descent"]
    paths = (search, selfplay, bench, coach, reuse, pit, distributed,
             tooling)
    line["kernels"].append({
        "name": "descent", "route": "cuda",
        "source": "alphazero_tpu_torch/ops/csrc/descent.cu",
        "replaces": "alphazero_tpu/search/mcts.py:293",
        "launches": sum(p["descents"] for p in paths),
        "max_abs_err": kd["max_abs_err"], "ms": kd["ms"],
        "plain_ms": kd["plain_ms"], "bound_ms": kd["work_bound_ms"],
        "bound_by": kd["work_bound_by"], "library_ms": None,
        "latency_floor_ms": kd["latency_floor_ms"]})
    if [p["descents"] for p in paths] != [p["launches"] for p in paths]:
        raise AssertionError("descent and backup launches differ on a path")
    if [p["descents"] for p in paths] != [p["steps"] for p in paths]:
        raise AssertionError("descent and env-step launches differ on a path")
    ke = kernels["env_step"]
    line["kernels"].append({
        "name": "env_step", "route": "cuda",
        "source": "alphazero_tpu_torch/ops/csrc/env_step.cu",
        "replaces": "alphazero_tpu/games/splendor/adapter.py:53",
        "launches": (sum(p["steps"] for p in paths) + reuse["move_steps"]
                     + bf16["steps"]),
        "max_abs_err": ke["max_abs_err"], "ms": ke["ms"],
        "plain_ms": ke["plain_ms"], "bound_ms": ke["bound_ms"],
        "bound_by": ke["bound_by"], "library_ms": None,
        "launch_floor_ms": ke["launch_floor_ms"]})
    kbb, kbd = kernels["fused_backup_bf16"], kernels["descent_bf16"]
    bb, bd = kbb["shapes"]["B1024_M65"], kbd["shapes"]["B1024_M65"]
    line["kernels"].append({
        "name": "fused_backup_bf16", "route": "cuda",
        "source": "alphazero_tpu_torch/ops/csrc/fused_backup.cu",
        "replaces": "alphazero_tpu/ops/fused_backup.py:118",
        "launches": bf16["launches"],
        "max_abs_err": kbb["max_abs_err"], "ms": bb["ms"],
        "plain_ms": bb["plain_ms"], "bound_ms": bb["bound_ms"],
        "bound_by": bb["bound_by"], "library_ms": bb["library_ms"]})
    line["kernels"].append({
        "name": "descent_bf16", "route": "cuda",
        "source": "alphazero_tpu_torch/ops/csrc/descent.cu",
        "replaces": "alphazero_tpu/search/mcts.py:293",
        "launches": bf16["descents"],
        "max_abs_err": kbd["max_abs_err"], "ms": bd["ms"],
        "plain_ms": bd["plain_ms"], "bound_ms": bd["work_bound_ms"],
        "bound_by": bd["work_bound_by"], "library_ms": None,
        "latency_floor_ms": bd["latency_floor_ms"]})
    record = {"card": smi, "build_s": build_s, "seconds": total_s,
              "kernels": kernels,
              "search": search, "selfplay": selfplay, "bench": bench,
              "bf16": bf16,
              "reuse": reuse,
              "reference": reference, "graphs": graphs,
              "bt4_dense": bt4_dense,
              "train": train, "coach": coach,
              "pit": pit, "export": export, "distributed": distributed,
              "tooling": tooling, "profiler_short": PROFILER_SHORT,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print("bench rows: " + json.dumps(
        {"cli.bench": bench["search"],
         "bench.selfplay_row": bench["bench.selfplay_row"],
         "bench_selfplay.row": bench["bench_selfplay.row"]}))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
