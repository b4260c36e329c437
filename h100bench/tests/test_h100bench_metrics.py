"""The readers of the program's spans and counters: each on hand-made
slices (counters present, absent, or a program without them; a trace
that kept fewer kernel records than launches), the roofline byte counts
equal to ``chip_smoke.py``'s (``_descent_times``' bytes, ``_entry_work``)
on every launch of small plain searches on the CPU, and (on a card) the
backup kernel's path counter equal to the launches' own inputs."""

from __future__ import annotations

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100bench import core, peaks
from h100bench.metrics import _kernel_bytes as K

CELLS = {"selfplay": "splendor-2p-r6.selfplay",
         "move": "splendor-4p-r12.move-b1"}


def _data(kind, spans, counters, kernels=None, sims=10):
    """A traced slice's ``data``; ``counters`` None leaves them to the
    program."""
    data = {"trace": {"span_s": spans, "kernel_s": kernels or {}},
            "counts": {"sims": sims}, "cell": core.workload(CELLS[kind])}
    if counters is not None:
        data["counters"] = counters
    return data


def _read(name, data):
    return core.module("metrics", name).read(data)


SPAN_READERS = [
    # (metric, cell kind, its spans, its counter or None: the cell's sims)
    ("selfplay.actor_ms_per_ply", "selfplay",
     ("selfplay.split", "selfplay.move", "selfplay.host"), "selfplay.plies"),
    ("search.outer_ms_per_search.selfplay", "selfplay",
     ("mcts.root", "mcts.result"), "mcts.searches"),
    ("search.store_ms_per_sim.selfplay", "selfplay", ("mcts.store",), None),
    ("move.overhead_ms_per_request", "move",
     ("player.upload", "player.answer", "mcts.root", "mcts.store",
      "mcts.result"), "player.requests"),
]


@pytest.mark.parametrize("name,kind,spans,counter", SPAN_READERS)
def test_span_readers(name, kind, spans, counter, monkeypatch):
    secs = {s: 0.01 * (i + 1) for i, s in enumerate(spans)}
    secs["mcts.evaluate"] = 5.0                     # read by none of them
    n = 4 if counter else 10
    counters = {counter: 4} if counter else {}
    got = _read(name, _data(kind, secs, counters))
    assert got == pytest.approx(sum(secs[s] for s in spans) * 1e3 / n)
    # a slice without the spans (the parent program's)
    assert _read(name, _data(kind, {"mcts.evaluate": 5.0}, counters)) is None
    if counter:
        assert _read(name, _data(kind, secs, {})) is None
        # a program whose profiling module has no counters
        from alphazero_tpu_torch.utils import profiling
        monkeypatch.delattr(profiling, "counters")
        assert _read(name, _data(kind, secs, None)) is None


ROOFLINES = [
    ("descent_roofline.selfplay", "descent_kernel",
     ("mcts.path_levels", "mcts.board_sims", "mcts.path_cells"),
     K.descent_bytes),
    ("backup_roofline.selfplay", "fused_backup_entry",
     ("mcts.path_levels", "mcts.installs", "mcts.board_sims"),
     lambda *c: K.backup_bytes(*c, 2)),
]


@pytest.mark.parametrize("name,kernel,names,nbytes", ROOFLINES)
def test_roofline_readers(name, kernel, names, nbytes, monkeypatch):
    counters = dict(zip(names, (900, 700, 4000)))
    want = nbytes(900, 700, 4000)
    rows = {f"void (anonymous namespace)::{kernel}<float>(...)": (2e-5, 10),
            "other_kernel": (1.0, 10)}
    got = _read(name, _data("selfplay", {}, counters, rows, sims=10))
    assert got == pytest.approx(want / peaks.HBM_BYTES_PER_S / 2e-5 * 100)
    # the trace kept 8 of 10 launches' records: the bytes of 8
    rows[next(iter(rows))] = (1.6e-5, 8)
    got8 = _read(name, _data("selfplay", {}, counters, rows, sims=10))
    assert got8 == pytest.approx(got)
    for c in ({}, {names[0]: 900}):                 # counters absent
        assert _read(name, _data("selfplay", {}, c, rows)) is None
    assert _read(name, _data("selfplay", {}, counters, {})) is None
    from alphazero_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "counters")
    assert _read(name, _data("selfplay", {}, None, rows)) is None


def _search(players, dev, B, S, max_depth, monkeypatch, kept, backups):
    """One profiled plain or kernel search with root noise and forced
    playouts; every descent's ``(cfg, stats, sim, cap, levels, depth)``
    in ``kept`` and every backup's arguments in ``backups``."""
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.search import mcts as M
    cfg = E.SplendorConfig(num_players=players)
    mcfg = M.MCTSConfig(num_sims=S, max_depth=max_depth, add_noise=True,
                        forced_playouts=True)
    select, backup = M._select, M.backprop_packed

    def recorded_select(cfg_, stats, i, cap, levels):
        out = select(cfg_, stats, i, cap, levels)
        kept.append((cfg_, stats, i, cap, levels, out[3]))
        return out

    def recorded_backup(stats, *args):
        backups.append((stats.shape, args))
        return backup(stats, *args)
    monkeypatch.setattr(M, "_select", recorded_select)
    monkeypatch.setattr(M, "backprop_packed", recorded_backup)
    search = M.build_search(mcfg, players, A.make_uniform_eval_fn(cfg),
                            A.make_search_step_fn(cfg), A.make_valid_fn(cfg),
                            dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    roots = E.initial_state(cfg, B, gen, dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.device(dev).type == "cuda"
                                     else [])
    with counted() as got, profile(activities=acts):
        search(None, roots, generator=gen)
    return got


@contextlib.contextmanager
def counted():
    """The program's counts of the block (the counters only grow)."""
    from alphazero_tpu_torch.utils import profiling
    before, got = profiling.counters(), {}
    yield got
    got.update((k, v - before.get(k, 0))
               for k, v in profiling.counters().items())


@pytest.mark.parametrize("players", [2, 4])
def test_roofline_bytes_equal_chip_smoke(players, monkeypatch):
    import chip_smoke as CS
    kept, backups = [], []
    got = _search(players, "cpu", 3, 12, 4, monkeypatch, kept, backups)
    assert len(kept) == len(backups) == 12
    # _descent_times' bytes, its timing left out (no card here)
    monkeypatch.setattr(CS, "_device_ms", lambda *a, **k: 1.0)
    monkeypatch.setattr(CS, "_time_host_ms", lambda *a, **k: 1.0)
    want_descent = CS._descent_times(kept, 0.0)["bytes"] * len(kept)
    want_backup = 0
    for shape, args in backups:
        want_backup += CS._entry_work(torch.empty(shape), *args)[0]
    levels = sum(int(k[5].sum()) for k in kept)
    assert got["mcts.path_levels"] == levels
    assert got["mcts.board_sims"] == 3 * 12
    assert K.descent_bytes(got["mcts.path_levels"], got["mcts.board_sims"],
                           got["mcts.path_cells"]) == \
        pytest.approx(want_descent, rel=1e-12)
    assert K.backup_bytes(got["mcts.path_levels"], got["mcts.installs"],
                          got["mcts.board_sims"], players) == want_backup


def test_kernel_path_counter_equals_the_launches_inputs(card, monkeypatch):
    """The backup kernel's counter, on a search's launches and on made-up
    arguments (some depths past the path buffer), equals the live levels
    and installs of its inputs, and counting leaves its results equal to
    the plain version's."""
    import chip_smoke as CS
    from alphazero_tpu_torch.ops import fused_backup as FB
    kept, backups = [], []
    got = _search(2, "cuda", 64, 32, 8, monkeypatch, kept, backups)

    def want(calls):
        levels = installs = 0
        for _, args in calls:
            path_p, depth, fresh, slot = args[0], args[3], args[8], args[9]
            levels += int(depth.long().clamp(0, path_p.shape[1]).sum())
            installs += int((fresh & (slot != 0)).sum())
        return levels, installs
    assert (got["mcts.path_levels"], got["mcts.installs"]) == want(backups)
    assert got["mcts.installs"] > 0
    g = torch.Generator(device=card).manual_seed(3)
    calls = []
    with counted() as got:
        for slot in ("per_board", 7):
            stats, *args = CS._made_up_entry_args(96, 40, 409, 70, 3, g,
                                                  card, slot)
            args[3][1::5] = 70 + 9                  # past the buffer
            plain = stats.clone()
            FB.backprop_packed_plain(plain, *args)
            with profile(activities=[ProfilerActivity.CUDA]):
                FB.backprop_packed(stats, *args)
            calls.append((stats.shape, args))
            torch.testing.assert_close(stats, plain, rtol=0, atol=0)
    assert (got["mcts.path_levels"], got["mcts.installs"]) == want(calls)
