"""The harness: cells, configurations, traffic kinds and metrics found by
name (a new cell needs new files only); the rate over whole calls, the
90th percentile, the FLOP and byte counts and the trace reduction; a run
without a card failing; what a run loads."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import core, program, trace, work

ROOT = core.ROOT


def test_benchmark_names_resolve_to_files():
    bench = core.benchmark()
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert core.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        cell = core.workload(w["name"])
        assert cell["config"] == w["config"] in names
        assert (cell["traffic"], cell["chips"], cell["why"]) == \
            (w["traffic"], w["chips"], w["why"])
        assert hasattr(core.module("traffic", cell["kind"]), "Cell")
    for m in bench["per_layer"]:
        assert callable(core.module("metrics", m["name"]).read)
        for w in m.get("workloads", []):
            core.workload(w)


DUMMY_TRAFFIC = '''
"""A traffic kind that runs no program: a fixed amount of counted work."""
import time


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self):
        pass

    def window(self, seconds):
        t0 = time.perf_counter()
        n = 0
        while not n or time.perf_counter() - t0 < seconds:
            n += self.ctx.cell["params"]["work"]
        return {"dummy_per_s": n / (time.perf_counter() - t0)}

    def traced(self):
        reduced = {"window_s": 2.0, "busy_s": 0.5, "kernels": 10,
                   "kernel_s": {}, "span_s": {}, "device_ops": [],
                   "idle_gaps": []}
        return reduced, {"units": 4}

    def release(self):
        pass

    def check(self):
        return [("dummy_gap", 0.0, self.ctx.cell["limits"]["dummy_gap"])], 1, 0
'''

DUMMY_METRIC = '''
def read(data):
    return data["trace"]["kernels"] / data["counts"]["units"]
'''


def test_a_new_cell_needs_new_files_only(tmp_path):
    """A configuration, a cell, a traffic kind and a per-layer metric added
    as new files (and new entries of ``BENCHMARK.json``) run, and no file
    the benchmark had changes."""
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "h100bench").rglob("*")
              if p.is_file()}
    pkg = tmp_path / "h100bench"
    (pkg / "configs" / "dummy-cfg.json").write_text(json.dumps(
        {"name": "dummy-cfg", "size": 3}))
    (pkg / "workloads" / "dummy-cfg.loop.json").write_text(json.dumps(
        {"config": "dummy-cfg", "traffic": "loop", "kind": "dummy_loop",
         "chips": 1, "why": "a test", "reduced": [],
         "params": {"work": 5}, "limits": {"dummy_gap": 0.0}}))
    (pkg / "traffic" / "dummy_loop.py").write_text(DUMMY_TRAFFIC)
    (pkg / "metrics" / "dummy.kernels_per_unit.py").write_text(DUMMY_METRIC)
    bench = core.benchmark()
    bench["configs"].append({"name": "dummy-cfg", "source": "a test",
                             "file": "h100bench/configs/dummy-cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cfg.loop", "config": "dummy-cfg",
                               "traffic": "loop", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_per_s", "unit": "units/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy-cfg.loop"]})
    bench["per_layer"].append({"name": "dummy.kernels_per_unit",
                               "unit": "kernels/unit", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "dummy_per_s",
                               "workloads": ["dummy-cfg.loop"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent("""
        import json, sys
        from h100bench import core
        for t in (0, 1):
            out = core.run_cell("dummy-cfg.loop", 3, 0.05, bool(t), 0.0,
                                device="cpu", require=False)
            print(json.dumps(out))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert res.returncode == 0, res.stderr
    t0, t1 = (json.loads(x) for x in res.stdout.strip().splitlines())
    assert set(t0["metrics"]) == {"dummy_per_s", "setup_s"}
    assert t0["correct"] and t0["metrics"]["dummy_per_s"]["value"] > 0
    assert t1["metrics"] == {"dummy.kernels_per_unit": {"value": 2.5,
                                                        "unit": "kernels/unit"}}
    assert t1["device"]["busy_s"] == 0.5
    assert list(t1)[-1] == "checks"
    for p, b in before.items():
        assert p.read_bytes() == b, p


def test_metrics_for_a_cell():
    bench = core.benchmark()
    names = [m["name"] for m in core.metrics_for(
        bench, "splendor-2p-r6.selfplay", False)]
    assert names == ["rollouts_per_s", "setup_s"]
    per = [m["name"] for m in core.metrics_for(
        bench, "splendor-4p-r12.move-b1", True)]
    assert "search.kernels_per_sim.move" in per
    assert "mfu.selfplay" not in per


def test_derived_seeds_take_any_whole_number():
    for s in (0, 1, -5, 2 ** 31 + 7, 2 ** 40, -(2 ** 63)):
        a = core.derived_seed(s, 0)
        assert 0 <= a < 2 ** 63 and a == core.derived_seed(s, 0)
        assert a != core.derived_seed(s, 1)
    torch.Generator().manual_seed(core.derived_seed(2 ** 33, 4))


def test_selfplay_rate_is_over_whole_calls():
    """The rate is every whole call's rollouts over the window's time, and
    every call plays all its moves."""
    ov = {"config": {"selfplay_batch": 6, "num_sims": 8},
          "params": {"plies": 2}}
    cell = core.workload("splendor-2p-r6.selfplay")
    cell = {**cell, "params": {**cell["params"], **ov["params"]}}
    cfg = {**core.config(cell["config"]), **ov["config"]}
    runner = core.module("traffic", "selfplay").Cell(core.Context(
        cell, cfg, 9, torch.device("cpu"), ROOT))
    runner.setup()
    out = runner.window(0.4)
    # plies x (round(0.3 x 6) full boards x S + 4 fast boards x S/4)
    per_call = 2 * (2 * 8 + 4 * 2)
    assert [c[4] for c in runner.calls] == [per_call] * len(runner.calls)
    assert out["rollouts_per_s"] == pytest.approx(
        per_call * len(runner.calls) / runner.window_s, rel=1e-12)
    assert runner.window_s >= 0.4


def test_move_p90_is_over_every_request():
    cell = core.workload("splendor-4p-r12.move-b1")
    cell = {**cell, "params": {**cell["params"], "num_sims": 4, "pool": 8}}
    runner = core.module("traffic", "move_b1").Cell(core.Context(
        cell, core.config(cell["config"]), 9, torch.device("cpu"), ROOT))
    runner.setup()
    out = runner.window(0.3)
    lats = np.array(runner.latencies)
    assert len(lats) == len(runner.requests) >= 2
    assert out["move_ms_p90"] == pytest.approx(
        np.percentile(lats, 90) * 1e3, rel=1e-12)


@pytest.mark.parametrize("players", [2, 4])
def test_forward_flops_match_the_reference_net(players):
    """The FLOP count from shapes equals what the plain net's matmuls do
    (it computes the policy and value heads, no score-difference head)."""
    cfg = core.config("splendor-2p-r6" if players == 2 else
                      "splendor-4p-r12")
    ck = program.checkpoint(ROOT, cfg)
    net = program.ref_net(cfg, ck, "cpu")
    rows = work.rows(players)
    boards = torch.zeros(5, rows, 7)
    valid = torch.ones(5, 409, dtype=torch.bool)
    with FlopCounterMode(display=False) as fc:
        net(boards, valid)
    assert fc.get_total_flops() == 5 * work.forward_flops(rows, 128, 409,
                                                          players)


def test_env_step_bytes():
    # 1,217 bytes per 2-player board: the state read and written (2 x 392),
    # the action (8), the terminal vector (8), the mask (409), the advance
    assert work.env_step_bytes(1, 2) - work.env_step_bytes(0, 2) == 1217
    assert work.env_step_bytes(0, 2) == 3328 + 4 * 56
    assert work.env_step_bytes(10, 4) == 10 * (2 * 88 * 7 + 8 + 16 + 409 + 8) \
        + 3328 + 4 * 88
    assert [work.rows(p) for p in (2, 3, 4)] == [56, 71, 88]


def test_trace_reduce():
    window = (10.0, 20.0)
    dev = [(9.0, 10.5, "k0", "kernel"),            # clipped to the window
           (11.0, 12.0, "env_step_kernel<1>", "kernel"),
           (11.5, 13.0, "k2", "kernel"),           # overlaps the one before
           (15.0, 15.5, "Memcpy HtoD", "gpu_memcpy"),
           (21.0, 22.0, "k3", "kernel")]           # outside
    spans = [(10.0, 14.0, "mcts.evaluate"), (14.0, 16.0, "mcts.backup")]
    r = trace.reduce(window, dev, spans)
    assert r["window_s"] == 10.0
    assert r["busy_s"] == pytest.approx(0.5 + 2.0 + 0.5)
    assert r["kernels"] == 3
    assert r["span_s"] == {"mcts.evaluate": 4.0, "mcts.backup": 2.0}
    idle = dict(r["idle_gaps"])
    assert idle["mcts.evaluate"] == pytest.approx(0.5 + 1.0)
    assert idle["mcts.backup"] == pytest.approx(1.0 + 0.5)
    assert idle["outside the spans"] == pytest.approx(4.0)
    assert trace.kernel_time(r, "env_step_kernel") == (1.0, 1)
    with pytest.raises(trace.NoDeviceWork):
        trace.reduce(window, [(15.0, 15.5, "Memcpy", "gpu_memcpy")], spans)


def test_traced_run_without_device_kernels_fails():
    with pytest.raises(trace.NoDeviceWork):
        core.run_cell("splendor-4p-r12.move-b1", 1, 0.0, True, 0.0,
                      device="cpu", require=False,
                      overrides={"params": {"num_sims": 4, "pool": 8,
                                            "trace_requests": 1}})


def _no_card_env():
    return {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def test_a_run_without_a_card_fails_and_prints_nothing():
    res = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload",
         "splendor-2p-r6.selfplay", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=_no_card_env())
    assert res.returncode != 0
    assert res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr


def test_a_run_from_the_benchmark_files_alone_fails(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the benchmark's folder
    has no program to measure."""
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload",
         "splendor-2p-r6.selfplay", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={**_no_card_env(), "PYTHONPATH": ""})
    assert res.returncode != 0 and res.stdout == ""


ISOLATION = """
import sys
{body}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "alphazero_tpu",
                      "alphazero_tpu_torch"}}))
"""


def _loaded(body: str) -> list:
    res = subprocess.run([sys.executable, "-c", ISOLATION.format(body=body)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return eval(res.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_program():
    assert _loaded("from h100bench.reference import actor, ckpt, env, net, "
                   "search, tables") == []


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole (tiny, CPU) run of every cell loads the program and nothing
    whose top-level name is jax, jaxlib, flax or alphazero_tpu."""
    body = textwrap.dedent("""
        from h100bench import core
        core.run_cell("splendor-2p-r6.selfplay", 4, 0.0, False, 0.0,
                      device="cpu", require=False,
                      overrides={"config": {"selfplay_batch": 4,
                                            "num_sims": 4},
                                 "params": {"plies": 1}})
        core.run_cell("splendor-4p-r12.move-b1", 4, 0.0, False, 0.0,
                      device="cpu", require=False,
                      overrides={"params": {"num_sims": 4, "pool": 8}})
        assert core.loaded_banned() == []
    """)
    assert _loaded(body) == ["alphazero_tpu_torch"]
