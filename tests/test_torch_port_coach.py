"""The port's Coach and training CLI, held to the invariants of the JAX
package's coach tests (``tests/test_coach_two_player.py``,
``test_gate_modes.py``, ``test_resume_continuity.py``) on the CPU.

Games are kept short with the ``score_win`` rule lever (2 points); one
finished run is shared by the checks that only read it.  Resume
continuity and the CLI are in ``test_torch_port_cli.py``.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from alphazero_tpu.train import coach as JC
from alphazero_tpu_torch.train.coach import (Coach, CoachConfig,
                                             completed_iterations)
from tests.test_torch_port_train import _one_thread  # noqa: F401

# the keys of the JAX coach's metrics.jsonl record (coach.py:431-453)
RECORD_KEYS = {
    "iter", "selfplay_games", "selfplay_examples", "selfplay_rollouts",
    "selfplay_seconds", "selfplay_rollouts_per_s", "train_loss", "train_pi",
    "train_v", "train_scdiff", "train_v_out_mean", "train_v_out_std",
    "train_v_out_absmean", "train_vl_scale", "gate_new", "gate_old",
    "gate_draws", "gate_winrate", "gate_bar", "gate_stderr", "accepted",
    "gate_passed_bar", "gate_mode", "replay_examples", "iter_seconds"}
EVAL_KEYS = {f"{w}_vs_{o}" for w in ("wins", "losses", "draws", "winrate")
             for o in ("random", "greedy")} | {"eval_fair_share"}


def _cfg(path, **kw):
    base = dict(num_players=2, score_win=2, num_iters=1, games_per_iter=4,
                selfplay_batch=4, num_sims=8, ratio_full=2, prob_full=0.5,
                arena_games=4, gate_num_sims=4, epochs=1, batch_size=8,
                train_chunk_steps=4, checkpoint_dir=str(path), seed=1)
    base.update(kw)
    return CoachConfig(**base)


def _params(coach):
    return {k: v.detach().clone() for k, v in
            coach.train_state.net.state_dict().items()}


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One iteration with the baseline probe on; returns what it saw."""
    path = tmp_path_factory.mktemp("coach")
    torch.set_num_threads(1)
    coach = Coach(_cfg(path, eval_baseline_games=2), device="cpu")
    seen = {}

    def cb(it, sp, metrics, gate, accept):
        seen.update(sp=sp, metrics=metrics, gate=gate, accept=accept)
    coach.learn(on_iteration=cb)
    return path, coach, seen


def test_config_fields_equal():
    want = {f.name: f.default for f in dataclasses.fields(JC.CoachConfig)}
    assert {f.name: f.default
            for f in dataclasses.fields(CoachConfig)} == want


def test_two_player_learn_iteration(run):
    path, coach, seen = run
    assert seen["sp"]["examples"] > 0
    assert np.isfinite(seen["metrics"]["loss"])
    nw, ow, dr = seen["gate"]
    assert nw + ow + dr == 4
    assert os.path.exists(path / "temp.pt")
    assert os.path.exists(path / "checkpoint.examples")
    assert os.path.exists(path / "settings.json")
    assert os.path.exists(path / "best.pt") == seen["accept"]
    rec = _records(path)[-1]
    assert set(rec) == RECORD_KEYS | EVAL_KEYS
    assert rec["iter"] == 1 and rec["accepted"] == seen["accept"]
    assert rec["wins_vs_random"] + rec["losses_vs_random"] + \
        rec["draws_vs_random"] == 2
    # resume restores replay examples and weights without error
    coach2 = Coach(coach.cfg, device="cpu")
    coach2.load_checkpoint(str(path), "temp.pt")
    assert len(coach2.replay) == seen["sp"]["examples"]


def test_gate_mode_always_accepts_and_keeps_trained_params(tmp_path):
    coach = Coach(_cfg(tmp_path, gate_mode="always", update_threshold=1.01),
                  device="cpu")
    before = _params(coach)
    seen = {}
    coach.learn(on_iteration=lambda *a: seen.update(accept=a[-1]))
    assert seen["accept"] and os.path.exists(tmp_path / "best.pt")
    after = _params(coach)
    assert max((a - before[k]).abs().max().item()
               for k, a in after.items()) > 0
    rec = _records(tmp_path)[-1]
    assert rec["accepted"] is True and rec["gate_mode"] == "always"
    assert rec["gate_passed_bar"] is False


def test_gate_mode_threshold_rolls_back(run, tmp_path):
    coach = Coach(_cfg(tmp_path, gate_mode="threshold",
                       update_threshold=1.01), device="cpu")
    before = _params(coach)
    coach.learn()
    after = _params(coach)
    for k in before:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(after[k], before[k]), k
    assert _records(tmp_path)[-1]["accepted"] is False


def test_vl_warmup_scales_value_loss(run, tmp_path):
    path = run[0]
    coach = Coach(_cfg(tmp_path, vl_warmup_iters=10), device="cpu")
    coach.load_checkpoint(str(path), "temp.pt")
    m1 = coach.train_iteration(it=1)
    assert m1["vl_scale"] == 0.1
    m10 = coach.train_iteration(it=10)
    assert m10["vl_scale"] == 1.0
    assert "v_out_std" in m1 and "v_out_absmean" in m1


def test_nan_loss_rolls_back_and_resets_adam(run, tmp_path):
    for f in ("temp.pt", "checkpoint.examples"):
        shutil.copy(run[0] / f, tmp_path / f)
    coach = Coach(_cfg(tmp_path), device="cpu")
    coach.load_checkpoint(str(tmp_path), "temp.pt")
    with torch.no_grad():
        coach.train_state.net.dense_0.weight.fill_(float("nan"))
    metrics = coach.train_iteration(it=1)
    assert not np.isfinite(metrics["loss"])
    assert all(torch.isfinite(p).all()
               for p in coach.train_state.net.parameters())
    assert len(coach.train_state.opt.state) == 0        # fresh moments


def test_completed_iterations_tolerates_malformed_lines(tmp_path):
    (tmp_path / "metrics.jsonl").write_text(
        '{"iter": 3}\n{"iter": null}\n[1, 2]\n"just a string"\n'
        '{"iter": {"nested": 1}}\n{"iter": 5}\nnot json at all\n{bad json\n')
    assert completed_iterations(str(tmp_path)) == 5
    assert completed_iterations(str(tmp_path / "missing")) == 0
