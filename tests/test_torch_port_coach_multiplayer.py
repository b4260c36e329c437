"""The port's 3-player ``Coach.learn`` iteration, held to the invariants of
``tests/test_coach_multiplayer.py`` on the CPU: the arena gate rotates the
candidate through all three seats (one game per rotation), the baseline
probe plays ``eval_baseline_games // 3`` games per seat in each of the
three seats, and the record holds the 1/3 fair share.

The JAX test's config (seed 3) with the ``score_win`` rule lever at 2
points, which keeps the games short.
"""

import json
import os

import numpy as np

from alphazero_tpu_torch.train.coach import Coach, CoachConfig
from tests.test_torch_port_train import _one_thread  # noqa: F401


def test_three_player_learn_iteration(tmp_path):
    cfg = CoachConfig(num_players=3, score_win=2, num_iters=1,
                      games_per_iter=4, selfplay_batch=4, num_sims=8,
                      ratio_full=2, prob_full=0.5, arena_games=3,
                      gate_num_sims=6, epochs=1, batch_size=8,
                      eval_baseline_games=6, eval_num_sims=6,
                      checkpoint_dir=str(tmp_path), seed=3)
    coach = Coach(cfg, device="cpu")
    seen = {}

    def cb(it, sp, metrics, gate, accept):
        seen["sp"], seen["metrics"], seen["gate"] = sp, metrics, gate

    coach.learn(on_iteration=cb)
    assert seen["sp"]["examples"] > 0
    assert np.isfinite(seen["metrics"]["loss"])
    nw, ow, dr = seen["gate"]
    assert nw + ow + dr == 3          # one game per seat rotation
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        rec = json.loads(f.readlines()[-1])
    for nm in ("random", "greedy"):
        tot = (rec[f"wins_vs_{nm}"] + rec[f"losses_vs_{nm}"]
               + rec[f"draws_vs_{nm}"])
        assert tot == 6               # (6 // 3 players) games per seat x 3
        assert 0.0 <= rec[f"winrate_vs_{nm}"] <= 1.0
    assert abs(rec["eval_fair_share"] - 1 / 3) < 1e-9
