"""A run whose timed path is broken underneath comes out ``correct: false``.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a tiny size, with one fault planted in the program: a step
that returns its state unchanged, half of the batch left out, an answer
altered where it is produced.  (No cell runs on more than one chip, so no
exchange between chips can be left out.)"""

from __future__ import annotations

import pytest
import torch

from h100bench import core

from alphazero_tpu_torch.cli import pit
from alphazero_tpu_torch.ops import env_step as ES
from alphazero_tpu_torch.search import mcts as M
from alphazero_tpu_torch.train import selfplay as SP

SELFPLAY = {"config": {"selfplay_batch": 6, "num_sims": 8},
            "params": {"plies": 3, "check_plies": 2}}
MOVE = {"params": {"num_sims": 8, "pool": 16, "check_requests": 4}}


def _run(cell, overrides, seconds=0.0):
    return core.run_cell(cell, 2 ** 31 + 11, seconds, False, 0.0,
                         device="cpu", require=False, overrides=overrides)


def _unchanged_step(cfg, states, actions):
    """The in-tree step returning each parent's state unchanged."""
    _, term, valid, adv = ES.search_step_plain(cfg, states, actions)
    return states.clone(), term, valid, adv


def _half_backup(stats, *args):
    """The backup applied to the first half of the boards only."""
    half = stats.shape[0] // 2
    kept = stats[half:].clone()
    out = ES_BACKUP(stats, *args)
    stats[half:] = kept
    return out


ES_BACKUP = M.backprop_packed


def _altered_sample(counts, temp, gumbel):
    return (SP_SAMPLE(counts, temp, gumbel) + 1) % counts.shape[1]


SP_SAMPLE = SP.sample_actions


@pytest.mark.parametrize("cell,overrides", [
    ("splendor-2p-r6.selfplay", SELFPLAY),
    ("splendor-4p-r12.selfplay", SELFPLAY),
    ("splendor-4p-r12.move-b1", MOVE)])
def test_sound_run_is_correct(cell, overrides):
    assert _run(cell, overrides, 0.3)["correct"]


@pytest.mark.parametrize("cell,overrides", [
    ("splendor-2p-r6.selfplay", SELFPLAY),
    ("splendor-4p-r12.move-b1", MOVE)])
def test_step_returning_its_state_unchanged(monkeypatch, cell, overrides):
    monkeypatch.setattr(ES, "search_step", _unchanged_step)
    out = _run(cell, overrides, 0.3)
    assert not out["correct"]
    assert out["checks"]["q_gap"]["value"] > out["checks"]["q_gap"]["limit"]


def test_half_of_the_batch_left_out(monkeypatch):
    monkeypatch.setattr(M, "backprop_packed", _half_backup)
    out = _run("splendor-2p-r6.selfplay", SELFPLAY)
    assert not out["correct"]
    assert out["checks"]["visits_tv"]["value"] > \
        out["checks"]["visits_tv"]["limit"]


def test_action_altered_where_it_is_produced(monkeypatch):
    monkeypatch.setattr(SP, "sample_actions", _altered_sample)
    out = _run("splendor-2p-r6.selfplay", SELFPLAY)
    assert not out["correct"]
    assert out["checks"]["actor_diffs"]["value"] > 0


def test_answer_altered_where_it_is_produced(monkeypatch):
    play = pit.MCTSPlayer.play

    def altered(self, board):
        return (play(self, board) + 1) % 409
    monkeypatch.setattr(pit.MCTSPlayer, "play", altered)
    out = _run("splendor-4p-r12.move-b1", MOVE, 0.3)
    assert not out["correct"]
    assert out["checks"]["answer_diffs"]["value"] > 0


def test_search_counts_altered(monkeypatch):
    """A search whose visit counts are altered after it ran (the actor's
    replay takes the counts as given, the search check does not)."""
    build = M.build_search

    def altered_build(*a, **k):
        search = build(*a, **k)

        def run(*aa, **kk):
            res = search(*aa, **kk)
            raw = torch.roll(res.raw_counts, 1, 1)
            return res._replace(raw_counts=raw, counts=raw.float())
        return run
    monkeypatch.setattr(M, "build_search", altered_build)
    out = _run("splendor-2p-r6.selfplay", SELFPLAY)
    assert not out["correct"]
