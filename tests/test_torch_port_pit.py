"""The port's ratings book and batched pit CLI.

- ``RatingBook`` gives the JAX book's ratings exactly for the same
  matches, and each package reads the other's JSON file.
- ``pit.main(... --batched)`` prints the JAX pit's one-line JSON record;
  greedy beats random.
- ``--batched --tournament`` plays every pair of the checkpoints the port
  saved under a directory and writes a ratings book that JAX reads.
- ``test_pit_modes``: the sequential pit plays random vs greedy;
  ``alphabeta`` under ``--batched`` plays (depth 1, a pool of 2 CPU
  workers); ``--batched`` with ``--record-dir`` or ``--token-limits`` is a
  parser error that names the sequential mode; ``human`` under
  ``--batched`` fails as the JAX pit does (it is read as a checkpoint
  path).
- A ``Coach.learn`` iteration runs with ``tree_reuse=True`` (what
  ``cli.main --tree-reuse`` sets).
"""

import json

import pytest
import torch

from alphazero_tpu.cli import pit as JPIT
from alphazero_tpu.eval import glicko2 as JG
from alphazero_tpu_torch.cli import pit as PIT
from alphazero_tpu_torch.eval import ab_pool as AB
from alphazero_tpu_torch.eval import glicko2 as G
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.train.coach import Coach
from alphazero_tpu_torch.utils import checkpoint as C
from tests.test_torch_port_coach import _cfg, _records
from tests.test_torch_port_train import _one_thread  # noqa: F401

# the record of the JAX ``play_batched`` (alphazero_tpu/cli/pit.py)
JAX_KEYS = ["players", "num_players", "games", "wins", "losses", "draws",
            "winrate", "sims", "ab_depth", "ab_deadline", "seconds"]


def _ratings(book):
    return {k: vars(v) for k, v in book.ratings.items()}


def test_rating_books_interchangeable(tmp_path):
    matches = [("a", "b", 1.0), ("b", "c", 0.5), ("a", "c", 0.0),
               ("c", "a", 0.75), ("b", "a", 0.25), ("d", "a", 1.0)]
    jbook = JG.RatingBook(str(tmp_path / "jax.json"))
    book = G.RatingBook(str(tmp_path / "port.json"))
    for a, b, score in matches:
        jbook.record_match(a, b, score)
        book.record_match(a, b, score)
    assert _ratings(book) == _ratings(jbook)
    assert book.ratings["a"].rating != 1500.0
    jbook.save()
    book.save()
    assert ((tmp_path / "jax.json").read_bytes()
            == (tmp_path / "port.json").read_bytes())
    assert _ratings(JG.RatingBook.load(book.path)) == _ratings(book)
    assert _ratings(G.RatingBook.load(jbook.path)) == _ratings(jbook)


def test_pit_batched_random_vs_greedy(capsys):
    out = PIT.main(["random", "greedy", "--batched", "-n", "4", "--seed", "3",
                    "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert list(out) == JAX_KEYS
    assert out["players"] == ["random", "greedy"] and out["games"] == 4
    assert out["wins"] + out["losses"] + out["draws"] == 4
    assert out["losses"] > out["wins"]             # greedy wins most


def _save_net(folder, name, seed):
    cfg = E.SplendorConfig()
    net = N.build_net(A.net_config_for(cfg, width=48), "cpu",
                      torch.Generator().manual_seed(seed))
    params, batch_stats = N.to_flax(net.state_dict())
    folder.mkdir()
    C.save_checkpoint(str(folder), name, params=params,
                      batch_stats=batch_stats,
                      meta={"nn_version": 1, "net_width": 48, "num_sims": 2})


def test_pit_tournament_writes_a_book_jax_reads(tmp_path, capsys):
    _save_net(tmp_path / "a", "best.pt", 1)
    _save_net(tmp_path / "b", "checkpoint_3.pt", 2)
    (tmp_path / "b" / "temp.pt").write_bytes(b"")      # not a candidate
    ratings = tmp_path / "ratings.json"
    book = PIT.main(["--batched", "--tournament", str(tmp_path), "-n", "2",
                     "-m", "2", "--ratings", str(ratings), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "tournament (batched): 2 checkpoints" in out
    assert "a/best.pt vs b/checkpoint_3.pt:" in out
    jbook = JG.RatingBook.load(str(ratings))
    assert sorted(jbook.ratings) == ["a/best.pt", "b/checkpoint_3.pt"]
    assert _ratings(jbook) == _ratings(book)
    assert {r["rd"] for r in _ratings(jbook).values()} != {350.0}


@pytest.mark.parametrize("mode", ["sequential", "alphabeta_batched",
                                  "record_dir_batched", "token_limits_batched",
                                  "human_batched"])
def test_pit_modes(mode, monkeypatch, capsys):
    cpu = ["--device", "cpu"]
    if mode == "sequential":
        wins, draws, scores = PIT.main(["random", "greedy", "-n", "2",
                                        "--seed", "1"] + cpu)
        assert sum(wins) + draws == 2 and scores.shape == (2,)
        assert "result: wins=" in capsys.readouterr().out
    elif mode == "alphabeta_batched":
        monkeypatch.setattr(AB.os, "cpu_count", lambda: 2)
        out = PIT.main(["alphabeta", "greedy", "--batched", "-n", "2",
                        "--ab-depth", "1", "--ab-deadline", "0.5"] + cpu)
        assert out["games"] == 2 and out["ab_depth"] == 1
    elif mode == "human_batched":
        with pytest.raises(FileNotFoundError) as want:
            JPIT.main(["random", "human", "--batched"])
        with pytest.raises(FileNotFoundError) as got:
            PIT.main(["random", "human", "--batched"] + cpu)
        assert str(got.value) == str(want.value)
    else:
        flag = {"record_dir_batched": ["--record-dir", "games"],
                "token_limits_batched": ["--token-limits", "8,10"]}[mode]
        with pytest.raises(SystemExit) as exc:
            PIT.main(["random", "greedy", "--batched"] + flag + cpu)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert f"{flag[0]} is a flag of the sequential pit" in err


def test_coach_iteration_with_tree_reuse(tmp_path):
    coach = Coach(_cfg(tmp_path, tree_reuse=True), device="cpu")
    assert coach.selfplay.rs_full.capacity == 17
    coach.learn()
    rec = _records(tmp_path)
    assert [r["iter"] for r in rec] == [1] and rec[0]["selfplay_examples"] > 0
    assert rec[0]["gate_new"] + rec[0]["gate_old"] + rec[0]["gate_draws"] == 4
