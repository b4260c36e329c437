"""Port parity: the search tools (``review``, ``advise``, ``analyze``,
``restart``) against the JAX package, with a width-48 checkpoint (the JAX
tools build their net from ``net_config_for``'s default width, so the
test hands them width 48; the port reads the checkpoint's meta).

- ``review_position`` (16 sims, B=1, no depth cap, two positions):
  ``raw_counts`` equal, root ``q`` within 1e-5, the same printed report;
- ``advise`` on the JAX board-DSL tests' demo spec (PyYAML is present
  here) and ``restart`` from turn 6 of a recorded game (random vs greedy)
  print the same text;
- ``analyze``'s CSV has equal turn, seat and score columns, value and
  entropy within 1e-5.
"""

import contextlib
import csv
import functools
import io
import os
import pickle

import numpy as np
import pytest
import yaml

from alphazero_tpu.cli import advise as JADVISE
from alphazero_tpu.cli import analyze as JANALYZE
from alphazero_tpu.cli import restart as JRESTART
from alphazero_tpu.cli import review as JREVIEW
from alphazero_tpu.games import game_api as JAPI
from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.utils import checkpoint as JC
from alphazero_tpu_torch.cli import advise as ADVISE
from alphazero_tpu_torch.cli import analyze as ANALYZE
from alphazero_tpu_torch.cli import restart as RESTART
from alphazero_tpu_torch.cli import review as REVIEW
from alphazero_tpu_torch.games import game_api as API
from alphazero_tpu_torch.utils import checkpoint as C
from tests.test_board_dsl import _demo_spec
from tests.test_torch_port_game_api import init_board
from tests.test_torch_port_pit_seq import save_net
from tests.test_torch_port_train import _one_thread  # noqa: F401


@pytest.fixture
def ckpt(monkeypatch, tmp_path):
    monkeypatch.setattr(JA, "net_config_for",
                        functools.partial(JA.net_config_for, width=48))
    return save_net(tmp_path, 3)


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return out.getvalue(), result


@pytest.fixture
def record(tmp_path):
    """A recorded game's first 14 boards (random play), as the pit's
    ``--record-dir`` pickles them."""
    g = API.SplendorGame(2, seed=9, device="cpu")
    board, player, boards = init_board(2, 9), 0, []
    rng = np.random.default_rng(9)
    for _ in range(14):
        boards.append(board.copy())
        a = int(rng.choice(np.flatnonzero(g.getValidMoves(board, player))))
        board, player = g.getNextState(board, player, a)
    path = tmp_path / "game_0.pkl"
    with open(path, "wb") as f:
        pickle.dump(boards + [board], f)
    return path, boards


@pytest.mark.parametrize("turn", [4, 11])
def test_review_position(ckpt, record, turn):
    _, boards = record
    board = API.SplendorGame(2, device="cpu").getCanonicalForm(boards[turn],
                                                              turn % 2)
    jck = JC.load_checkpoint(*os.path.split(ckpt))
    game = API.SplendorGame(2, device="cpu")
    net, _ = C.load_net(ckpt, game.cfg, "cpu")
    text, (pi, q) = _stdout(REVIEW.review_position, game, net, board, 16)
    jtext, (jpi, jq) = _stdout(
        JREVIEW.review_position, JAPI.SplendorGame(2),
        (jck["params"], jck["batch_stats"]), board, 16)
    np.testing.assert_array_equal(pi, jpi)
    assert pi.sum() == 1.0 and (pi > 0).sum() > 1
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-5)
    assert text == jtext
    assert "MCTS root Q" in text


def test_advise_prints_like_jax(ckpt, tmp_path):
    spec = tmp_path / "board.yaml"
    spec.write_text(yaml.safe_dump(_demo_spec()))
    argv = [str(spec), "-c", ckpt, "-m", "8", "--player", "1"]
    text, _ = _stdout(ADVISE.main, argv + ["--device", "cpu"])
    jtext, _ = _stdout(JADVISE.main, argv)
    assert text == jtext
    assert "Player 1's turn..." in text


def test_restart_prints_like_jax(record):
    path, _ = record
    argv = [str(path), "random", "greedy", "--turn", "6", "-v", "--seed", "2"]
    text, _ = _stdout(RESTART.main, argv + ["--device", "cpu"])
    jtext, _ = _stdout(JRESTART.main, argv)
    assert text == jtext
    assert "result:" in text


def test_analyze_csv_like_jax(ckpt, record, tmp_path):
    path, boards = record
    rows = {}
    for name, main, extra in (("jax", JANALYZE.main, []),
                              ("port", ANALYZE.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.csv"
        main([str(path), "-c", ckpt, "-o", str(out)] + extra)
        with open(out) as f:
            rows[name] = list(csv.DictReader(f))
    assert len(rows["port"]) == len(rows["jax"]) == len(boards) + 1
    for got, want in zip(rows["port"], rows["jax"]):
        assert list(got) == list(want)
        for k in ("turn", "seat", "score0", "score1"):
            assert got[k] == want[k]
        for k in ("value", "entropy"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-5, k
