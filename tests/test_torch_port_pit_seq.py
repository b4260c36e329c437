"""Port parity: the sequential pit (``play_games``, ``MCTSPlayer``,
``create_player``, the sequential tournament) against the JAX pit.

``getInitBoard`` draws from a JAX key in the JAX API, so both packages'
games are handed the same initial boards (from numpy uniforms); all other
chance comes from each API's ``default_rng(seed)``, the greedy player's
from its own.  Then, 2 players, 2 games (both seat orders):

- random vs greedy gives equal wins, draws and score sums, with
  ``--record-dir`` pickles that are byte-equal;
- ``token_limits``: the JAX pit lets its players choose on the shared
  10-token game, so with ``[8, 10]`` the 8-token seat's agent picks a move
  its own game rejects and the JAX pit stops on game 0.  The port binds
  each seat's agent to the seat's game (a port-only fix), so it completes
  both games with every move valid under its seat's limit; with limits the
  JAX pit completes (``[10, 10]``) both pits give equal tallies;
- ``MCTSPlayer`` (a width-48 checkpoint, 4 sims) vs greedy gives equal
  tallies; the JAX player builds its net from ``net_config_for``'s default
  width, so the test hands it width 48 (the port reads the meta);
- the sequential tournament of two checkpoints (2 sims) writes equal
  ratings books.
"""

import argparse
import functools
import os

import numpy as np
import pytest
import torch

from alphazero_tpu.cli import pit as JPIT
from alphazero_tpu.games import game_api as JAPI
from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu_torch.cli import pit as PIT
from alphazero_tpu_torch.games import game_api as API
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.utils import checkpoint as C
from tests.test_torch_port_game_api import init_board
from tests.test_torch_port_train import _one_thread  # noqa: F401


@pytest.fixture
def same_boards(monkeypatch):
    """Both APIs' ``getInitBoard`` hand out the same boards, in order."""
    _same_boards(monkeypatch)


def _same_boards(monkeypatch):
    boards = [init_board(2, 70 + i) for i in range(8)]
    for cls in (JAPI.SplendorGame, API.SplendorGame):
        it = iter(boards)
        monkeypatch.setattr(cls, "getInitBoard",
                            lambda self, it=it: next(it).copy())
    monkeypatch.setattr(JA, "net_config_for",
                        functools.partial(JA.net_config_for, width=48))


def save_net(folder, seed, sims=4):
    net = N.build_net(A.net_config_for(E.SplendorConfig(), width=48), "cpu",
                      torch.Generator().manual_seed(seed))
    params, batch_stats = N.to_flax(net.state_dict())
    return C.save_checkpoint(
        str(folder), "best.pt", params=params, batch_stats=batch_stats,
        meta={"nn_version": 1, "net_width": 48, "num_sims": sims,
              "cpuct": 1.5, "fpu": 0.1})


def _args(**kw):
    base = dict(numMCTSSims=0, seed=3, ab_depth=2, ab_deadline=10.0)
    return argparse.Namespace(**{**base, **kw})


def both(specs, games=2, record_dirs=(None, None), limits=None):
    """``play_games`` of the same specs in both packages (JAX first), each
    recording into its entry of ``record_dirs``, with ``token_limits=
    limits``."""
    out = []
    for api, pit, rec in zip((JAPI, API), (JPIT, PIT), record_dirs):
        extra = {} if api is JAPI else {"device": "cpu"}
        game = api.SplendorGame(2, seed=5, **extra)
        players = [pit.create_player(s, game, _args()) for s in specs]
        out.append(pit.play_games(game, players, games,
                                  record_dir=rec and str(rec),
                                  token_limits=limits))
    (jw, jd, js), (w, d, s) = out
    assert (w, d) == (jw, jd)
    np.testing.assert_array_equal(s, js)
    assert sum(w) + d == games
    return w, d, s


@pytest.mark.parametrize("mode", ["record", "token_limits"])
def test_random_vs_greedy(mode, same_boards, tmp_path, monkeypatch):
    if mode == "token_limits":
        # the JAX pit stops on game 0 (a fault the port does not keep)
        jgame = JAPI.SplendorGame(2, seed=5)
        with pytest.raises(AssertionError,
                           match="illegal move 60 from agent at seat 0"):
            JPIT.play_games(jgame, [JPIT.create_player(s, jgame, _args())
                                    for s in ("random", "greedy")], 2,
                            token_limits=[8, 10])
        game = API.SplendorGame(2, seed=5, device="cpu")
        players = [PIT.create_player(s, game, _args())
                   for s in ("random", "greedy")]
        seen = []
        for p in players:
            play = p.play

            def checked(board, p=p, play=play):
                a = play(board)
                # the agent's bound game is its seat's: 8 tokens at seat 0
                seen.append((p.game.cfg.token_limit,
                             bool(p.game.getValidMoves(board, 0)[a])))
                return a
            p.play = checked
        w, d, _ = PIT.play_games(game, players, 2, token_limits=[8, 10])
        assert sum(w) + d == 2
        assert {lim for lim, _ in seen} == {8, 10}
        assert all(ok for _, ok in seen)
        assert all(p.game is game for p in players)
        # limits the JAX pit completes: both pits agree, from board 70 on
        _same_boards(monkeypatch)
        both(["random", "greedy"], limits=[10, 10])
        return
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    w, d, sc = both(["random", "greedy"], record_dirs=(jdir, pdir))
    assert w[1] > w[0]                             # greedy wins most
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir)) == ["game_0.pkl", "game_1.pkl"]
    for name in names:
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes()


def test_mcts_player_vs_greedy(same_boards, tmp_path):
    spec = save_net(tmp_path, 1)
    game = API.SplendorGame(2, device="cpu")
    player = PIT.create_player(spec, game, _args())
    assert isinstance(player, PIT.MCTSPlayer)
    assert player.net.cfg.width == 48
    w, d, s = both([spec, "greedy"])
    assert s.sum() > 0


def test_sequential_tournament_books_equal(same_boards, tmp_path):
    for name, seed in (("a", 1), ("b", 2)):
        (tmp_path / name).mkdir()
        save_net(tmp_path / name, seed)
    argv = ["--tournament", str(tmp_path), "-n", "2", "-m", "2"]
    JPIT.main(argv + ["--ratings", str(tmp_path / "jax.json")])
    book = PIT.main(argv + ["--ratings", str(tmp_path / "port.json"),
                            "--device", "cpu"])
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
    assert sorted(book.ratings) == [str(tmp_path / "a" / "best.pt"),
                                    str(tmp_path / "b" / "best.pt")]
