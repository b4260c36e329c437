"""Port parity: the offline tools (``examples_tool``, ``train_offline``,
``train_resilient``), ``utils/profiling`` and the live assistant's maps.

- ``examples_tool`` writes files byte-equal to the JAX tool's (merge,
  binarize, test split) and prints the same summary.
- ``train_offline`` for one epoch from the same warm start and the same
  examples (augmentation off, dropout 0: their draws come from JAX keys
  in the JAX tool): the saved parameters agree within the tolerance of
  ``tests/test_torch_port_fit.py::test_fit_trains_like_jax`` (1e-3; running
  statistics 1e-3 relative), the metrics within 1e-3 relative.
- ``train_resilient``: ``completed_iters`` and ``_flag_value`` equal the
  JAX functions'; the child command names ``alphazero_tpu_torch.cli.main``
  and passes ``--device`` through, with the same resume flags as JAX's.
- ``profiling.trace`` writes a trace file and ``top_ops`` reads non-empty
  rows from it and from the profile, on the CPU.
- ``live_assist``'s sprite maps equal JAX's and cover the deck and the
  nobles; without selenium it raises the JAX tool's error.
"""

import contextlib
import functools
import io
import os
import sys

import numpy as np
import pytest
import torch

from alphazero_tpu.cli import examples_tool as JEX
from alphazero_tpu.cli import live_assist as JLIVE
from alphazero_tpu.cli import train_offline as JTO
from alphazero_tpu.cli import train_resilient as JRES
from alphazero_tpu.train import trainer as JTR
from alphazero_tpu_torch.cli import examples_tool as EX
from alphazero_tpu_torch.cli import live_assist as LIVE
from alphazero_tpu_torch.cli import train_offline as TO
from alphazero_tpu_torch.cli import train_resilient as RES
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import board_dsl as D
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.search import mcts as M
from alphazero_tpu_torch.train import trainer as TR
from alphazero_tpu_torch.utils import checkpoint as C
from alphazero_tpu_torch.utils import profiling as PROF
from tests.test_torch_port_fit import replay_buffer
from tests.test_torch_port_train import _one_thread  # noqa: F401
from tests.test_torch_port_train import assert_trees_close, jax_net


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return out.getvalue(), result


@pytest.mark.parametrize("flags", [["--binarize", "--test-stride", "4"], [],
                                   ["--info"]])
def test_examples_tool_files_equal(tmp_path, flags):
    inputs = []
    for i, sizes in enumerate(((30, 26), (12, 20, 9))):
        path = str(tmp_path / f"in{i}.examples")
        buf = replay_buffer(i, sizes=sizes, tag=False)
        buf.iterations[0].pi[1] = 0         # a row with no argmax
        buf.save(path)
        inputs.append(path)
    text, rc = _stdout(EX.main, inputs + ["-o", str(tmp_path / "port")]
                       + flags)
    jtext, jrc = _stdout(JEX.main, inputs + ["-o", str(tmp_path / "jax")]
                         + flags)
    assert rc == jrc == 0
    assert text.replace("port", "jax") == jtext
    outs = sorted(f for f in os.listdir(tmp_path) if f.startswith("port"))
    assert outs == ([] if flags == ["--info"] else
                    ["port_testing.examples", "port_training.examples"][
                        0 if flags else 1:])
    for name in outs:
        assert ((tmp_path / name).read_bytes()
                == (tmp_path / name.replace("port", "jax")).read_bytes())


def test_train_offline_like_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(JTO.TR, "TrainConfig",
                        functools.partial(JTR.TrainConfig, augment=False))
    monkeypatch.setattr(TO.TR, "TrainConfig",
                        functools.partial(TR.TrainConfig, augment=False))
    _, params, bs, _ = jax_net(1, 128, seed=5)
    C.save_checkpoint(str(tmp_path), "init.pt", params=params,
                      batch_stats=bs, meta={"nn_version": 1})
    ex = str(tmp_path / "train.examples")
    replay_buffer(7, tag=False).save(ex)
    argv = ["-T", ex, "-i", str(tmp_path / "init.pt"), "-p", "1", "-b", "16",
            "-d", "0", "-l", "1e-3", "--seed", "3"]
    assert JTO.main(argv + ["-o", str(tmp_path / "jax")]) == 0
    assert TO.main(argv + ["-o", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
    got = C.load_checkpoint(str(tmp_path / "port"), "last.pt")
    want = C.load_checkpoint(str(tmp_path / "jax"), "last.pt")
    assert_trees_close(got["params"], want["params"], atol=1e-3)
    assert_trees_close(got["batch_stats"], want["batch_stats"], rtol=1e-3,
                       atol=1e-5)
    moved = max(np.abs(np.asarray(v) - np.asarray(w)).max() for (_, v), (_, w)
                in zip(C.tree_items(got["params"]), C.tree_items(params)))
    assert moved > 1e-3
    metrics = {k for k in want["meta"] if k not in vars(
        JTO.build_parser().parse_args(["-T", ex]))}
    assert "val_loss" in metrics
    assert set(got["meta"]) == set(want["meta"]) | {"device"}
    for k in metrics:
        np.testing.assert_allclose(got["meta"][k], want["meta"][k],
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def test_train_resilient_like_jax(tmp_path, monkeypatch):
    ckpt = tmp_path / "run"
    ckpt.mkdir()
    (ckpt / "metrics.jsonl").write_text(
        '{"iter": 1}\n\nnot json\n{"iter": null}\n[1]\n{"iter": 3}\n')
    assert RES.completed_iters(str(ckpt)) == JRES.completed_iters(str(ckpt))
    assert RES.completed_iters(str(tmp_path / "none")) == 0
    for rest, names in ((["-n", "4", "-C", "x"], ("-n", "--numIters")),
                        (["--numIters", "7"], ("-n", "--numIters")),
                        (["-C"], ("-C", "--checkpoint"))):
        assert (RES._flag_value(rest, names, "d")
                == JRES._flag_value(rest, names, "d"))
    (ckpt / "temp.pt").write_bytes(b"")
    cmds = {}
    for name, module in (("port", RES), ("jax", JRES)):
        (ckpt / "metrics.jsonl").write_text('{"iter": 1}\n')
        calls = cmds[name] = []

        def child(cmd, calls=calls):
            calls.append(cmd)
            with open(ckpt / "metrics.jsonl", "a") as f:
                f.write('{"iter": 2}\n')
            return 0 if len(calls) > 1 else 1       # the first child crashes
        monkeypatch.setattr(module.subprocess, "call", child)
        monkeypatch.setattr(module.time, "sleep", lambda s: None)
        rest = ["-n", "2", "-C", str(ckpt), "--device", "cpu"]
        assert module.main(rest) == 0
    assert len(cmds["port"]) == len(cmds["jax"]) == 1
    cmd = cmds["port"][0]
    assert cmd[:3] == [sys.executable, "-m", "alphazero_tpu_torch.cli.main"]
    assert cmd[3:] == ["-n", "2", "-C", str(ckpt), "--device", "cpu", "-L",
                       str(ckpt / "temp.pt"), "--load-fallback"]
    assert cmds["jax"][0][3:] == cmd[3:]


def test_profiling_trace_and_top_ops(tmp_path):
    cfg = E.SplendorConfig()
    search = M.build_search(M.MCTSConfig(num_sims=4), 2,
                            A.make_uniform_eval_fn(cfg),
                            A.make_search_step_fn(cfg), A.make_valid_fn(cfg),
                            "cpu")
    roots = E.initial_state(cfg, 2, torch.Generator().manual_seed(0), "cpu")
    with PROF.trace(str(tmp_path)) as prof:
        search(None, roots)
    assert os.path.getsize(tmp_path / PROF.TRACE_FILE) > 0
    rows = PROF.top_ops(str(tmp_path), 5)
    assert len(rows) == 5 and rows == sorted(rows, reverse=True)
    total_us, count, typ, name = rows[0]
    assert total_us > 0 and count >= 1 and typ == "cpu_op" and name
    assert {r[3] for r in PROF.top_ops(prof, None)} >= {r[3] for r in rows}
    text, _ = _stdout(PROF.print_top_ops, str(tmp_path), 3)
    assert text.splitlines()[0].split() == ["total_us", "count", "type", "/",
                                            "op"]


def test_live_assist_maps_and_selenium_error(monkeypatch):
    assert LIVE.CARDS_BY_SPRITE == JLIVE.CARDS_BY_SPRITE
    assert LIVE.NOBLES_BY_SPRITE == JLIVE.NOBLES_BY_SPRITE
    ids = [D.lookup_card(code) for code in LIVE.CARDS_BY_SPRITE.values()]
    assert len(ids) == 90 and len(set(ids)) == 90
    assert ({D.lookup_noble(c) for c in LIVE.NOBLES_BY_SPRITE.values()}
            == set(range(10)))
    monkeypatch.setitem(sys.modules, "selenium", None)
    errors = []
    for module in (LIVE, JLIVE):
        with pytest.raises(RuntimeError, match="selenium") as info:
            module.main(["--url", "http://localhost/table", "-c", "x.pt"])
        errors.append(str(info.value))
    assert errors[0] == errors[1]
