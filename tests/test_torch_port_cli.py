"""The port's training CLI and resume continuity.

The CLI's options and defaults equal the JAX CLI's, plus ``--device``, and
``args_to_config`` builds the same ``CoachConfig``; ``main`` runs one
iteration on the CPU and resumes with ``-L``.  A restarted run continues
the same monotone iteration numbering in one ``metrics.jsonl`` and keeps
superseded settings (``tests/test_resume_continuity.py``).
"""

import dataclasses
import json
import os

from alphazero_tpu.cli import main as JCLI
from alphazero_tpu_torch.cli import main as CLI
from alphazero_tpu_torch.train.coach import Coach, completed_iterations
from tests.test_torch_port_coach import _cfg, _records
from tests.test_torch_port_train import _one_thread  # noqa: F401


def test_restart_continues_monotone_numbering(tmp_path):
    Coach(_cfg(tmp_path, num_iters=1), device="cpu").learn()
    assert [r["iter"] for r in _records(tmp_path)] == [1]
    coach2 = Coach(_cfg(tmp_path, num_iters=2), device="cpu")
    coach2.load_checkpoint(str(tmp_path), "temp.pt")
    start = completed_iterations(str(tmp_path)) + 1
    assert start == 2
    coach2.learn(start_iter=start)
    assert [r["iter"] for r in _records(tmp_path)] == [1, 2]
    with open(tmp_path / "settings.json") as f:
        assert json.load(f)["num_iters"] == 2
    with open(tmp_path / "settings_v1.json") as f:
        assert json.load(f)["num_iters"] == 1
    # a complete run is a no-op
    Coach(_cfg(tmp_path, num_iters=2), device="cpu").learn(
        start_iter=completed_iterations(str(tmp_path)) + 1)
    assert [r["iter"] for r in _records(tmp_path)] == [1, 2]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     getattr(a, "choices", None))
            for a in parser._actions}


def test_cli_options_equal_jax():
    got, want = _options(CLI.build_parser()), _options(JCLI.build_parser())
    assert got.pop("device") == (("--device",), "cuda", None, None, None)
    assert got == want
    argv = ["-n", "3", "-e", "20", "-m", "16", "-b", "8", "-F", "-W",
            "--gate-mode", "always", "--val-split", "0.1", "-C", "/x"]
    gcfg = CLI.args_to_config(CLI.build_parser().parse_args(argv))
    jcfg = JCLI.args_to_config(JCLI.build_parser().parse_args(argv))
    assert dataclasses.asdict(gcfg) == dataclasses.asdict(jcfg)


def test_cli_main_one_iteration(tmp_path):
    argv = ["-n", "1", "-e", "2", "--selfplayBatch", "2", "-m", "4",
            "--ratio-fullMCTS", "2", "--arenaCompare", "2", "--gate-sims",
            "2", "-b", "8", "-p", "1", "-C", str(tmp_path), "--device", "cpu"]
    CLI.main(argv)
    assert [r["iter"] for r in _records(tmp_path)] == [1]
    assert os.path.exists(tmp_path / "temp.pt")
    # -L resumes; the run is complete, so nothing more is recorded
    CLI.main(argv + ["-L", str(tmp_path / "temp.pt")])
    assert [r["iter"] for r in _records(tmp_path)] == [1]
