"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the GPU unless the caller asks for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "alphazero_tpu_torch",
    "alphazero_tpu_torch.games.splendor.tables",
    "alphazero_tpu_torch.games.splendor.env",
    "alphazero_tpu_torch.games.splendor.adapter",
    "alphazero_tpu_torch.games.splendor.symmetry",
    "alphazero_tpu_torch.games.splendor.strings",
    "alphazero_tpu_torch.games.splendor.render",
    "alphazero_tpu_torch.games.splendor.board_dsl",
    "alphazero_tpu_torch.games.game_api",
    "alphazero_tpu_torch.models",
    "alphazero_tpu_torch.models.splendor_net",
    "alphazero_tpu_torch.ops._build",
    "alphazero_tpu_torch.ops.descent",
    "alphazero_tpu_torch.ops.env_step",
    "alphazero_tpu_torch.ops.fused_backup",
    "alphazero_tpu_torch.search.mcts",
    "alphazero_tpu_torch.train.losses",
    "alphazero_tpu_torch.train.replay",
    "alphazero_tpu_torch.train.selfplay",
    "alphazero_tpu_torch.train.trainer",
    "alphazero_tpu_torch.train.coach",
    "alphazero_tpu_torch.eval.arena",
    "alphazero_tpu_torch.eval.glicko2",
    "alphazero_tpu_torch.eval.players",
    "alphazero_tpu_torch.eval.ab_pool",
    "alphazero_tpu_torch.cli.main",
    "alphazero_tpu_torch.cli.pit",
    "alphazero_tpu_torch.cli.review",
    "alphazero_tpu_torch.cli.advise",
    "alphazero_tpu_torch.cli.analyze",
    "alphazero_tpu_torch.cli.restart",
    "alphazero_tpu_torch.cli.live_assist",
    "alphazero_tpu_torch.cli.examples_tool",
    "alphazero_tpu_torch.cli.train_offline",
    "alphazero_tpu_torch.cli.train_resilient",
    "alphazero_tpu_torch.cli.export",
    "alphazero_tpu_torch.cli.bench_scaling",
    "alphazero_tpu_torch.cli.bench",
    "alphazero_tpu_torch.cli.bench_selfplay",
    "alphazero_tpu_torch.compat",
    "alphazero_tpu_torch.compat.torch_import",
    "alphazero_tpu_torch.compat.onnx_export",
    "alphazero_tpu_torch.parallel",
    "alphazero_tpu_torch.parallel.distributed",
    "alphazero_tpu_torch.parallel.mesh",
    "alphazero_tpu_torch.parallel.dryrun",
    "alphazero_tpu_torch.utils.checkpoint",
    "alphazero_tpu_torch.utils.device",
    "alphazero_tpu_torch.utils.native",
    "alphazero_tpu_torch.utils.profiling",
    "chip_smoke",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from alphazero_tpu_torch.utils import checkpoint as C\n"
        "C.load_checkpoint('runs/r6', 'best.pt')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'alphazero_tpu'))\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_port_sources_name_no_jax():
    """No source file of the port imports JAX or the JAX package."""
    pkg = os.path.join(ROOT, "alphazero_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    for path in files:
        for line in open(path):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "flax", "optax",
                                   "alphazero_tpu"), (path, s)


def test_entry_points_default_to_cuda():
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.games.splendor import env as E
    from alphazero_tpu_torch.models import splendor_net as N
    from alphazero_tpu_torch.cli import main as CLI
    from alphazero_tpu_torch.cli import pit as PIT
    from alphazero_tpu_torch.cli import train_offline as TO
    from alphazero_tpu_torch.cli import bench_scaling as BS
    from alphazero_tpu_torch.cli import export as X
    from alphazero_tpu_torch.parallel import distributed as D
    from alphazero_tpu_torch.games import game_api as API
    from alphazero_tpu_torch.eval import arena as AR
    from alphazero_tpu_torch.search import mcts as M
    from alphazero_tpu_torch.train import coach as CO
    from alphazero_tpu_torch.train import selfplay as SP
    from alphazero_tpu_torch.train import trainer as TR
    if torch.cuda.is_available():
        pytest.skip("this check is about machines without a CUDA device")
    cfg = E.SplendorConfig()
    calls = [
        lambda: E.initial_state(cfg, 2),
        lambda: N.build_net(A.net_config_for(cfg)),
        lambda: M.build_search(M.MCTSConfig(num_sims=4), 2,
                               A.make_uniform_eval_fn(cfg),
                               A.make_search_step_fn(cfg),
                               A.make_valid_fn(cfg)),
        lambda: M.build_reusing_search(M.MCTSConfig(num_sims=4), 2,
                                       A.make_uniform_eval_fn(cfg),
                                       A.make_search_step_fn(cfg),
                                       A.make_valid_fn(cfg)),
        lambda: SP.SelfPlayEngine(cfg, A.make_uniform_eval_fn(cfg),
                                  SP.SelfPlayConfig(batch_size=2,
                                                    num_sims=4)),
        lambda: SP.SelfPlayEngine(cfg, A.make_uniform_eval_fn(cfg),
                                  SP.SelfPlayConfig(batch_size=2, num_sims=4,
                                                    tree_reuse=True)),
        lambda: TR.init_train_state(A.net_config_for(cfg)),
        lambda: AR.BatchArena(cfg, 2),
        lambda: AR.FusedMatch(cfg, None, 2),
        lambda: CO.Coach(CO.CoachConfig(checkpoint_dir="/nonexistent")),
        lambda: CLI.main(["-C", "/nonexistent"]),
        lambda: PIT.main(["random", "greedy", "--batched"]),
        lambda: PIT.main(["--batched", "--tournament", "/nonexistent"]),
        lambda: PIT.main(["random", "greedy"]),
        lambda: API.SplendorGame(),
        lambda: TO.main(["-T", "/nonexistent"]),
        lambda: X.export_checkpoint(os.path.join(ROOT, "runs", "r6",
                                                 "best.pt")),
        lambda: X.main([os.path.join(ROOT, "runs", "r6", "best.pt")]),
        lambda: BS.main(["--steps", "1"]),
        lambda: D.initialize("localhost:29500", 1, 0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is about machines without a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
