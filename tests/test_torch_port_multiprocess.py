"""The port's multi-process entry points with W=2 processes over gloo (the
counterpart of ``tests/test_multiprocess.py``).

- ``python -m alphazero_tpu_torch.cli.main --distributed --device cpu``'s
  ``main`` on two ranks (joined through a file rendezvous first, so its
  ``initialize`` keeps their group) completes one iteration; rank 0 writes
  every checkpoint, rank 1 none, and ``metrics.jsonl`` holds one record.
- A coach whose self-play batch the world size does not divide raises a
  ``ValueError`` that names the sizes (the JAX coach shrinks its mesh).
- ``bench_scaling`` on two ranks prints the JAX benchmark's keys.
- The port's dry run (``parallel/dryrun.py``) passes on two ranks.
"""

import json
import os
import pickle

from alphazero_tpu_torch.parallel import dryrun as DR
from tests import torch_port_mp_worker as W


def _ranks(out_dir, world=2):
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def test_cli_main_distributed_two_ranks(tmp_path):
    ckpt = str(tmp_path / "run")
    argv = ["-n", "1", "-e", "4", "--selfplayBatch", "4", "-m", "8",
            "--arenaCompare", "2", "--gate-sims", "4", "-b", "16", "-p", "1",
            "-C", ckpt, "--distributed", "--device", "cpu"]
    DR.spawn(W.cli_main, 2, (argv, str(tmp_path)), timeout_s=150)
    r0, r1 = _ranks(tmp_path)
    assert "temp.pt" in r0["saved"] and r1["saved"] == []
    assert len(set(r0["saved"])) == len(r0["saved"])
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    assert len(records) == 1 and records[0]["iter"] == 1
    assert records[0]["selfplay_games"] == 4
    assert records[0]["accepted"] == ("best.pt" in r0["saved"])
    for name in ("temp.pt", "settings.json", "checkpoint.examples"):
        assert os.path.exists(os.path.join(ckpt, name)), name
    for r in (r0, r1):
        assert "world size 2" in r["uneven"] and "selfplay_batch 3" in \
            r["uneven"]
        assert set(r["bench"]) == {"metric", "devices", "one_device",
                                   "all_devices", "scaling_efficiency"}
        assert r["bench"]["devices"] == 2 and r["bench"]["all_devices"] > 0


def test_dryrun_two_ranks(tmp_path):
    DR.spawn(DR._run_and_write, 2, ("cpu", str(tmp_path), {"batch": 8}))
    recs = [json.load(open(tmp_path / f"dryrun_{r}.json")) for r in range(2)]
    assert [r["rank"] for r in recs] == [0, 1]
    assert recs[0]["train_loss"] == recs[1]["train_loss"]
    assert recs[0]["selfplay_examples"] == sum(recs[0]["rank_examples"]) > 0
