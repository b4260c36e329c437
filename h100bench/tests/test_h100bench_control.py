"""The control of every cell's comparison, on the card: the reference
computed in TF32 put in the program's place fails at least one of the
cell's numbers, while the program passes them all; and for the train
cell, the fault of half of the batch left out fails too.  A small size
here; ``python -m h100bench.control`` reads the same at the cells' own
sizes."""

from __future__ import annotations

import pytest

from h100bench import control, core

SMALL = {
    "splendor-2p-r6.selfplay": {"config": {"selfplay_batch": 32,
                                           "num_sims": 64},
                                "params": {"plies": 2}},
    "splendor-4p-r12.selfplay": {"config": {"selfplay_batch": 32,
                                            "num_sims": 48},
                                 "params": {"plies": 2}},
    "splendor-4p-r12.move-b1": {"params": {"num_sims": 32, "pool": 16,
                                           "check_requests": 4}},
    "splendor-2p-r6.train": {"params": {"buffer_games": 256,
                                        "chunk_steps": 8}},
}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 77])
def test_control_fails_and_program_passes(card, cell, seed):
    seconds = 1.0 if "move" in cell else 0.0
    r = control.readings(cell, seed, seconds, True, "cuda", SMALL[cell])
    limits = core.workload(cell)["limits"]
    assert all(v <= limits[n] for n, v in r["program"].items()), r
    assert any(v > limits[n] for n, v in r["control"].items()), r
    if "half_batch" in r:
        assert any(v > limits[n] for n, v in r["half_batch"].items()), r
