"""The BT4 cell (``splendor-2p-bt4.selfplay``) at a tiny size on the CPU:
a whole run and its check, the controls, the drawn weights, the FLOP count against the plain
reference's matmuls, the metric readers, and the clean failure of a program without version 3."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import control, core, work, work_bt4
from h100bench.reference import bt4 as RB

CELL = "splendor-2p-bt4.selfplay"
TINY_NET = {"net_width": 64, "net_layers": 2, "net_heads": 4, "net_ffn": 96,
            "net_smolgen": [8, 16, 16]}
TINY = {"config": {**TINY_NET, "selfplay_batch": 6, "num_sims": 8},
        "params": {"plies": 2, "check_plies": 2, "net_every": 4}}


def _traffic():
    return core.module("traffic", "selfplay_bt4")


def _net(players: int, dtype="float32"):
    cfg = {**core.config("splendor-2p-bt4"), **TINY_NET,
           "num_players": players}
    return _traffic().build_net(cfg, torch.device("cpu"), dtype)[0], cfg


def _boards(players: int, B: int):
    from alphazero_tpu_torch.games.splendor import env as E
    ecfg = E.SplendorConfig(num_players=players)
    s = E.initial_state(ecfg, B, torch.Generator().manual_seed(players),
                        "cpu")
    return s.float(), E.valid_moves(ecfg, s, 0)


def test_the_cell_runs_and_its_check_passes():
    out = core.run_cell(CELL, 2 ** 33 + 5, 0.0, False, 0.0, device="cpu",
                        require=False, overrides=TINY)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"rollouts_per_s", "setup_s"}
    checks = out["checks"]
    assert [checks[n]["value"] for n in ("actor_diffs", "value_gap",
                                         "prior_gap", "q_gap",
                                         "visits_tv")] == [0.0] * 5
    # the bf16 trunk is not float32: its net gaps are above 0
    assert checks["net_value_gap"]["value"] > 0
    assert checks["net_prior_gap"]["value"] > 0


def test_the_controls():
    """A float32 trunk reads float32's gaps; the float8-rounded reference,
    the reference without Dense biases and the one with the norms and the
    gating at their initial values read above the bf16 program."""
    r = control.readings(CELL, 11, 0.0, True, device="cpu", overrides=TINY)
    assert r["program"]["actor_diffs"] == 0
    ctl = r["control"]
    assert ctl["float32_trunk"]["net_value_gap"] < 1e-5
    assert ctl["float32_trunk"]["net_prior_gap"] < 1e-5
    assert 0 < ctl["bfloat16_dense"]["net_value_gap"] < 1
    for fault in ("float8_trunk", "dense_biases_at_0", "norms_gating_at_init"):
        assert ctl[fault]["net_value_gap"] > r["program"]["net_value_gap"]


def test_drawn_weights():
    """Every tensor drawn from the seed, the same for the same seed, none
    at the program's initial value, and held by the net the cell builds."""
    T = _traffic()
    net, cfg = _net(2)
    fresh = _fresh_net(cfg)
    state = T.draw_state({k: v.shape for k, v in fresh.state_dict().items()},
                         int(cfg["weights_seed"]))
    assert state.keys() == fresh.state_dict().keys()
    for k, v in net.state_dict().items():
        assert torch.equal(v, state[k]), k
        assert not torch.equal(v, fresh.state_dict()[k]), k
    again = T.draw_state({k: v.shape for k, v in state.items()},
                         int(cfg["weights_seed"]))
    assert all(torch.equal(state[k], again[k]) for k in state)
    # biases and adds about 0, scales and multiplies about 1
    assert abs(float(state["enc_0.dense_2.bias"].mean())) < 0.1
    assert abs(float(state["enc_1.ln_0.weight"].mean()) - 1) < 0.1
    assert abs(float(state["gate_0.mul"].mean()) - 1) < 0.1
    at0 = T.at_init(state, ("dense_",))
    assert torch.equal(at0["enc_0.dense_4.weight"], state["enc_0.dense_4.weight"])
    assert not at0["enc_0.dense_2.bias"].any()
    assert torch.equal(at0["enc_0.ln_0.bias"], state["enc_0.ln_0.bias"])
    norms = T.at_init(state, ("ln_", "gate_"))
    assert (norms["enc_1.ln_3.weight"] == 1).all()
    assert (norms["gate_0.mul"] == 1).all() and not norms["gate_0.add"].any()
    assert torch.equal(norms["dense_3.bias"], state["dense_3.bias"])


def _fresh_net(cfg):
    """A version-3 net of the program at ``cfg``'s sizes, as initialized."""
    from alphazero_tpu_torch.models import splendor_net as N
    return N.build_net(_traffic().net_config(cfg), "cpu")


def test_kept_batches():
    ev = _traffic().Evaluator(lambda net, b, m: (b, m), None, 64)
    for k in range(3):
        ev.begin()
        for _ in range(1 + (512 if k < 2 else 128)):
            ev(torch.zeros(1), torch.zeros(1))
    # roots + sims 0, 64, ..., 448 of two full searches; roots + 0, 64 fast
    assert len(ev.kept) == 2 * 9 + 3


@pytest.mark.parametrize("players", [2, 4])
def test_work_bt4_equals_the_flop_counter(players):
    """``work_bt4`` against what ``FlopCounterMode`` counts of the plain
    reference's matmuls (which compute no score-difference head)."""
    net, cfg = _net(players)
    ref = RB.BT4(net.state_dict(), "cpu")
    boards, valid = _boards(players, 3)
    with FlopCounterMode(display=False) as fc:
        ref(boards, valid)
    assert fc.get_total_flops() == 3 * work_bt4.forward_flops(cfg)
    rows = work.rows(players)
    assert work_bt4.forward_flops(cfg) == rows * work_bt4.token_flops(cfg) \
        + work_bt4.board_flops(cfg, rows)


def test_published_flops():
    cfg = core.config("splendor-2p-bt4")
    assert work_bt4.forward_flops(cfg) == 13_432_199_168


def test_a_program_without_version_3_fails_cleanly(monkeypatch):
    from alphazero_tpu_torch.models import splendor_net as N
    monkeypatch.setattr(N, "NET_VERSIONS",
                        {k: v for k, v in N.NET_VERSIONS.items() if k != 3})
    with pytest.raises(core.NoResult, match="no nn_version 3"):
        _traffic().build_net(core.config("splendor-2p-bt4"),
                             torch.device("cpu"))


def _reduced(kernel_s, busy=2.0):
    return {"window_s": 4.0, "busy_s": busy, "kernels": 5,
            "kernel_s": kernel_s, "span_s": {}, "device_ops": [],
            "idle_gaps": []}


def test_readers():
    m = {n: core.module("metrics", n) for n in (
        "mfu.bt4.selfplay", "net.busy_mfu.bt4.selfplay",
        "net.gemm_share.bt4.selfplay", "net.attention_share.bt4.selfplay")}
    kernel_s = {
        "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT": (0.8, 100),
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": (0.4, 9),
        "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::"
        "AttentionKernel<cutlass::bfloat16_t, cutlass::arch::Sm80>::Params)":
            (0.3, 30),
        "void at::native::vectorized_elementwise_kernel<4>": (0.2, 50)}
    data = {"trace": _reduced(kernel_s), "cell": core.workload(CELL),
            "counts": {"window_flops": 989e12, "window_s": 4.0,
                       "net_token_flops": 10, "net_board_flops": 1000},
            "counters": {"net.tokens": 56e12, "net.boards": 1e12}}
    assert m["mfu.bt4.selfplay"].read(data) == pytest.approx(25.0)
    flops = 56e12 * 10 + 1e12 * 1000
    assert m["net.busy_mfu.bt4.selfplay"].read(data) == \
        pytest.approx(flops / 2.0 / 989e12 * 100)
    assert m["net.gemm_share.bt4.selfplay"].read(data) == pytest.approx(0.6)
    assert m["net.attention_share.bt4.selfplay"].read(data) == \
        pytest.approx(0.15)
    # a program without the counters, a slice with no kernel
    empty = {**data, "counters": {}, "trace": _reduced({})}
    assert m["net.busy_mfu.bt4.selfplay"].read(empty) is None
    assert m["net.gemm_share.bt4.selfplay"].read(empty) is None


def test_the_references_load_nothing_of_the_program():
    from h100bench.tests.test_h100bench_harness import _loaded
    assert _loaded("from h100bench.reference import bt4\n"
                   "from oracle import bt4_reference") == []
