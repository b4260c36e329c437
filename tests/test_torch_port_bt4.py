"""SplendorNet version 3 (Leela Chess Zero's BT4 encoder transformer) on the
port's path, at a tiny size on the CPU (width 64, 2 layers, 4 heads, FFN
96, smolgen 8 / 16 / 16) on seeded random weights: the net against the
plain float32 reference ``oracle/bt4_reference.py``, its bf16 trunk, a
self-play ply, a train chunk, the coach's checkpoint, the Flax layout, the
counters and the tools that refuse it."""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

from alphazero_tpu_torch.cli import export as EX
from alphazero_tpu_torch.cli import main as CLI
from alphazero_tpu_torch.compat import onnx_export as OX
from alphazero_tpu_torch.compat import torch_import as TI
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.train import selfplay as SP
from alphazero_tpu_torch.train import trainer as TR
from alphazero_tpu_torch.train.coach import Coach, CoachConfig
from alphazero_tpu_torch.utils import checkpoint as C
from alphazero_tpu_torch.utils import profiling
from oracle.bt4_reference import BT4
from tests.test_torch_port_fit import replay_buffer
from tests.test_torch_port_train import _one_thread  # noqa: F401

TINY = dict(width=64, layers=2, heads=4, ffn=96, smolgen=(8, 16, 16))


def _cfg(players=2, dtype="float32", dropout=0.0):
    return A.net_config_for(E.SplendorConfig(num_players=players),
                            dropout=dropout, nn_version=3, dtype=dtype,
                            **TINY)


def _random_net(net_cfg, seed=0):
    """A version-3 net with every parameter drawn from a seeded generator
    (biases, norms and gating too), so none sits at its initial value."""
    net = N.build_net(net_cfg, "cpu", torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("bias", "add")):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            elif p.dim() == 1 or name.endswith("mul"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
    return net


def _boards(players=2, B=12, seed=0):
    """Boards of seeded random legal play, and their valid masks."""
    cfg = E.SplendorConfig(num_players=players)
    g = torch.Generator().manual_seed(seed)
    s = E.initial_state(cfg, B, g, "cpu")
    for _ in range(int(torch.randint(4, 16, (1,), generator=g))):
        v = E.valid_moves(cfg, s, 0)
        a = torch.where(v, torch.rand(v.shape, generator=g), -1.0).argmax(-1)
        s, nxt = E.step(cfg, s, a, 0, torch.rand(B, 2, generator=g), False)
        s = E.swap_players(cfg, s, nxt)
    return s.to(torch.float32), E.valid_moves(cfg, s, 0)


@pytest.mark.parametrize("players", [2, 4])
def test_net_equals_the_reference(players):
    """float32: the port's forward and the plain reference sum in other
    orders, so they agree to 1e-5, not bit for bit."""
    net = _random_net(_cfg(players))
    boards, valid = _boards(players)
    probs, v, log_sd = N.apply_inference(net, boards, valid)
    rp, rv = BT4(net.state_dict(), "cpu")(boards, valid)
    assert probs.shape == (12, 409) and v.shape == (12, players)
    assert log_sd.shape == (12, players, 31)
    np.testing.assert_allclose(probs.numpy(), rp.numpy(), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), rv.numpy(), atol=1e-5)
    assert (probs[~valid] == 0).all()


@pytest.mark.parametrize("players", [2, 4])
def test_bf16_trunk_within_bf16_limits(players):
    """The bf16 trunk against the float32 reference.  bf16 keeps 8 bits of
    mantissa (a unit roundoff of 2^-9 = 2e-3 relative), and each of the
    trunk's ~20 rounded steps a layer (every Dense's input, kernel and
    output, its product and bias rounded once; the attention, the residual
    adds) adds its own error before
    the LayerNorms bring it back to unit scale: the values, tanh of a sum
    over 64 features, stay within 0.1 (~50 roundoffs), the priors within
    0.02.  Both gaps are above 0 (bf16 is not float32), and the same
    weights with a float32 trunk are within float32's 1e-5."""
    net32 = _random_net(_cfg(players))
    net16 = N.build_net(_cfg(players, "bfloat16"), "cpu")
    net16.load_state_dict(net32.state_dict())
    boards, valid = _boards(players, seed=3)
    rp, rv = BT4(net32.state_dict(), "cpu")(boards, valid)
    p16, v16, _ = N.apply_inference(net16, boards, valid)
    assert p16.dtype == v16.dtype == torch.float32       # float32 heads
    value_gap = float((v16 - rv).abs().max())
    prior_gap = float((p16 - rp).abs().max())
    assert 0 < value_gap < 0.1
    assert 0 < prior_gap < 0.02
    p32, v32, _ = N.apply_inference(net32, boards, valid)
    assert float((v32 - rv).abs().max()) < 1e-5


@pytest.mark.parametrize("rule, want", [
    ("_dense_once", 1 + 2 ** -7),    # version 3: one rounding
    ("_dense", 1.0),                 # versions 0-2, Flax: the product first
])
def test_bf16_dense_rounding(rule, want):
    """x = [1, 1], w = [1, 2^-8], b = 2^-8: the sum 1 + 2^-7 is a bf16
    number, but the product alone, 1 + 2^-8, rounds to 1 (a tie, to even),
    and 1 + 2^-8 rounds to 1 again.  Version 3's Dense rounds once; the
    rule of versions 0-2 keeps Flax's two roundings."""
    lin = nn.Linear(2, 1)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor([[1.0, 2.0 ** -8]]))
        lin.bias.fill_(2.0 ** -8)
        x = torch.ones(1, 2, dtype=torch.bfloat16)
        y = getattr(N, rule)(lin, x)
        assert y.dtype == torch.bfloat16
        assert float(y) == want
        assert float(getattr(N, rule)(lin, x.float())) == 1 + 2 ** -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_version_3_takes_its_own_dense_rule(dtype, monkeypatch):
    """Every Dense of the trunk goes through ``_dense_once``: the embedding,
    seven a layer (the bias-free ``dense_4`` among them) and the shared
    generator once a layer; none through ``_dense``, Flax's rule, which a
    version-1 net still takes for each of its Denses."""
    calls = {"_dense": 0, "_dense_once": 0}
    for rule in calls:
        def counted(lin, x, _f=getattr(N, rule), _r=rule):
            calls[_r] += 1
            return _f(lin, x)
        monkeypatch.setattr(N, rule, counted)
    boards, valid = _boards(B=3)
    N.apply_inference(N.build_net(_cfg(dtype=dtype), "cpu"), boards, valid)
    assert calls == {"_dense": 0, "_dense_once": 1 + 8 * TINY["layers"]}
    calls["_dense_once"] = 0
    v1 = A.net_config_for(E.SplendorConfig(num_players=2), dtype=dtype)
    N.apply_inference(N.build_net(v1, "cpu"), boards, valid)
    assert calls["_dense"] > 0 and calls["_dense_once"] == 0


def test_bf16_train_step():
    """One Adam step of a bf16 version-3 net: the loss reaches every biased
    Dense through ``F.linear``, whose gradients land float32 and finite on
    the float32 parameters, and the step moves each of them."""
    net = _random_net(_cfg(dtype="bfloat16", dropout=0.1))
    boards, valid = _boards(B=6, seed=5)
    (log_pi, v, log_sd), _ = N.apply_train(
        net, boards, valid, torch.Generator().manual_seed(0))
    loss = (v.square().sum() - torch.where(valid, log_pi, 0.0).sum()
            + log_sd.exp().mean())
    loss.backward()
    biased = {n: m for n, m in net.named_modules()
              if isinstance(m, nn.Linear) and m.bias is not None
              and n not in {f"dense_{k}" for k in range(2, 8)}}   # not heads
    assert len(biased) == 1 + 6 * TINY["layers"]
    before = {}
    for n, m in biased.items():
        for p in (m.weight, m.bias):
            assert p.dtype == p.grad.dtype == torch.float32, n
            assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, n
        before[n] = (m.weight.detach().clone(), m.bias.detach().clone())
    torch.optim.Adam(net.parameters(), lr=1e-3).step()
    for n, m in biased.items():
        assert not torch.equal(m.weight, before[n][0]), n
        assert not torch.equal(m.bias, before[n][1]), n


def test_bf16_trunk_computes_in_bf16():
    """The encoder layers' outputs are bf16, the pooled row returns to
    float32 before the heads."""
    net = N.build_net(_cfg(dtype="bfloat16"), "cpu")
    seen = []
    for k in range(TINY["layers"]):
        getattr(net, f"enc_{k}").register_forward_hook(
            lambda m, i, o: seen.append(o.dtype))
    net.dense_2.register_forward_hook(lambda m, i, o: seen.append(i[0].dtype))
    boards, valid = _boards(B=3)
    N.apply_inference(net, boards, valid)
    assert seen == [torch.bfloat16] * TINY["layers"] + [torch.float32]


def test_published_shape():
    """BT4-1024x15x32h at 2 players: 154,031,321 parameters, and the sizes
    ``net_config_for`` gives by default."""
    cfg = A.net_config_for(E.SplendorConfig(num_players=2), nn_version=3,
                           width=1024)
    assert (cfg.layers, cfg.heads, cfg.ffn, cfg.smolgen) == \
        (15, 32, 1536, (32, 256, 256))
    with torch.device("meta"):
        net = N.NET_VERSIONS[3](cfg)
    assert N.count_params(net) == 154_031_321
    assert net.enc_0.alpha == pytest.approx(30 ** 0.25)
    assert net.enc_0.ln_0.eps == 1e-3


def test_cli_takes_nn_version_3():
    args = CLI.build_parser().parse_args(["--nn-version", "3"])
    cfg = CLI.args_to_config(args)
    net_cfg = A.net_config_for(E.SplendorConfig(num_players=2),
                               nn_version=cfg.nn_version)
    assert net_cfg.nn_version == 3
    assert N.NET_VERSIONS[net_cfg.nn_version] is N.SplendorNetBT4


def test_width_must_divide_into_heads():
    cfg = dataclasses.replace(_cfg(), heads=5)
    with pytest.raises(ValueError, match="multiple of heads"):
        N.build_net(cfg, "cpu")


def test_init_params_on_a_linear_without_bias():
    lin = nn.Linear(16, 4, bias=False)
    N.init_params(lin, torch.Generator().manual_seed(0))
    lim = (6.0 / 16) ** 0.5
    assert lin.bias is None
    assert float(lin.weight.detach().abs().max()) <= lim
    again = N.init_params(nn.Linear(16, 4, bias=False),
                          torch.Generator().manual_seed(0))
    assert torch.equal(lin.weight, again.weight)
    net = N.build_net(_cfg(), "cpu")
    assert net.enc_0.dense_4.bias is None and net.dense_1.bias is None
    assert torch.equal(net.gate_0.mul, torch.ones_like(net.gate_0.mul))
    assert torch.equal(net.enc_1.ln_3.weight, torch.ones(4 * 16))


def test_flax_layout_round_trip_and_dims():
    net = _random_net(_cfg())
    params, batch_stats = N.to_flax(net.state_dict())
    assert batch_stats == {} and N.running_stats(net) == {}
    assert set(params["EncoderLayer_1"]) == \
        {f"Dense_{k}" for k in range(7)} | {f"LayerNorm_{k}" for k in range(4)}
    assert set(params["Gating_0"]) == {"mul", "add"}
    assert params["Dense_1"]["kernel"].shape == (16, 56 * 56)
    sd = N.from_flax(params, batch_stats)
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert N.bt4_dims(params) == TINY


def test_selfplay_ply():
    """One self-play ply of 4 games at 8 simulations through
    ``SelfPlayEngine``, the leaves evaluated by the version-3 net."""
    env_cfg = E.SplendorConfig(num_players=2)
    net_cfg = _cfg()
    net = _random_net(net_cfg)
    eng = SP.SelfPlayEngine(
        env_cfg, A.make_eval_fn(net_cfg),
        SP.SelfPlayConfig(batch_size=4, num_sims=8, ratio_full=2,
                          prob_full=0.5, max_moves=1, chunk_moves=1),
        device="cpu")
    it, stats = eng.run_games(net, torch.Generator().manual_seed(0))
    assert stats["rollouts"] > 0
    assert it is not None and len(it.pi) > 0
    assert np.isfinite(it.pi).all()
    np.testing.assert_allclose(it.pi.sum(-1), 1.0, atol=1e-5)


def test_fit_chunk():
    """One train chunk (dropout on, augmentation on): finite loss, and
    every parameter that the loss reaches has moved."""
    env_cfg = E.SplendorConfig(num_players=2)
    net_cfg = _cfg(dropout=0.1)
    state = TR.init_train_state(net_cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    before = {k: v.clone() for k, v in state.net.state_dict().items()}
    cfg = TR.TrainConfig(batch_size=8, epochs=1)
    chunk = TR.make_train_chunk(env_cfg, net_cfg, cfg)
    state, metrics = TR.fit(state, TR.make_train_step(env_cfg, net_cfg, cfg),
                            replay_buffer(0, tag=False), cfg,
                            np.random.default_rng(0),
                            torch.Generator().manual_seed(1),
                            train_chunk_fn=chunk, chunk_steps=8)
    assert state.step == 8                     # 56 examples: one chunk
    assert np.isfinite(float(metrics["loss"]))
    after = state.net.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert set(moved) == set(before)


def test_coach_checkpoint_round_trip(tmp_path, monkeypatch):
    """A coach iteration of the tiny version 3 (self-play, a fit, the
    gate), its state saved, then a new coach that loads the file: weights
    and Adam moments bit-equal; ``load_net`` reads the sizes from the
    weights."""
    sizes = dict(TINY)
    del sizes["width"]
    base = A.net_config_for
    monkeypatch.setattr(A, "net_config_for",
                        lambda *a, **k: base(*a, **{**sizes, **k}))
    cfg = CoachConfig(num_players=2, score_win=2, num_iters=1,
                      games_per_iter=4, selfplay_batch=4, num_sims=8,
                      ratio_full=2, prob_full=0.5, arena_games=4,
                      gate_num_sims=4, epochs=1, batch_size=8,
                      train_chunk_steps=4, nn_version=3, net_width=64,
                      gate_mode="always", checkpoint_dir=str(tmp_path),
                      seed=1)
    coach = Coach(cfg, device="cpu")
    coach.learn()
    coach._save("trained.pt")
    want = coach.train_state
    other = Coach(cfg, device="cpu")
    other.load_checkpoint(str(tmp_path), "trained.pt", load_examples=False)
    got = other.train_state
    sd_w, sd_g = want.net.state_dict(), got.net.state_dict()
    assert set(sd_w) == set(sd_g)
    for k in sd_w:
        assert torch.equal(sd_w[k], sd_g[k]), k
    pw = dict(want.net.named_parameters())
    pg = dict(got.net.named_parameters())
    for k in pw:
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(want.opt.state[pw[k]][m],
                               got.opt.state[pg[k]][m]), (k, m)
    monkeypatch.setattr(A, "net_config_for", base)
    net, meta = C.load_net(str(tmp_path / "trained.pt"),
                           E.SplendorConfig(num_players=2), "cpu")
    assert meta["nn_version"] == 3 and net.cfg.layers == 2
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd_w[k]), k


def test_counters_of_boards_and_tokens():
    """``infer`` counts the boards and tokens it evaluates while a profiler
    records, and nothing otherwise."""
    net = N.build_net(_cfg(), "cpu")
    boards, valid = _boards(B=5)
    profiling._counts.clear()
    N.infer(net, boards, valid)
    assert "net.boards" not in profiling.counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        N.infer(net, boards, valid)
        N.infer(net, boards[:2], valid[:2])
    c = profiling.counters()
    assert (c["net.boards"], c["net.tokens"]) == (7, 7 * 56)
    profiling._counts.clear()


def test_tools_refuse_version_3(tmp_path):
    net = N.build_net(_cfg(), "cpu")
    params, bs = N.to_flax(net.state_dict())
    with pytest.raises(ValueError, match="nn_version 3"):
        OX.export_onnx(net.cfg, params, bs, str(tmp_path / "x.onnx"))
    with pytest.raises(ValueError, match="nn_version 3"):
        TI.load_as_bundle(str(tmp_path / "missing.pt"), net.cfg)
    C.save_checkpoint(str(tmp_path), "v3.pt", params=params, batch_stats=bs,
                      meta={"nn_version": 3, "net_width": 64})
    for fmt in ("onnx", "pt2"):
        with pytest.raises(ValueError, match="nn_version 3"):
            EX.main([str(tmp_path / "v3.pt"), "--format", fmt,
                     "-o", str(tmp_path / f"x.{fmt}"), "--device", "cpu"])
