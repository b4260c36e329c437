"""Port parity: the PyTorch SplendorNet against the Flax one.

Weights go from Flax to the port through ``from_flax`` (for ``init_params``
weights and for ``runs/r6/best.pt`` read by the port's own checkpoint
reader).  Both forwards run in float32 on the CPU; they agree within
``atol=1e-5`` because the two frameworks sum the matmuls in other orders.
A fresh init's score-diff log-probabilities reach ~20 nats, where float32 itself
resolves only ~4e-6, so its ``log_sdiff`` adds ``rtol=2e-6`` (a few ULPs of
the value); the trained r6 net is held to ``atol=1e-5`` everywhere."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.models import splendor_net as JN
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.utils import checkpoint as C

R6 = os.path.join(os.path.dirname(__file__), "..", "runs", "r6")


def _inputs(num_players, B=24, seed=0):
    """Real positions (random legal play) as float boards + valid masks."""
    cfg = E.SplendorConfig(num_players=num_players)
    rng = np.random.default_rng(seed)
    s = E.init_with_uniforms(
        cfg, torch.from_numpy(rng.random((B, 24), dtype=np.float32)),
        torch.from_numpy(np.stack([rng.permutation(10)[:cfg.num_nobles]
                                   for _ in range(B)])))
    for t in range(int(rng.integers(5, 25))):
        v = E.valid_moves(cfg, s, 0).numpy()
        acts = np.array([rng.choice(np.flatnonzero(r)) for r in v])
        s, nxt = E.step(cfg, s, torch.from_numpy(acts), 0,
                        torch.from_numpy(rng.random((B, 2), np.float32)),
                        False)
        s = E.swap_players(cfg, s, nxt)
    valid = E.valid_moves(cfg, s, 0)
    return cfg, s.to(torch.float32), valid


def _compare(net_cfg, params, batch_stats, boards, valid, sd_rtol=0.0):
    jp, jv, jsd = JN.apply_inference(net_cfg, params, batch_stats,
                                     jnp.asarray(boards.numpy()),
                                     jnp.asarray(valid.numpy()))
    net = N.build_net(N.NetConfig(**net_cfg.__dict__), device="cpu")
    net.load_state_dict(N.from_flax(params, batch_stats))
    tp, tv, tsd = N.apply_inference(net, boards, valid)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tsd.numpy(), np.asarray(jsd), atol=1e-5,
                               rtol=sd_rtol)
    assert (tp.numpy()[~valid.numpy()] == 0).all()


@pytest.mark.parametrize("num_players", [2, 4])
def test_init_params_parity(num_players):
    cfg, boards, valid = _inputs(num_players)
    jcfg = JE.SplendorConfig(num_players=num_players)
    net_cfg = JA.net_config_for(jcfg, nn_version=1, width=128)
    params, batch_stats = JN.init_params(net_cfg, jax.random.PRNGKey(7))
    # non-trivial running statistics, so eval-mode BatchNorm is exercised;
    # variances in [1, 2) keep the untrained trunk's activations moderate
    rng = np.random.default_rng(num_players)
    batch_stats = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + (
            1.0 + rng.random(x.shape, np.float32)
            if "var" in jax.tree_util.keystr(p)
            else 0.1 * rng.random(x.shape, np.float32)), batch_stats)
    params = jax.tree_util.tree_map(np.asarray, params)
    assert N.NetConfig(**net_cfg.__dict__) == A.net_config_for(cfg)
    _compare(net_cfg, params, batch_stats, boards, valid, sd_rtol=2e-6)


def test_r6_checkpoint_parity():
    ckpt = C.load_checkpoint(R6, "best.pt")
    assert ckpt["meta"]["nn_version"] == 1 and ckpt["meta"]["net_width"] == 128
    cfg, boards, valid = _inputs(2, seed=3)
    net_cfg = JA.net_config_for(JE.SplendorConfig(num_players=2))
    _compare(net_cfg, ckpt["params"], ckpt["batch_stats"], boards, valid)


def test_eval_fn_matches_apply_inference():
    cfg, boards, valid = _inputs(2, B=6, seed=5)
    net = N.build_net(A.net_config_for(cfg), device="cpu")
    probs, v = A.make_eval_fn(A.net_config_for(cfg))(net, boards, valid)
    p2, v2, _ = N.apply_inference(net, boards, valid)
    assert torch.equal(probs, p2) and torch.equal(v, v2)
    up, uv = A.make_uniform_eval_fn(cfg)(None, boards, valid)
    np.testing.assert_allclose(up.sum(1).numpy(), 1.0, rtol=1e-6)
    assert (uv == 0).all()


def test_eval_fn_rejects_other_net():
    cfg, boards, valid = _inputs(2, B=2, seed=6)
    net = N.build_net(A.net_config_for(cfg, width=64), device="cpu")
    with pytest.raises(ValueError, match="built from"):
        A.make_eval_fn(A.net_config_for(cfg))(net, boards, valid)
