"""Port parity: the training half (net train mode, losses, symmetry and
the train step) against the JAX package; ``fit`` and the replay buffer are
in ``test_torch_port_fit.py``.

Weights go from Flax to the port with ``from_flax``; batches are made from
numpy seeds.  Tolerances, and why:

- train-mode outputs atol 1e-5 and new running statistics rtol 1e-5: the
  two frameworks sum matmuls in other orders; the running variance is the
  biased batch variance in both (an unbiased one would be off by n/(n-1),
  8/7 at batch 8, far outside 1e-5); running means near zero add atol
  1e-7 (a batch mean of cancelling activations);
- gradients: per leaf, max |port - JAX| <= 1e-6 + 1e-4 * max |JAX| (a
  backward pass sums in other orders; an entry that is a sum of
  cancelling terms carries the rounding of its terms, not of its value);
- losses rtol 1e-6 on fixed outputs;
- symmetry and ``onecycle_lr``: exact;
- one Adam step: Adam moments and running statistics atol 1e-5, rtol 1e-4;
  parameters atol 1e-5, rtol 1e-4 where |g| > 1e-6.  A first Adam step
  moves a weight by ~lr * g / (|g| + 1e-8), so where |g| is ~1e-8 or less a
  last-bit difference in g moves it by up to 2 * lr the other way; there
  the bound is 2 * lr.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.games.splendor import symmetry as JSYM
from alphazero_tpu.models import splendor_net as JN
from alphazero_tpu.train import losses as JL
from alphazero_tpu.train import trainer as JTR
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.games.splendor import symmetry as SYM
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.train import losses as L
from alphazero_tpu_torch.train import trainer as TR
from alphazero_tpu_torch.utils import checkpoint as C

R6 = os.path.join(os.path.dirname(__file__), "..", "runs", "r6")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small CPU ops run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def positions(num_players, B, seed, moves=(5, 40), noble_select=False):
    """Real positions from random legal play: ``(cfg, states int8 [B, R,
    7], valids [B, A])`` as port tensors."""
    cfg = E.SplendorConfig(num_players=num_players,
                           enable_noble_select=noble_select)
    rng = np.random.default_rng(seed)
    s = E.init_with_uniforms(
        cfg, torch.from_numpy(rng.random((B, 24), dtype=np.float32)),
        torch.from_numpy(np.stack([rng.permutation(10)[:cfg.num_nobles]
                                   for _ in range(B)])))
    for _ in range(int(rng.integers(*moves))):
        v = E.valid_moves(cfg, s, 0).numpy()
        acts = np.array([rng.choice(np.flatnonzero(r)) for r in v])
        s, nxt = E.step(cfg, s, torch.from_numpy(acts), 0,
                        torch.from_numpy(rng.random((B, 2), np.float32)),
                        False)
        s = E.swap_players(cfg, s, nxt)
    return cfg, s, E.valid_moves(cfg, s, 0)


def batch_np(num_players, B, seed):
    """A training batch as the replay buffer returns one."""
    _, s, valid = positions(num_players, B, seed)
    rng = np.random.default_rng(seed + 100)
    v = valid.numpy()
    pi = rng.random(v.shape) * v
    pi = pi / pi.sum(1, keepdims=True)
    winner = np.where(rng.random((B, num_players)) < 0.5, -1.0, 1.0)
    return {"boards": s.numpy(), "pi": pi.astype(np.float16),
            "winner": winner.astype(np.float16),
            "scdiff": rng.integers(-20, 20, (B, num_players)).astype(np.int8),
            "valids": v}


# whole-graph compiles: faster on the CPU than op-by-op dispatch
_jinit = jax.jit(JN.init_params, static_argnums=0)
_japply_train = jax.jit(JN.apply_train, static_argnums=0)


def jax_net(version, width, seed=0, dropout=0.0, num_players=2):
    """JAX config and ``init_params`` weights with non-trivial running
    statistics, and the port net holding the same."""
    jcfg = JA.net_config_for(JE.SplendorConfig(num_players=num_players),
                             dropout=dropout, nn_version=version, width=width)
    params, bs = _jinit(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    # the heads' output kernels scaled down, so that the untrained nets'
    # log-probabilities stay in a trained net's range (a fresh v2's reach
    # -60, where float32 resolves only ~4e-6)
    last = 6 if version == 2 else 5
    for k in range(last + 2, last + 8, 2):
        params[f"Dense_{k}"]["kernel"] = params[f"Dense_{k}"]["kernel"] * 0.1
    bs = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + (
            1.0 + rng.random(x.shape, np.float32)
            if "var" in jax.tree_util.keystr(p)
            else 0.1 * rng.random(x.shape, np.float32)), bs)
    net = N.build_net(N.NetConfig(**jcfg.__dict__), device="cpu")
    net.load_state_dict(N.from_flax(params, bs))
    return jcfg, params, bs, net


def _targets_jax(jcfg, b):
    return {"pi": jnp.asarray(b["pi"], jnp.float32),
            "v": jnp.asarray(b["winner"], jnp.float32),
            "scdiff": JL.scdiff_targets(jnp.asarray(b["scdiff"], jnp.int32),
                                        jcfg.num_scdiffs, jcfg.max_score_diff)}


def _targets_port(jcfg, b):
    return {"pi": torch.from_numpy(b["pi"].astype(np.float32)),
            "v": torch.from_numpy(b["winner"].astype(np.float32)),
            "scdiff": L.scdiff_targets(torch.from_numpy(b["scdiff"]),
                                       jcfg.num_scdiffs, jcfg.max_score_diff)}


def assert_trees_close(got, want, **tol):
    g, w = dict(C.tree_items(got)), dict(C.tree_items(want))
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                   err_msg=str(k), **tol)


NETS = [(1, 48), (1, 128), (2, 256)]


@pytest.mark.parametrize("version,width", NETS)
def test_train_forward_and_running_stats(version, width):
    jcfg, params, bs, net = jax_net(version, width)
    b = batch_np(2, 8, seed=version + width)
    (jlp, jv, jsd), jbs = _japply_train(
        jcfg, params, bs, jnp.asarray(b["boards"], jnp.float32),
        jnp.asarray(b["valids"]), jax.random.PRNGKey(0))
    (tlp, tv, tsd), _ = N.apply_train(
        net, torch.from_numpy(b["boards"]).float(),
        torch.from_numpy(b["valids"]))
    valid = b["valids"]
    np.testing.assert_allclose(tlp.detach().numpy()[valid],
                               np.asarray(jlp)[valid], atol=1e-5)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tsd.detach().numpy(), np.asarray(jsd),
                               atol=1e-5)
    _, new_bs = N.to_flax(net.state_dict())
    for k, want in C.tree_items(jbs):
        got = dict(C.tree_items(new_bs))[k]
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-7 if k[-1] == "mean" else 0.0,
                                   err_msg=str(k))


@pytest.mark.parametrize("version,width", NETS)
def test_loss_gradients(version, width):
    jcfg, params, bs, net = jax_net(version, width, seed=1)
    b = batch_np(2, 8, seed=7)
    boards, valids = b["boards"].astype(np.float32), b["valids"]

    def loss_fn(p):
        out, _ = JN.apply_train(jcfg, p, bs, jnp.asarray(boards),
                                jnp.asarray(valids), jax.random.PRNGKey(0))
        return JL.total_loss(out, _targets_jax(jcfg, b), 10.0)[0]
    jgrads = jax.jit(jax.grad(loss_fn))(params)
    out, _ = N.apply_train(net, torch.from_numpy(boards),
                           torch.from_numpy(valids))
    L.total_loss(out, _targets_port(jcfg, b), 10.0)[0].backward()
    tgrads, _ = N.to_flax({k: p.grad for k, p in net.named_parameters()})
    g = dict(C.tree_items(tgrads))
    assert set(g) == {k for k, _ in C.tree_items(jgrads)}
    for k, want in C.tree_items(jgrads):
        want = np.asarray(want)
        err = np.abs(g[k] - want).max()
        assert err <= 1e-6 + 1e-4 * np.abs(want).max(), (k, err)


def test_v2_eval_forward():
    jcfg, params, bs, net = jax_net(2, 256, seed=3, dropout=0.3)
    b = batch_np(2, 16, seed=11)
    boards = jnp.asarray(b["boards"], jnp.float32)
    jp, jv, jsd = jax.jit(JN.apply_inference, static_argnums=0)(
        jcfg, params, bs, boards, jnp.asarray(b["valids"]))
    tp, tv, tsd = N.apply_inference(net, torch.from_numpy(np.array(boards)),
                                    torch.from_numpy(b["valids"]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tsd.numpy(), np.asarray(jsd), atol=1e-5)
    assert N.count_params(net) == JN.count_params(params)


@pytest.mark.parametrize("version,width", [(0, 64), (1, 128), (2, 256)])
def test_flax_round_trip_exact(version, width):
    _, params, bs, net = jax_net(version, width, seed=5)
    p2, bs2 = N.to_flax(N.from_flax(params, bs))
    for got, want in ((p2, params), (bs2, bs)):
        g, w = dict(C.tree_items(got)), dict(C.tree_items(want))
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == np.float32 and np.array_equal(g[k], w[k]), k
    ck = C.load_checkpoint(R6, "best.pt")
    p3, bs3 = N.to_flax(N.from_flax(ck["params"], ck["batch_stats"]))
    assert all(np.array_equal(a, b) for (_, a), (_, b) in
               zip(C.tree_items(p3), C.tree_items(ck["params"])))


def test_flax_init_distribution():
    """``build_net`` draws Flax's initializers: kaiming-uniform kernels in
    U(-sqrt(6/in), sqrt(6/in)), zero biases, unit BatchNorm scale."""
    net = N.build_net(A.net_config_for(E.SplendorConfig()), device="cpu",
                      generator=torch.Generator().manual_seed(3))
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Linear):
            lim = np.sqrt(6.0 / m.in_features)
            w = m.weight.detach()
            assert w.abs().max() <= lim and w.abs().max() > 0.9 * lim, name
            assert float(w.std()) == pytest.approx(lim / np.sqrt(3), rel=0.2)
            assert (m.bias == 0).all()
        elif isinstance(m, N.FlaxBatchNorm):
            assert (m.weight == 1).all() and (m.bias == 0).all()
    again = N.build_net(A.net_config_for(E.SplendorConfig()), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    for a, b in zip(net.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="nn_version"):
        N.build_net(A.net_config_for(E.SplendorConfig(), nn_version=9),
                    device="cpu")


def test_dropout_train_mode():
    """Flax dropout: masks from the generator, kept units scaled by
    1/(1-rate), and none in eval mode."""
    cfg = A.net_config_for(E.SplendorConfig(), dropout=0.5)
    net = N.build_net(cfg, device="cpu")
    x = torch.ones(4, 1000)
    net.train()
    y = net._drop(x, torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert 0.45 < float((y == 0).float().mean()) < 0.55
    assert torch.equal(y, net._drop(x, torch.Generator().manual_seed(0)))
    net.eval()
    assert torch.equal(net._drop(x, None), x)


@pytest.mark.parametrize("num_players", [2, 4])
def test_total_loss_and_metrics(num_players):
    rng = np.random.default_rng(num_players)
    B, A_ = 12, 409
    nsd = {2: 2, 3: 3, 4: 4}[num_players]
    logits = rng.normal(size=(B, A_)).astype(np.float32)
    log_pi = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    v = np.tanh(rng.normal(size=(B, num_players))).astype(np.float32)
    sd = rng.normal(size=(B, nsd, 31)).astype(np.float32)
    log_sd = sd - np.log(np.exp(sd).sum(-1, keepdims=True))
    pi = rng.random((B, A_)).astype(np.float32)
    pi /= pi.sum(1, keepdims=True)
    scdiff = rng.integers(-25, 25, (B, num_players))
    winner = rng.choice([-1.0, 1.0], (B, num_players)).astype(np.float32)
    jt = {"pi": jnp.asarray(pi), "v": jnp.asarray(winner),
          "scdiff": JL.scdiff_targets(jnp.asarray(scdiff), nsd, 15)}
    tt = {"pi": torch.from_numpy(pi), "v": torch.from_numpy(winner),
          "scdiff": L.scdiff_targets(torch.from_numpy(scdiff), nsd, 15)}
    np.testing.assert_array_equal(tt["scdiff"].numpy(), np.asarray(jt["scdiff"]))
    jl, jm = JL.total_loss(tuple(map(jnp.asarray, (log_pi, v, log_sd))), jt,
                           7.5)
    tl, tm = L.total_loss(tuple(map(torch.from_numpy, (log_pi, v, log_sd))),
                          tt, 7.5)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


@pytest.mark.parametrize("num_players", [2, 3, 4])
def test_random_symmetry_equal(num_players):
    """The port, given the choices JAX's key makes, permutes boards, pi and
    valids exactly as ``batched_random_symmetry`` does."""
    B = 24
    cfg, s, valid = positions(num_players, B, seed=num_players,
                              moves=(30, 60))
    jcfg = JE.SplendorConfig(num_players=num_players)
    states = s.numpy()
    rsv = states[:, cfg.row_prsv:cfg.row_prsv + 6 * num_players:2, :5]
    assert (np.abs(rsv).sum(-1) > 0).sum() > B    # reserves to permute
    rng = np.random.default_rng(num_players)
    pi = rng.random(valid.shape).astype(np.float16)
    key = jax.random.PRNGKey(num_players)
    js, jp, jv = JSYM.batched_random_symmetry(jcfg)(
        key, jnp.asarray(states), jnp.asarray(pi), jnp.asarray(valid.numpy()))
    tiers, rsvs = [], []
    for k in jax.random.split(key, B):
        k_tier, k_rsv = jax.random.split(k)
        tiers.append(np.asarray(jax.random.randint(k_tier, (3,), 0, 4)))
        rsvs.append(np.asarray(jax.random.randint(k_rsv, (num_players,), 0,
                                                  3)))
    ts, tp, tv = SYM.apply_symmetry(cfg, s, torch.from_numpy(pi), valid,
                                    np.stack(tiers), np.stack(rsvs))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not np.array_equal(ts.numpy(), states)
    one = SYM.random_symmetry(cfg, tiers[3], rsvs[3], s[3],
                              torch.from_numpy(pi[3]), valid[3])
    for got, want in zip(one, (ts[3], tp[3], tv[3])):
        assert torch.equal(got, want)
    drawn = SYM.batched_random_symmetry(cfg)(torch.Generator().manual_seed(0),
                                             s, torch.from_numpy(pi), valid)
    assert drawn[0].shape == s.shape and drawn[2].sum() == valid.sum()


def test_onecycle_lr_equal():
    for total in (1, 2, 3, 7, 64, 100, 1000):
        for step in range(total + 2):
            for peak in (3e-4, 1e-2):
                assert (TR.onecycle_lr(step, total, peak)
                        == JTR.onecycle_lr(step, total, peak))


def _state_trees(state):
    params, bs = N.to_flax(state.net.state_dict())
    return params, bs, TR.opt_state_to_flax(state)


def test_one_train_step_equal():
    """Augmentation off, dropout 0: parameters, running statistics and Adam
    moments after one step agree with the JAX step."""
    jcfg, params, bs, _ = jax_net(1, 128, seed=2)
    env = JE.SplendorConfig()
    tcfg = dict(augment=False, batch_size=16)
    jstep = JTR.make_train_step(env, jcfg, JTR.TrainConfig(**tcfg))
    jstate = JTR.TrainState(params, bs, optax.scale_by_adam().init(params),
                            jnp.zeros((), jnp.int32))
    b = batch_np(2, 16, seed=21)
    lr = 1e-3
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                       jnp.float32(lr), jnp.float32(10.0),
                       jax.random.PRNGKey(1))
    state = TR.init_train_state(N.NetConfig(**jcfg.__dict__), device="cpu")
    state.net.load_state_dict(N.from_flax(params, bs))
    step = TR.make_train_step(E.SplendorConfig(), state.net.cfg,
                              TR.TrainConfig(**tcfg))
    state, tm = step(state, b, lr, 10.0, torch.Generator().manual_seed(1))
    assert state.step == 1
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    tp, tbs, topt = _state_trees(state)
    assert_trees_close(tbs, jstate.batch_stats, atol=1e-5, rtol=1e-4)
    count, mu, nu = jstate.opt_state
    assert int(topt["count"]) == int(count) == 1
    assert_trees_close(topt["mu"], mu, atol=1e-5, rtol=1e-4)
    assert_trees_close(topt["nu"], nu, atol=1e-5, rtol=1e-4)
    g_mu = dict(C.tree_items(mu))
    for k, want in C.tree_items(jstate.params):
        got, want = dict(C.tree_items(tp))[k], np.asarray(want)
        big = np.abs(np.asarray(g_mu[k])) > 1e-7      # |g| > 1e-6
        np.testing.assert_allclose(got[big], want[big], atol=1e-5, rtol=1e-4,
                                   err_msg=str(k))
        assert np.abs(got - want).max() <= 2 * lr, k
