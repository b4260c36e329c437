"""Port parity: checkpoints move between the packages.

- The port's checkpoint loads strictly in the JAX package
  (``load_network`` with ``target_params``) and gives the same forward
  (atol 1e-5, the net tests' tolerance).
- A JAX checkpoint with Adam moments loads strictly in the port, moments
  included; one more step on each side from it gives equal parameters
  within the train-step tolerance of ``test_torch_port_train.py``.
- ``transfer_partial`` slices the same leaves as the JAX one (exact), for
  a narrower trunk, the 406 -> 409 action-space growth and v1 -> v2.
- The load chain falls back and refuses exactly as the JAX one
  (``tests/test_train_loop_qol.py``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.models import splendor_net as JN
from alphazero_tpu.train import trainer as JTR
from alphazero_tpu.utils import checkpoint as JCKPT
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.train import trainer as TR
from alphazero_tpu_torch.utils import checkpoint as C
from tests.test_torch_port_train import _one_thread  # noqa: F401
from tests.test_torch_port_train import batch_np, jax_net

R6 = os.path.join(os.path.dirname(__file__), "..", "runs", "r6")
_jinit = jax.jit(JN.init_params, static_argnums=0)
_jinfer = jax.jit(JN.apply_inference, static_argnums=0)


def _jcfg(**kw):
    base = dict(dropout=0.0, nn_version=1, width=48)
    base.update(kw)
    return JA.net_config_for(JE.SplendorConfig(), **base)


def _port_state(jcfg, seed=0):
    return TR.init_train_state(N.NetConfig(**jcfg.__dict__),
                               torch.Generator().manual_seed(seed), "cpu")


def _save_port(folder, name, state):
    params, bs = N.to_flax(state.net.state_dict())
    C.save_checkpoint(str(folder), name, params=params, batch_stats=bs,
                      opt_state=TR.opt_state_to_flax(state),
                      meta={"nn_version": state.net.cfg.nn_version})


def _port_step(state, b, lr=1e-3):
    step = TR.make_train_step(E.SplendorConfig(), state.net.cfg,
                              TR.TrainConfig(augment=False))
    return step(state, b, lr, 10.0, torch.Generator())[0]


def test_port_checkpoint_loads_strictly_in_jax(tmp_path):
    jcfg, _, _, net = jax_net(1, 48, seed=8)
    state = TR.init_train_state(net.cfg, device="cpu")
    state.net.load_state_dict(net.state_dict())
    b = batch_np(2, 16, seed=1)
    state = _port_step(state, b)
    _save_port(tmp_path, "best.pt", state)
    target, _ = _jinit(jcfg, jax.random.PRNGKey(9))
    ck = JCKPT.load_network(str(tmp_path), "best.pt", target)
    assert ck["load_mode"] == "strict" and ck["load_source"] == "best.pt"
    assert int(ck["opt_state"]["count"]) == 1
    boards = b["boards"].astype(np.float32)
    jp, jv, jsd = _jinfer(jcfg, ck["params"], ck["batch_stats"],
                          jnp.asarray(boards), jnp.asarray(b["valids"]))
    tp, tv, tsd = N.apply_inference(state.net, torch.from_numpy(boards),
                                    torch.from_numpy(b["valids"]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tsd.numpy(), np.asarray(jsd), atol=1e-5)


def test_jax_checkpoint_with_adam_loads_in_port(tmp_path):
    jcfg, params, bs, _ = jax_net(1, 48, seed=6)
    env = JE.SplendorConfig()
    jstep = JTR.make_train_step(env, jcfg, JTR.TrainConfig(augment=False))
    jstate = JTR.TrainState(params, bs, optax.scale_by_adam().init(params),
                            jnp.zeros((), jnp.int32))
    b1, b2 = batch_np(2, 16, seed=2), batch_np(2, 16, seed=3)
    lr = 1e-3

    def jax_step(st, b):
        return jstep(st, {k: jnp.asarray(v) for k, v in b.items()},
                     jnp.float32(lr), jnp.float32(10.0),
                     jax.random.PRNGKey(0))[0]
    jstate = jax_step(jstate, b1)
    JCKPT.save_checkpoint(str(tmp_path), "temp.pt", params=jstate.params,
                          batch_stats=jstate.batch_stats,
                          opt_state=jstate.opt_state, meta={})
    state = _port_state(jcfg, seed=1)
    target, _ = N.to_flax(state.net.state_dict())
    ck = C.load_network(str(tmp_path), "temp.pt", target, fallback=False)
    assert ck["load_mode"] == "strict"
    state.net.load_state_dict(N.from_flax(ck["params"], ck["batch_stats"]))
    state = TR.load_opt_state(state, ck["opt_state"])
    loaded = TR.opt_state_to_flax(state)
    assert int(loaded["count"]) == 1
    for (k, a), (_, want) in zip(C.tree_items(loaded["nu"]),
                                 C.tree_items(jstate.opt_state[2])):
        assert np.array_equal(a, np.asarray(want)), k
    # one more step on each side
    jstate = jax_step(jstate, b2)
    state = _port_step(state, b2, lr)
    assert int(TR.opt_state_to_flax(state)["count"]) == 2
    tp, _ = N.to_flax(state.net.state_dict())
    mu = dict(C.tree_items(jstate.opt_state[1]))
    for k, want in C.tree_items(jstate.params):
        got, want = dict(C.tree_items(tp))[k], np.asarray(want)
        big = np.abs(np.asarray(mu[k])) > 1e-7
        np.testing.assert_allclose(got[big], want[big], atol=1e-5, rtol=1e-4,
                                   err_msg=str(k))
        assert np.abs(got - want).max() <= 2 * lr, k


def test_r6_checkpoint_resumes_adam():
    """``runs/r6/best.pt`` (JAX, v1, width 128) loads strictly with its
    optax ``ScaleByAdamState`` moments."""
    from alphazero_tpu_torch.games.splendor import adapter as A
    state = TR.init_train_state(A.net_config_for(E.SplendorConfig()),
                                device="cpu")
    target, _ = N.to_flax(state.net.state_dict())
    ck = C.load_network(R6, "best.pt", target, fallback=False)
    assert ck["load_mode"] == "strict"
    count, mu, _ = ck["opt_state"]
    state = TR.load_opt_state(state, ck["opt_state"])
    st = state.opt.state[state.net.dense_0.weight]
    assert int(st["step"]) == int(count) > 0
    assert np.array_equal(st["exp_avg"].numpy().T, mu["Dense_0"]["kernel"])


def _tp_pair(jcfg_from, jcfg_to):
    src, _ = _jinit(jcfg_from, jax.random.PRNGKey(0))
    dst, _ = _jinit(jcfg_to, jax.random.PRNGKey(1))
    src = jax.tree_util.tree_map(np.asarray, src)
    dst = jax.tree_util.tree_map(np.asarray, dst)
    return (C.transfer_partial(src, dst), JCKPT.transfer_partial(src, dst),
            jcfg_to)


@pytest.mark.parametrize("change", ["width", "actions", "version"])
def test_transfer_partial_equal(change):
    base = _jcfg(width=128)
    to = {"width": dataclasses.replace(base, width=64),
          "actions": dataclasses.replace(base, action_size=409),
          "version": dataclasses.replace(base, nn_version=2)}[change]
    frm = dataclasses.replace(base, action_size=406) if change == "actions" \
        else base
    got, want, to = _tp_pair(frm, to)
    g, w = list(C.tree_items(got)), list(C.tree_items(want))
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert np.array_equal(a, np.asarray(b)), k
    if change == "actions":            # the PI head's shared columns
        src, _ = _jinit(frm, jax.random.PRNGKey(0))
        np.testing.assert_array_equal(got["Dense_7"]["kernel"][:, :406],
                                      np.asarray(src["Dense_7"]["kernel"]))
    net = N.build_net(N.NetConfig(**to.__dict__), device="cpu")
    _, bs = N.to_flax(net.state_dict())
    net.load_state_dict(N.from_flax(got, bs))     # strict in the port


def test_load_network_strict_and_partial(tmp_path):
    small = _jcfg(width=64)
    _save_port(tmp_path, "temp.pt", _port_state(small, seed=1))
    tgt, _ = N.to_flax(_port_state(small, seed=2).net.state_dict())
    ck = C.load_network(str(tmp_path), "temp.pt", tgt)
    assert ck["load_mode"] == "strict" and ck["load_source"] == "temp.pt"
    big = dataclasses.replace(small, width=128)
    tgt_big, _ = N.to_flax(_port_state(big, seed=3).net.state_dict())
    ck2 = C.load_network(str(tmp_path), "temp.pt", tgt_big)
    assert ck2["load_mode"] == "partial"
    for (_, a), (_, b) in zip(C.tree_items(ck2["params"]),
                              C.tree_items(tgt_big)):
        assert np.shape(a) == np.shape(b)


@pytest.mark.parametrize("version,small,big", [(1, 64, 128), (2, 256, 512)])
def test_partial_load_slices_batch_stats_and_coach_resumes(tmp_path, version,
                                                           small, big):
    """A partial load across a width change slices the running statistics
    against ``target_batch_stats`` as it slices the params, and a ``Coach``
    resumed from the narrower checkpoint runs its first forward.  A v1
    net's statistics are per channel (7 or 1), so 64 -> 128 leaves their
    shapes as they are; a v2 net's residual BatchNorms are as wide as its
    trunk, so 256 -> 512 slices them.  (The JAX ``Coach.load_checkpoint``
    keeps them unsliced, and its first forward fails there.)"""
    from alphazero_tpu_torch.train import coach as CO
    narrow = _jcfg(nn_version=version, width=small)
    state = _port_state(narrow, seed=1)
    with torch.no_grad():
        for k, v in N.running_stats(state.net).items():
            v.copy_(torch.rand(v.shape, generator=torch.Generator()
                               .manual_seed(len(k))) + 0.5)
    _save_port(tmp_path, "temp.pt", state)
    src_bs = N.to_flax(state.net.state_dict())[1]
    tgt, tgt_bs = N.to_flax(
        _port_state(dataclasses.replace(narrow, width=big)).net.state_dict())
    ck = C.load_network(str(tmp_path), "temp.pt", tgt,
                        target_batch_stats=tgt_bs)
    assert ck["load_mode"] == "partial"
    for tree, want in ((ck["params"], tgt), (ck["batch_stats"], tgt_bs)):
        got = dict(C.tree_items(tree))
        assert {k: np.shape(v) for k, v in got.items()} == \
            {k: np.shape(v) for k, v in C.tree_items(want)}
    sliced = dict(C.tree_items(ck["batch_stats"]))
    for k, v in C.tree_items(src_bs):
        sl = tuple(slice(0, min(a, b)) for a, b in zip(v.shape,
                                                       sliced[k].shape))
        np.testing.assert_array_equal(sliced[k][sl], v[sl])
    assert version == 1 or any(np.shape(v) != np.shape(sliced[k])
                               for k, v in C.tree_items(src_bs))

    coach = CO.Coach(CO.CoachConfig(
        nn_version=version, net_width=big, selfplay_batch=2, num_sims=4,
        arena_games=2, checkpoint_dir=str(tmp_path / "run")), device="cpu")
    coach.load_checkpoint(str(tmp_path), "temp.pt")
    cfg = E.SplendorConfig()
    boards = E.initial_state(cfg, 3, torch.Generator().manual_seed(0), "cpu")
    pi, v, _ = N.apply_inference(coach.train_state.net, boards,
                                 E.valid_moves(cfg, boards, 0))
    assert pi.shape == (3, 409) and torch.isfinite(v).all()


def test_load_network_fallback_chain(tmp_path):
    cfg = _jcfg()
    tgt, _ = N.to_flax(_port_state(cfg).net.state_dict())
    _save_port(tmp_path, "best.pt", _port_state(cfg, seed=4))
    ck = C.load_network(str(tmp_path), "nonexistent.pt", tgt)
    assert ck["load_source"] == "best.pt"
    (tmp_path / "best.pt").unlink()
    (tmp_path / "temp.pt").write_bytes(b"corrupt")
    _save_port(tmp_path, "checkpoint_2.pt", _port_state(cfg, seed=5))
    _save_port(tmp_path, "checkpoint_10.pt", _port_state(cfg, seed=6))
    ck = C.load_network(str(tmp_path), "temp.pt", tgt)
    assert ck["load_source"] == "checkpoint_10.pt"
    for f in ("temp.pt", "checkpoint_2.pt", "checkpoint_10.pt"):
        (tmp_path / f).unlink()
    with pytest.raises(FileNotFoundError):
        C.load_network(str(tmp_path), "temp.pt", tgt)


def test_load_network_strict_resume_refuses_substitutes(tmp_path):
    cfg = _jcfg()
    tgt, _ = N.to_flax(_port_state(cfg).net.state_dict())
    _save_port(tmp_path, "best.pt", _port_state(cfg, seed=4))
    with pytest.raises(FileNotFoundError):
        C.load_network(str(tmp_path), "typo.pt", tgt, fallback=False)
    assert C.load_network(str(tmp_path), "best.pt", tgt,
                          fallback=False)["load_source"] == "best.pt"


def test_settings_and_code_snapshot(tmp_path):
    C.save_settings(str(tmp_path), {"a": 1})
    C.save_settings(str(tmp_path), {"a": 1})
    assert not os.path.exists(tmp_path / "settings_v1.json")
    C.save_settings(str(tmp_path), {"a": 2, "num_iters": 3})
    assert os.path.exists(tmp_path / "settings_v1.json")
    assert C.compare_settings(str(tmp_path), {"a": 5, "num_iters": 9}) == \
        {"a": (2, 5)}
    C.save_code_snapshot(str(tmp_path / "snap"))
    out = os.listdir(tmp_path / "snap")
    assert out in (["code_snapshot.txt"], ["code_snapshot.tar.gz"])
