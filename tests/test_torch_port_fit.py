"""Port parity: the replay buffer and ``fit`` against the JAX package.

- The ``azt-replay-v2`` file is byte-equal from either package and loads
  in the other; ``sample`` draws the same rows for a seed, with and
  without surprise weighting and a held-out subset (exact).
- ``fit``'s sample ids, learning-rate list and step count equal the JAX
  ``fit``'s, fused (a chunk of 4) and unfused, with a validation split
  (exact); trained from the same weights on the same draws, the final
  parameters and validation metrics agree within the tolerance stated in
  ``test_fit_trains_like_jax``.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.train import replay as JR
from alphazero_tpu.train import trainer as JTR
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.train import replay as R
from alphazero_tpu_torch.train import trainer as TR
from tests.test_torch_port_train import _one_thread  # noqa: F401
from tests.test_torch_port_train import (_state_trees, assert_trees_close,
                                         batch_np, jax_net)


def replay_buffer(seed, sizes=(30, 26), num_players=2, tag=True):
    """A buffer of real positions; with ``tag`` its rows are unique
    (boards[:, 0, 0] holds the row id mod 128 and pi[:, 0] the id)."""
    its = []
    base = 0
    for i, n in enumerate(sizes):
        b = batch_np(num_players, n, seed + i)
        if tag:
            b["pi"][:, 0] = np.arange(base, base + n)
            b["boards"][:, 0, 0] = np.arange(base, base + n) % 128
        rng = np.random.default_rng(seed + 50 + i)
        its.append(R.Iteration(**b, surprise=rng.random(
            (n, num_players)).astype(np.float16)))
        base += n
    buf = R.ReplayBuffer()
    for it in its:
        buf.add_iteration(it)
    return buf


def _jax_buffer(buf):
    jb = JR.ReplayBuffer()
    for it in buf.iterations:
        jb.add_iteration(JR.Iteration(**it.__dict__))
    return jb


def test_replay_files_byte_compatible(tmp_path):
    buf = replay_buffer(0)
    jb = _jax_buffer(buf)
    buf.save(str(tmp_path / "port.examples"))
    jb.save(str(tmp_path / "jax.examples"))
    assert ((tmp_path / "port.examples").read_bytes()
            == (tmp_path / "jax.examples").read_bytes())
    from_jax = R.ReplayBuffer.load(str(tmp_path / "jax.examples"))
    from_port = JR.ReplayBuffer.load(str(tmp_path / "port.examples"))
    for a, b, c in zip(buf.iterations, from_jax.iterations,
                       from_port.iterations):
        for name, arr in a.__dict__.items():
            for other in (b, c):
                got = getattr(other, name)
                assert got.dtype == arr.dtype and np.array_equal(got, arr)
    # the v1 layout (a pickled list of array dicts) still loads
    with open(tmp_path / "v1.examples", "wb") as f:
        pickle.dump([it.__dict__ for it in buf.iterations], f)
    assert len(R.ReplayBuffer.load(str(tmp_path / "v1.examples"))) == len(buf)


@pytest.mark.parametrize("surprise", [False, True])
@pytest.mark.parametrize("k", [10, 200])
def test_replay_sample_ids_equal(surprise, k):
    buf = replay_buffer(1)
    jb = _jax_buffer(buf)
    allowed = np.random.default_rng(0).permutation(len(buf))[:40]
    for allow in (None, allowed):
        got = buf.sample(k, np.random.default_rng(5), surprise, allow)
        want = jb.sample(k, np.random.default_rng(5), surprise, allow)
        ids = got["pi"][:, 0].astype(int)
        if allow is not None:
            assert set(ids) <= set(allow)
        for name in want:
            assert np.array_equal(got[name], want[name]), name
    assert len(buf.sample(k, np.random.default_rng(1))["boards"]) == k


def _record_fit(fit, backend, val_split, chunk, seed=3):
    """``fit``'s draws with the step replaced by a recorder: the boards of
    every minibatch, the rates and the step count."""
    buf = replay_buffer(seed) if backend == "port" else _jax_buffer(
        replay_buffer(seed))
    seen = {"ids": [], "lrs": [], "steps": 0}

    def zero():
        return torch.zeros(()) if backend == "port" else jnp.float32(0)

    def chunk_fn(state, batches, lrs, vlw, key):
        seen["ids"].append(np.asarray(batches["pi"])[..., 0].astype(int))
        seen["lrs"].extend(np.asarray(lrs, np.float32).tolist())
        seen["steps"] += len(lrs)
        return state, {"loss": zero()}

    def step_fn(state, batch, lr, vlw, key):
        seen["ids"].append(np.asarray(batch["pi"])[None, :, 0].astype(int))
        seen["lrs"].append(float(np.float32(lr)))
        seen["steps"] += 1
        return state, {"loss": zero()}

    cfg_cls = TR.TrainConfig if backend == "port" else JTR.TrainConfig
    cfg = cfg_cls(batch_size=8, epochs=2, val_split=val_split)
    key = (torch.Generator() if backend == "port"
           else jax.random.PRNGKey(0))
    _, metrics = fit(None, step_fn, buf, cfg, np.random.default_rng(seed),
                     key, eval_step_fn=lambda s, b: {"loss": zero()},
                     train_chunk_fn=chunk_fn if chunk else None,
                     chunk_steps=chunk or 64)
    seen["ids"] = np.concatenate([np.reshape(i, (-1,)) for i in seen["ids"]])
    return seen, metrics


@pytest.mark.parametrize("chunk", [4, 0])
def test_fit_draws_equal(chunk):
    """Sample ids, the learning-rate list and the step count equal the JAX
    ``fit``'s, fused (a chunk of 4) and unfused, with a validation split."""
    got, gm = _record_fit(TR.fit, "port", 0.25, chunk)
    want, wm = _record_fit(JTR.fit, "jax", 0.25, chunk)
    assert got["steps"] == want["steps"] == (8 if chunk else 10)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert got["lrs"] == want["lrs"]
    assert set(gm) == set(wm) == {"loss", "val_loss"}


def test_fit_trains_like_jax():
    """Two epochs of the fused fit (chunk 4, val_split 0.25, augmentation
    off, dropout 0) from the same weights on the same draws: the final
    parameters agree within 1e-3 and the validation metrics within 1e-3
    relative.  Eight Adam steps at lr <= 1e-3 move a weight by at most
    ~8e-3; the bound leaves room for a few near-zero gradients whose
    sign flips between the frameworks (see the module docstring)."""
    jcfg, params, bs, _ = jax_net(1, 48, seed=4)
    env = JE.SplendorConfig()
    kw = dict(batch_size=8, epochs=2, val_split=0.25, augment=False,
              learn_rate=1e-3)
    jt = JTR.TrainConfig(**kw)
    jstate = JTR.TrainState(params, bs, optax.scale_by_adam().init(params),
                            jnp.zeros((), jnp.int32))
    jstate, jm = JTR.fit(jstate, None, _jax_buffer(replay_buffer(6, tag=False)), jt,
                         np.random.default_rng(2), jax.random.PRNGKey(0),
                         eval_step_fn=JTR.make_eval_step(env, jcfg, jt),
                         train_chunk_fn=JTR.make_train_chunk(env, jcfg, jt),
                         chunk_steps=4)
    ncfg = N.NetConfig(**jcfg.__dict__)
    tt = TR.TrainConfig(**kw)
    state = TR.init_train_state(ncfg, device="cpu")
    state.net.load_state_dict(N.from_flax(params, bs))
    ecfg = E.SplendorConfig()
    state, tm = TR.fit(state, None, replay_buffer(6, tag=False), tt,
                       np.random.default_rng(2), torch.Generator(),
                       eval_step_fn=TR.make_eval_step(ecfg, ncfg, tt),
                       train_chunk_fn=TR.make_train_chunk(ecfg, ncfg, tt),
                       chunk_steps=4)
    assert state.step == int(jstate.step) == 8
    assert set(tm) == set(jm)
    for k in jm:
        if k.startswith("val_"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, atol=1e-6,
                                       err_msg=k)
    tp, tbs, _ = _state_trees(state)
    assert_trees_close(tp, jax.tree_util.tree_map(np.asarray, jstate.params),
                       atol=1e-3)
    assert_trees_close(tbs, jax.tree_util.tree_map(np.asarray,
                                                   jstate.batch_stats),
                       rtol=1e-3, atol=1e-5)
