"""Port parity: data-parallel training and self-play on torch.distributed
(``parallel/distributed.py``, ``parallel/mesh.py``, the trainer and the
self-play engine with a mesh), with W=2 processes over gloo.

The counterparts of ``tests/test_parallel.py``: two ranks are spawned with
``torch.multiprocessing`` and joined through a file rendezvous under the
test's temporary directory (``parallel/dryrun.spawn``, 120 s for the
group); their bodies are in ``tests/torch_port_mp_worker.py``.

- The sharded env step and valid moves, gathered, equal the JAX env's on
  the global batch exactly.
- The sharded train step (width 48, batch 16, lr 1e-3):
  - dropout 0 and augmentation off: equals JAX's
    ``MP.make_sharded_train_step`` on the conftest's 8-device CPU mesh,
    loss rtol 2e-5, params rtol 2e-4 / atol 2e-6, as
    ``tests/test_parallel.py`` holds JAX's to its single-device step;
  - dropout 0.3 and augmentation on: equals the port's single-process
    step on the global batch with the same generator, within the same
    tolerances (its metrics rtol 2e-5);
  - in both, the parameters are bit-identical on the two ranks;
  - on the (host, env) mesh (two hosts of one rank) it equals the 1-D
    mesh's step exactly;
  - ``make_train_chunk`` with the mesh (two stacked minibatches, dropout
    and augmentation on) equals the one-process chunk within the same
    tolerances.
- ``host_local_to_global`` and ``global_to_host_local`` round-trip;
  ``is_primary``, ``sync_hosts``, ``replicate_from_host0`` and
  ``replicate`` behave as rank 0's.
- Sharded self-play: a 2-rank run equals two single-process runs of its
  blocks with the same generators (from ``(seed, rank)``) exactly, and the
  gathered counts are the sums.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.models import splendor_net as JN
from alphazero_tpu.parallel import distributed as JD
from alphazero_tpu.parallel import mesh as JMP
from alphazero_tpu.train import trainer as JTR
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.parallel import distributed as D
from alphazero_tpu_torch.parallel.dryrun import spawn
from alphazero_tpu_torch.train import selfplay as SP
from alphazero_tpu_torch.train import trainer as TR
from alphazero_tpu_torch.utils import checkpoint as C
from tests import torch_port_mp_worker as W
from tests.test_torch_port_train import _one_thread  # noqa: F401
from tests.test_torch_port_train import batch_np, positions

ENV = JE.SplendorConfig(num_players=2)
B, LR = 16, 1e-3
_jinit = jax.jit(JN.init_params, static_argnums=0)
_jvalid = jax.jit(jax.vmap(lambda s: JE.valid_moves(ENV, s, 0)))
_jstep = jax.jit(jax.vmap(lambda s, a, u: JE.step(ENV, s, a, 0, u, False)))
STEP_TOL = dict(rtol=2e-4, atol=2e-6)
# two stacked minibatches at two rates, for make_train_chunk with a mesh
_b1, _b2 = batch_np(2, B, seed=7), batch_np(2, B, seed=8)
CHUNK = {"batches": {k: np.stack([_b1[k], _b2[k]]) for k in _b1},
         "lrs": [LR, LR / 2]}


def _ranks(out_dir, world=2):
    out = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _jax_batch():
    """``tests/test_parallel.py``'s batch: 16 initial states, a uniform
    policy over the valid moves."""
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    states = np.asarray(jax.jit(jax.vmap(
        lambda k: JE.initial_state(ENV, k)))(keys))
    valids = np.asarray(_jvalid(jnp.asarray(states)))
    pi = valids.astype(np.float32)
    pi /= np.maximum(pi.sum(-1, keepdims=True), 1)
    return {"boards": states, "pi": pi,
            "winner": np.tile([1.0, -1.0], (B, 1)).astype(np.float32),
            "scdiff": np.zeros((B, 2), np.int8), "valids": valids}


def _case(dropout, augment, batch, seed):
    """A train-step case from ``init_train_state``'s weights at key 0."""
    jcfg = JA.net_config_for(ENV, dropout=dropout, width=48)
    params, bs = _jinit(jcfg, jax.random.PRNGKey(0))
    state0 = JTR.TrainState(params, bs, optax.scale_by_adam().init(params),
                            jnp.zeros((), jnp.int32))
    return {"net_cfg": dict(jcfg.__dict__),
            "params": jax.tree_util.tree_map(np.asarray, state0.params),
            "bs": jax.tree_util.tree_map(np.asarray, state0.batch_stats),
            "tcfg": dict(batch_size=B, epochs=1, augment=augment),
            "batch": batch, "lr": LR, "seed": seed}, jcfg, state0


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Both cases, the env step and the helpers on 2 ranks; the JAX
    sharded step of the first case."""
    tmp = tmp_path_factory.mktemp("sharded")
    case_a, jcfg, state0 = _case(0.0, False, _jax_batch(), 3)
    case_b, _, _ = _case(0.3, True, batch_np(2, B, seed=7), 5)
    cfg, s, valids = positions(2, B, seed=11)
    rng = np.random.default_rng(11)
    actions = np.array([rng.choice(np.flatnonzero(r)) for r in valids])
    env = {"states": s.numpy(), "actions": actions,
           "uniforms": rng.random((B, 2), dtype=np.float32)}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"cases": [case_a, case_b], "env": env,
                     "chunk": CHUNK}, f)
    mp = pytest.MonkeyPatch()
    mp.setenv("LOCAL_WORLD_SIZE", "1")       # two hosts of one rank each
    try:
        spawn(W.sharded_steps, 2, (str(tmp / "in.pkl"), str(tmp)))
    finally:
        mp.undo()

    mesh = JD.make_pod_mesh()
    tcfg = JTR.TrainConfig(**case_a["tcfg"])
    step = JMP.make_sharded_train_step(ENV, jcfg, tcfg, mesh)
    jstate, jm = step(
        JMP.replicate(mesh, jax.tree_util.tree_map(
            lambda x: jnp.array(x, copy=True), state0)),
        JD.host_local_to_global(mesh, case_a["batch"]),
        JMP.replicate(mesh, jnp.float32(LR)),
        JMP.replicate(mesh, jnp.float32(10.0)),
        JMP.replicate(mesh, jax.random.PRNGKey(3)))
    return {"ranks": _ranks(tmp), "cases": [case_a, case_b], "env": env,
            "jax": (jax.tree_util.tree_map(np.asarray, jstate.params),
                    {k: float(v) for k, v in jm.items()})}


def _assert_params(got, want):
    g, w = dict(C.tree_items(got)), dict(C.tree_items(want))
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], np.asarray(w[k]), err_msg=str(k),
                                   **STEP_TOL)


def test_sharded_env_step_equals_jax(sharded):
    env = sharded["env"]
    s2, nxt = _jstep(jnp.asarray(env["states"]),
                     jnp.asarray(env["actions"], jnp.int32),
                     jnp.asarray(env["uniforms"]))
    valids = _jvalid(jnp.asarray(env["states"]))
    for r in sharded["ranks"]:
        np.testing.assert_array_equal(r["env"]["states"], np.asarray(s2))
        np.testing.assert_array_equal(r["env"]["next"], np.asarray(nxt))
        np.testing.assert_array_equal(r["env"]["valids"], np.asarray(valids))


def test_sharded_train_step_equals_jax_sharded(sharded):
    jparams, jm = sharded["jax"]
    for r in sharded["ranks"]:
        got = r["steps"][0]
        np.testing.assert_allclose(got["metrics"]["loss"], jm["loss"],
                                   rtol=2e-5)
        _assert_params(got["params"], jparams)
    a, b = (r["steps"][0]["flat"] for r in sharded["ranks"])
    np.testing.assert_array_equal(a, b)


def test_sharded_train_step_dropout_and_augment_equals_one_process(sharded):
    case = sharded["cases"][1]
    net_cfg = N.NetConfig(**case["net_cfg"])
    state = TR.init_train_state(net_cfg, device="cpu")
    state.net.load_state_dict(N.from_flax(case["params"], case["bs"]))
    step = TR.make_train_step(E.SplendorConfig(), net_cfg,
                              TR.TrainConfig(**case["tcfg"]))
    state, metrics = step(state, case["batch"], LR, 10.0,
                          torch.Generator().manual_seed(case["seed"]))
    params, bs = N.to_flax(state.net.state_dict())
    for r in sharded["ranks"]:
        got = r["steps"][1]
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][k], float(v),
                                       rtol=2e-5, err_msg=k)
        _assert_params(got["params"], params)
        _assert_params(got["bs"], bs)
    a, b = (r["steps"][1]["flat"] for r in sharded["ranks"])
    np.testing.assert_array_equal(a, b)


def test_sharded_train_chunk_equals_one_process(sharded):
    """``make_train_chunk`` with the mesh: each rank moves its rows of both
    minibatches; two steps equal the one-process chunk's (dropout 0.3,
    augmentation on), metrics averaged over the steps."""
    case = sharded["cases"][1]
    net_cfg = N.NetConfig(**case["net_cfg"])
    state = TR.init_train_state(net_cfg, device="cpu")
    state.net.load_state_dict(N.from_flax(case["params"], case["bs"]))
    run = TR.make_train_chunk(E.SplendorConfig(), net_cfg,
                              TR.TrainConfig(**case["tcfg"]))
    state, metrics = run(state, CHUNK["batches"], CHUNK["lrs"], 10.0,
                         torch.Generator().manual_seed(case["seed"]))
    params, _ = N.to_flax(state.net.state_dict())
    for r in sharded["ranks"]:
        got = r["chunk"]
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   float(metrics["loss"]), rtol=2e-5)
        _assert_params(got["params"], params)
    a, b = (r["chunk"]["flat"] for r in sharded["ranks"])
    np.testing.assert_array_equal(a, b)


def test_2d_mesh_train_step(sharded):
    for r in sharded["ranks"]:
        assert r["mesh2d_shape"] == (2, 1)
        np.testing.assert_array_equal(r["step2d"]["flat"], r["steps"][0]["flat"])
        assert r["step2d"]["metrics"] == r["steps"][0]["metrics"]


def test_host_local_global_roundtrip(sharded):
    r0, r1 = sharded["ranks"]
    for r in (r0, r1):
        rt = r["roundtrip"]
        for k in ("x", "y"):
            np.testing.assert_array_equal(
                rt["global"][k], np.concatenate([r0["roundtrip"]["local"][k],
                                                 r1["roundtrip"]["local"][k]]))
            np.testing.assert_array_equal(rt["back"][k], rt["local"][k])
        np.testing.assert_array_equal(r["from_host0"]["a"], np.zeros(3))
        np.testing.assert_array_equal(r["replicated"], np.zeros((2, 3)))
    assert (r0["primary"], r1["primary"]) == (True, False)


def test_single_process_helpers_are_identities():
    assert not D.initialized() and D.world_size() == 1 and D.is_primary()
    assert not D.initialize(device="cpu")      # no torchrun variables here
    with pytest.raises(ValueError, match="world size"):
        D.initialize(num_processes=2, device="cpu")
    D.sync_hosts()
    tree = {"a": np.ones(3)}
    assert D.replicate_from_host0(tree) is tree
    assert D.gather_objects(5) == [5]
    local = D.global_to_host_local({"x": np.arange(6)})
    np.testing.assert_array_equal(local["x"], np.arange(6))


SP_KW = dict(num_sims=8, ratio_full=4, prob_full=0.5, max_moves=6,
             chunk_moves=4, forced_playouts=True, tree_reuse=True)


def test_sharded_selfplay_equals_its_shards(tmp_path):
    spawn(W.sharded_selfplay, 2, (str(tmp_path), 4, 3, SP_KW))
    cfg = E.SplendorConfig()
    its, stats = [], []
    for r in range(2):
        eng = SP.SelfPlayEngine(cfg, A.make_uniform_eval_fn(cfg),
                                SP.SelfPlayConfig(batch_size=2, **SP_KW),
                                device="cpu")
        it, st = eng.run_games(None, D.rank_generator(3, r, "cpu"))
        its.append(it)
        stats.append(st)
    for got in _ranks(tmp_path):
        it, st = got["it"], got["stats"]
        assert st["games"] == 4
        for k in ("rollouts", "examples"):
            assert st[k] == sum(s[k] for s in stats), k
        assert st["examples"] == len(it) == sum(len(i) for i in its)
        for name in ("boards", "pi", "winner", "scdiff", "valids",
                     "surprise"):
            np.testing.assert_array_equal(
                getattr(it, name),
                np.concatenate([getattr(i, name) for i in its]),
                err_msg=name)
