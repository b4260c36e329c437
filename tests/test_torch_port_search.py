"""Port parity: the PyTorch batched MCTS against the JAX search.

Both searches get the same roots and, with noise on, the same Gamma draws
(the port takes JAX's ``jax.random.gamma`` draws as ``noise_gamma``).  With
the uniform evaluator every float32 operation on the search path happens
in the same order, so visit counts are equal and ``q`` agrees to 1e-6; the
JAX side runs both staged ("auto") and unstaged ("off").  With the r6 net
the two forwards differ in the last bits (matmul order), so ``q``,
``root_value`` and ``root_prior`` agree within 1e-5 and the counts are
equal on these seeds.  The plain descent is held exactly to ``_select`` on
fresh and carried JAX trees; the descent kernel is held to the plain
version on the card by ``chip_smoke.py``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.models import splendor_net as JN
from alphazero_tpu.search import mcts as JM
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.ops import descent as D
from alphazero_tpu_torch.search import mcts as M
from alphazero_tpu_torch.utils import checkpoint as C
from tests.test_torch_port_train import _one_thread  # noqa: F401

R6 = os.path.join(os.path.dirname(__file__), "..", "runs", "r6")


def _roots(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return E.init_with_uniforms(
        cfg, torch.from_numpy(rng.random((B, 24), dtype=np.float32)),
        torch.from_numpy(np.stack([rng.permutation(10)[:cfg.num_nobles]
                                   for _ in range(B)])))


def _run_both(kw, jax_stage, jparams, jeval, params, teval, B=8, seed=0):
    cfg, jcfg = E.SplendorConfig(), JE.SplendorConfig()
    roots = _roots(cfg, B, seed)
    jm = JM.MCTSConfig(stage_sims=jax_stage, **kw)
    search = jax.jit(JM.build_search(jm, 2, jeval, JA.make_search_step_fn(jcfg),
                                     JA.make_valid_fn(jcfg)))
    key = jax.random.PRNGKey(seed + 11)
    jr = search(jparams, jnp.asarray(roots.numpy()), key)
    gamma = np.array(jax.random.gamma(key, jm.dirichlet_alpha, (B, 409)))
    tsearch = M.build_search(M.MCTSConfig(**kw), 2, teval,
                             A.make_search_step_fn(cfg), A.make_valid_fn(cfg),
                             device="cpu")
    tr = tsearch(params, roots, noise_gamma=torch.from_numpy(gamma))
    valid = A.make_valid_fn(cfg)(roots).numpy()
    raw = tr.raw_counts.numpy()
    np.testing.assert_array_equal(raw.sum(1), kw["num_sims"])
    assert (raw[~valid] == 0).all()
    return jr, tr


UNIFORM_CASES = [
    (dict(num_sims=12), "off"),
    (dict(num_sims=12, add_noise=True, prior_temp=1.25, forced_playouts=True),
     "auto"),
    (dict(num_sims=64, add_noise=True, forced_playouts=True, fpu=0.3), "auto"),
    (dict(num_sims=64, max_depth=5), "off"),
    (dict(num_sims=64, max_depth=5, fpu=0.2), "auto"),
]


@pytest.mark.parametrize("kw,jax_stage", UNIFORM_CASES)
def test_uniform_evaluator_parity(kw, jax_stage):
    cfg, jcfg = E.SplendorConfig(), JE.SplendorConfig()
    jr, tr = _run_both(kw, jax_stage, None, JA.make_uniform_eval_fn(jcfg),
                       None, A.make_uniform_eval_fn(cfg),
                       seed=kw["num_sims"] + kw.get("max_depth", 0))
    np.testing.assert_array_equal(np.asarray(jr.raw_counts),
                                  tr.raw_counts.numpy())
    np.testing.assert_array_equal(np.asarray(jr.counts), tr.counts.numpy())
    np.testing.assert_allclose(np.asarray(jr.q), tr.q.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jr.root_prior),
                               tr.root_prior.numpy(), atol=1e-6)


def test_r6_net_parity():
    ckpt = C.load_checkpoint(R6, "best.pt")
    cfg, jcfg = E.SplendorConfig(), JE.SplendorConfig()
    jnet_cfg = JA.net_config_for(jcfg)
    net = N.build_net(A.net_config_for(cfg), device="cpu")
    net.load_state_dict(N.from_flax(ckpt["params"], ckpt["batch_stats"]))
    kw = dict(num_sims=32, add_noise=True, prior_temp=1.25,
              forced_playouts=True)
    jr, tr = _run_both(kw, "auto", (ckpt["params"], ckpt["batch_stats"]),
                       JA.make_eval_fn(jnet_cfg), net,
                       A.make_eval_fn(A.net_config_for(cfg)), seed=5)
    np.testing.assert_array_equal(np.asarray(jr.raw_counts),
                                  tr.raw_counts.numpy())
    for name in ("q", "root_value", "root_prior"):
        np.testing.assert_allclose(np.asarray(getattr(jr, name)),
                                   getattr(tr, name).numpy(), atol=1e-5,
                                   err_msg=name)
    assert np.abs(tr.q.numpy()).max() > 1e-3       # the net's values count


DESCENT_CASES = [
    pytest.param(dict(max_depth=0), id="0"),
    pytest.param(dict(max_depth=3), id="3"),
    pytest.param(dict(fpu=-0.2), id="fpu_le_0"),
    pytest.param(dict(forced_playouts=False), id="no_forced"),
    # uniform priors without noise: unvisited edges tie exactly
    pytest.param(dict(add_noise=False, forced_playouts=False),
                 id="uniform_ties"),
    pytest.param(dict(tree="carried", B=4, S=16), id="carried"),
    pytest.param(dict(B=1, S=40), id="b1_no_cap"),
]


def _jax_trees(mcfg, B, S, carried):
    """The trees of a JAX search of ``B`` seed-made roots (uniform
    evaluator), with each tree's node counts: one fresh search, or for
    ``carried`` a reusing search run, re-rooted on the most-visited action
    and its in-tree next state, and run again (both carried trees)."""
    jcfg = JE.SplendorConfig()
    fns = (JA.make_uniform_eval_fn(jcfg), JA.make_search_step_fn(jcfg),
           JA.make_valid_fn(jcfg))
    roots = jnp.asarray(_roots(E.SplendorConfig(), B, 9).numpy())
    if not carried:
        init_tree, core, Mx = JM._build_core(mcfg, 2, *fns, keep_cap=0)
        _, tree, n = jax.jit(core)(None, *init_tree(roots),
                                   jax.random.PRNGKey(1))
        return [(tree, n)], Mx
    rs = JM.build_reusing_search(mcfg, 2, *fns)
    run = jax.jit(rs.run)
    res, tree, n = run(None, *jax.jit(rs.init_tree)(roots),
                       jax.random.PRNGKey(1))
    actions = jnp.argmax(res.raw_counts, -1).astype(jnp.int32)
    nxt = jax.vmap(fns[1])(tree.states[:, 0], actions)[0]
    tree, n = jax.jit(rs.reroot)(tree, actions, nxt)
    assert int(n.max()) > 1
    out = [(tree, n)]
    _, tree, n = run(None, tree, n, jax.random.PRNGKey(2))
    return out + [(tree, n)], rs.capacity


@pytest.mark.parametrize("case", DESCENT_CASES)
def test_descent_equals_jax_select(case):
    """The plain descent on trees that JAX searches built, fresh or carried
    across a reroot, with its loop bound ``min(n, depth_cap)`` for the
    largest node count ``n``."""
    case = dict(case)
    B, S = case.pop("B", 8), case.pop("S", 24)
    carried = case.pop("tree", None) == "carried"
    kw = dict(num_sims=S, stage_sims="off", add_noise=True,
              forced_playouts=True, fpu=0.25)
    kw.update(case)
    mcfg = JM.MCTSConfig(**kw)
    trees, Mx = _jax_trees(mcfg, B, S, carried)
    max_depth = mcfg.max_depth
    PL = min(Mx - 1, max_depth) if max_depth else Mx - 1
    tcfg = M.MCTSConfig(**{f.name: getattr(mcfg, f.name)
                           for f in dataclasses.fields(JM.MCTSConfig)})

    @jax.jit
    def jselect(tree, sim_idx):
        z = jnp.zeros((B, PL), jnp.int32)
        return JM._select(mcfg, tree, sim_idx, z + Mx, z, z, PL)

    deepest = 0
    for tree, n in trees:
        stats = torch.from_numpy(np.array(tree.stats))
        levels = min(int(np.asarray(n).max()), PL)
        for sim_idx in (S - 1, S + 7):
            jout = jselect(tree, jnp.int32(sim_idx))
            tout = M._select(tcfg, stats, sim_idx, PL, levels)
            for name, j, t in zip(("parent", "action", "existing", "depth",
                                   "parent_rot", "path_p", "path_a",
                                   "path_r"), jout, tout):
                np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                              err_msg=name)
            deepest = max(deepest, int(np.asarray(jout[3]).max()))
    assert deepest >= 2


def test_descent_wrapper_on_cpu_is_the_plain_version():
    """``ops.descent.select`` on CPU tensors returns ``select_plain``'s
    outputs (values and dtypes) and launches no kernel."""
    trees, Mx = _jax_trees(JM.MCTSConfig(num_sims=16, add_noise=True,
                                         forced_playouts=True), 4, 16, False)
    stats = torch.from_numpy(np.array(trees[0][0].stats))
    cfg = M.MCTSConfig(num_sims=16, add_noise=True, forced_playouts=True)
    before = D.select.launches
    got = D.select(cfg, stats, 20, Mx - 1, Mx - 1)
    want = D.select_plain(cfg, stats, 20, Mx - 1, Mx - 1)
    assert D.select.launches == before
    assert [t.dtype for t in got] == [torch.int64] * 3 + [torch.int32,
                                                         torch.int64] \
        + [torch.int32] * 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="float32"):
        D.select(cfg, stats.double(), 20, Mx - 1, Mx - 1)


def test_stage_schedules_are_validated():
    assert M._resolve_stage_schedule(M.MCTSConfig(num_sims=64)) == (16, 16, 32)
    with pytest.raises(ValueError):
        M.build_search(M.MCTSConfig(num_sims=64, stage_sims="16,16"), 2,
                       None, None, None, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        M.build_search(M.MCTSConfig(num_sims=400, stats_dtype="bfloat16"), 2,
                       None, None, None, device="cpu")
