"""Port parity: cross-move tree reuse against the JAX package's.

- The reusing search and ``reroot`` are held to JAX's over several moves:
  after each ``run`` the counts are equal and ``q`` within 1e-6 (uniform
  evaluator; 1e-5 with the r6 net), after each ``reroot`` the tree's
  ``states``, ``stats``, ``parent`` and ``n_kept`` are exactly equal, with
  root noise (JAX's Gamma draws fed in), forced playouts, ``fpu > 0``, a
  depth cap, a kept subtree truncated at ``keep_cap + 1`` and a board whose
  real next state left the tree.
- JAX's reroot invariants (``tests/test_tree_reuse.py``) and the
  whole-tree edge-visit invariant (``tests/test_mcts.py``) hold on the
  port's trees.

Self-play with reuse and ``ReusingAgent`` are in
``test_torch_port_reuse_play.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.search import mcts as JM
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.search import mcts as M
from alphazero_tpu_torch.utils import checkpoint as C
from tests.test_torch_port_search import R6, _roots
from tests.test_torch_port_train import _one_thread  # noqa: F401


def _port_rs(kw, keep_cap=0, eval_fn=None, cfg=None):
    cfg = cfg or E.SplendorConfig()
    return M.build_reusing_search(
        M.MCTSConfig(**kw), cfg.num_players,
        eval_fn or A.make_uniform_eval_fn(cfg), A.make_search_step_fn(cfg),
        A.make_valid_fn(cfg), keep_cap=keep_cap, device="cpu")


def _assert_tree_equal(jtree, jn, tree, n, atol=0.0, after_run=False):
    """States, parents and node counts equal; stats within ``atol`` (0:
    equal).  ``after_run``: the root's prior lane, just written from fresh
    priors whose normalizing sum runs in another order, within 1e-6 (a
    stored child's prior is ``-1 + (p + 1)``, which drops those bits)."""
    for name in ("states", "parent"):
        np.testing.assert_array_equal(np.asarray(getattr(jtree, name)),
                                      getattr(tree, name).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(jn), n.numpy())
    want, got = np.array(jtree.stats), tree.stats.numpy().copy()
    if after_run:
        np.testing.assert_allclose(want[:, 0, 0], got[:, 0, 0], rtol=0,
                                   atol=max(atol, 1e-6))
        want[:, 0, 0] = got[:, 0, 0]
    np.testing.assert_allclose(want, got, rtol=0, atol=atol, err_msg="stats")


def _carried_moves(kw, keep_cap, jeval, jparams, teval, params, B, seed,
                   moves, atol, tree_atol=0.0):
    """Init, then ``moves`` times run + reroot on the argmax action and its
    in-tree next state, on both packages; board 0's next state is replaced
    by another board's at the second move.  Results are held to ``atol``,
    trees to ``tree_atol`` (0 with the uniform evaluator, whose values are
    exact).  Returns the port's n_kept per move."""
    jcfg, cfg = JE.SplendorConfig(), E.SplendorConfig()
    jrs = JM.build_reusing_search(JM.MCTSConfig(**kw), 2, jeval,
                                  JA.make_search_step_fn(jcfg),
                                  JA.make_valid_fn(jcfg), keep_cap=keep_cap)
    jrun, jreroot = jax.jit(jrs.run), jax.jit(jrs.reroot)
    rs = _port_rs(kw, keep_cap, teval)
    assert rs.capacity == jrs.capacity
    step_fn = A.make_search_step_fn(cfg)
    roots = _roots(cfg, B, seed)
    jtree, jn = jax.jit(jrs.init_tree)(jnp.asarray(roots.numpy()))
    tree, n = rs.init_tree(roots)
    _assert_tree_equal(jtree, jn, tree, n)
    kept = []
    for move in range(moves):
        key = jax.random.PRNGKey(seed * 10 + move)
        gamma = np.array(jax.random.gamma(key, kw.get("dirichlet_alpha", 0.2),
                                          (B, 409)))
        jres, jtree, jn = jrun(jparams, jtree, jn, key)
        res, tree, n = rs.run(params, tree, n,
                              noise_gamma=torch.from_numpy(gamma))
        np.testing.assert_array_equal(np.asarray(jres.raw_counts),
                                      res.raw_counts.numpy())
        np.testing.assert_array_equal(np.asarray(jres.counts),
                                      res.counts.numpy())
        for name in ("q", "root_value", "root_prior"):
            np.testing.assert_allclose(np.asarray(getattr(jres, name)),
                                       getattr(res, name).numpy(), atol=atol,
                                       err_msg=name)
        _assert_tree_equal(jtree, jn, tree, n, tree_atol, after_run=True)
        actions = torch.argmax(res.raw_counts, -1)
        nxt = step_fn(tree.states[:, 0], actions)[0]
        if move == 1:
            nxt[0] = nxt[1]
        jtree, jn = jreroot(jtree, jnp.asarray(actions.numpy(), jnp.int32),
                            jnp.asarray(nxt.numpy()))
        tree, n = rs.reroot(tree, actions, nxt)
        _assert_tree_equal(jtree, jn, tree, n, tree_atol)
        kept.append(n.numpy())
    return np.stack(kept)


CARRIED_CASES = [
    (dict(num_sims=40), 0),
    (dict(num_sims=40, add_noise=True, prior_temp=1.25,
          forced_playouts=True), 0),
    (dict(num_sims=16, add_noise=True, fpu=0.3, max_depth=5), 0),
    (dict(num_sims=40, fpu=0.1), 5),     # KMAX = 6 cuts 11-node subtrees
]


@pytest.mark.parametrize("kw,keep_cap", CARRIED_CASES)
def test_carried_search_equals_jax(kw, keep_cap):
    cfg, jcfg = E.SplendorConfig(), JE.SplendorConfig()
    kept = _carried_moves(kw, keep_cap, JA.make_uniform_eval_fn(jcfg), None,
                          A.make_uniform_eval_fn(cfg), None, B=3,
                          seed=kw["num_sims"] + keep_cap, moves=3, atol=1e-6)
    assert (kept[1, 0] == 1) and (kept > 1).any()
    if keep_cap:
        assert (kept <= keep_cap + 1).all() and (kept == keep_cap + 1).any()


def test_r6_net_carried_search():
    ckpt = C.load_checkpoint(R6, "best.pt")
    cfg, jcfg = E.SplendorConfig(), JE.SplendorConfig()
    net = N.build_net(A.net_config_for(cfg), device="cpu")
    net.load_state_dict(N.from_flax(ckpt["params"], ckpt["batch_stats"]))
    kept = _carried_moves(
        dict(num_sims=32, add_noise=True, prior_temp=1.25), 0,
        JA.make_eval_fn(JA.net_config_for(jcfg)),
        (ckpt["params"], ckpt["batch_stats"]),
        A.make_eval_fn(A.net_config_for(cfg)), net, B=3, seed=6, moves=2,
        atol=1e-5, tree_atol=1e-5)
    assert (kept[0] > 1).all()


def test_reroot_truncated_equals_jax():
    """Reroot at ``KMAX = 4`` of the branching trees an r6 search grows,
    whose kept subtrees are larger: the port's equals JAX's on the same
    tree."""
    ckpt = C.load_checkpoint(R6, "best.pt")
    cfg = E.SplendorConfig()
    net = N.build_net(A.net_config_for(cfg), device="cpu")
    net.load_state_dict(N.from_flax(ckpt["params"], ckpt["batch_stats"]))
    rs = _port_rs(dict(num_sims=32, add_noise=True),
                  eval_fn=A.make_eval_fn(A.net_config_for(cfg)))
    roots = _roots(cfg, 4, 8)
    res, tree, _ = rs.run(net, *rs.init_tree(roots),
                          generator=torch.Generator().manual_seed(2))
    actions = torch.argmax(res.raw_counts, -1)
    nxt = A.make_search_step_fn(cfg)(roots, actions)[0]
    full = rs.reroot(tree, actions, nxt)[1]
    # reroot reads only the capacity (65) and KMAX = keep_cap + 1
    small = _port_rs(dict(num_sims=61), keep_cap=3).reroot(tree, actions, nxt)
    jsmall = JM.build_reusing_search(JM.MCTSConfig(num_sims=61), 2, None,
                                     None, None, keep_cap=3).reroot(
        JM.Tree(*(jnp.asarray(t.numpy()) for t in tree)),
        jnp.asarray(actions.numpy(), jnp.int32), jnp.asarray(nxt.numpy()))
    _assert_tree_equal(*jsmall, *small)
    assert (full > 4).any()
    assert (small[1] == torch.clamp(full, max=4)).all()


@pytest.fixture(scope="module")
def carried():
    """A port search at 40 sims on 3 boards, its tree and in-tree next
    states of the most visited actions."""
    cfg = E.SplendorConfig()
    rs = _port_rs(dict(num_sims=40))
    roots = _roots(cfg, 3, 0)
    res, tree, n1 = rs.run(None, *rs.init_tree(roots))
    actions = torch.argmax(res.raw_counts, -1)
    nxt = A.make_search_step_fn(cfg)(roots, actions)[0]
    return rs, roots, tree.stats.clone(), tree, n1, actions, nxt


def test_reroot_carries_subtree(carried):
    rs, _, old, tree, n1, actions, nxt = carried
    assert (n1 == 41).all()
    A_ = old.shape[-1] - 2
    c_star = old[:, 0, 1, :A_].gather(1, actions[:, None])[:, 0].abs().long()
    assert (c_star > 0).all()
    tree2, n2 = rs.reroot(tree, actions, nxt)
    n2 = n2.numpy()
    assert (n2 > 1).all()
    assert torch.equal(tree2.states[:, 0], nxt)
    stats2, par2 = tree2.stats.numpy(), tree2.parent.numpy()
    old = old.numpy()
    for b in range(3):
        c = int(c_star[b])
        # the new root keeps the child's node scalars and edge visits
        np.testing.assert_array_equal(stats2[b, 0, 2:, A_], old[b, c, 2:, A_])
        np.testing.assert_array_equal(stats2[b, 0, 2, :A_], old[b, c, 2, :A_])
        k = n2[b]
        assert par2[b, 0] == 0
        assert all(0 <= par2[b, j] < j for j in range(1, k))
        child2 = np.abs(stats2[b, :k, 1, :A_]).astype(int)
        assert (child2[child2 > 0] < k).all()
        for m, a_ in zip(*np.nonzero(child2)):
            assert par2[b, child2[m, a_]] == m
        assert (stats2[b, k:, 0, :A_] == -1.0).all()
        assert (stats2[b, k:, :, A_:] == 0).all()


def test_search_from_carried_tree_accumulates(carried):
    rs, _, _, tree, _, actions, nxt = carried
    tree2, n2 = rs.reroot(tree, actions, nxt)
    A_ = tree2.stats.shape[-1] - 2
    root_n = tree2.stats[:, 0, 2, A_].clone()
    res, _, n3 = rs.run(None, tree2, n2)
    # counts include the carried visits
    np.testing.assert_array_equal(res.raw_counts.sum(1).numpy(),
                                  root_n.numpy() + 40)
    assert torch.equal(n3, n2 + 40)
    np.testing.assert_allclose(res.q[:, 0], -res.q[:, 1], atol=1e-6)


def test_reroot_invalidates_on_state_mismatch(carried):
    rs, _, _, tree, _, actions, _ = carried
    other = _roots(E.SplendorConfig(), 3, 10)
    tree2, n2 = rs.reroot(tree, actions, other)
    assert (n2 == 1).all()
    assert torch.equal(tree2.states[:, 0], other)
    A_ = tree2.stats.shape[-1] - 2
    assert (tree2.stats[:, 0, :, A_:] == 0).all()
    res, _, _ = rs.run(None, tree2, n2)
    assert (res.raw_counts.sum(1) == 40).all()


def _edge_visits_on_valid_actions(tree):
    """Every expanded node's edge visits lie on valid actions of its own
    stored state."""
    B, Mc = tree.stats.shape[:2]
    valid = A.make_valid_fn(E.SplendorConfig())(
        tree.states.reshape(B * Mc, *tree.states.shape[2:])).reshape(B, Mc, -1)
    A_ = valid.shape[-1]
    expanded = (tree.stats[:, :, 0, :A_] >= 0).any(-1)
    bad = (tree.stats[:, :, 2, :A_] > 0) & ~valid & expanded[..., None]
    assert not bool(bad.any()), torch.nonzero(bad)[:8]


def test_edge_visits_only_on_valid_actions_all_nodes():
    rs = _port_rs(dict(num_sims=48, forced_playouts=True, add_noise=True,
                       prior_temp=1.25, max_depth=32), keep_cap=48)
    g = torch.Generator().manual_seed(3)
    roots = _roots(E.SplendorConfig(), 4, 11)
    res, tree, n = rs.run(None, *rs.init_tree(roots), generator=g)
    _edge_visits_on_valid_actions(tree)
    actions = torch.argmax(res.raw_counts, -1)
    nxt = A.make_search_step_fn(E.SplendorConfig())(roots, actions)[0]
    tree, n = rs.reroot(tree, actions, nxt)
    assert (n > 1).any()
    _, tree, _ = rs.run(None, tree, n, generator=g)
    _edge_visits_on_valid_actions(tree)


def test_bfloat16_stats_rejected():
    cfg = E.SplendorConfig()
    with pytest.raises(ValueError, match="bfloat16"):
        _port_rs(dict(num_sims=16, stats_dtype="bfloat16"), keep_cap=16)
    with pytest.raises(ValueError, match="bfloat16"):
        M.build_search(M.MCTSConfig(num_sims=400, stats_dtype="bfloat16"), 2,
                       A.make_uniform_eval_fn(cfg), None, None, device="cpu")
