"""Port parity: the PyTorch batched MCTS against the JAX search.

Both searches get the same roots and, with noise on, the same Gamma draws
(the port takes JAX's ``jax.random.gamma`` draws as ``noise_gamma``).  With
the uniform evaluator every float32 operation on the search path happens
in the same order, so visit counts are equal and ``q`` agrees to 1e-6; the
JAX side runs both staged ("auto") and unstaged ("off").  With the r6 net
the two forwards differ in the last bits (matmul order), so ``q``,
``root_value`` and ``root_prior`` agree within 1e-5 and the counts are
equal on these seeds.  The plain descent is held exactly to ``_select``."""

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
from alphazero_tpu_torch.search import mcts as M
from alphazero_tpu_torch.utils import checkpoint as C

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


@pytest.mark.parametrize("max_depth", [0, 3])
def test_descent_equals_jax_select(max_depth):
    """The plain descent on trees that JAX searches built."""
    jcfg = JE.SplendorConfig()
    B, S = 8, 24
    mcfg = JM.MCTSConfig(num_sims=S, stage_sims="off", add_noise=True,
                         forced_playouts=True, fpu=0.25, max_depth=max_depth)
    init_tree, core, Mx = JM._build_core(
        mcfg, 2, JA.make_uniform_eval_fn(jcfg), JA.make_search_step_fn(jcfg),
        JA.make_valid_fn(jcfg), keep_cap=0)
    roots = jnp.asarray(_roots(E.SplendorConfig(), B, 9).numpy())
    _, tree, _ = jax.jit(core)(None, *init_tree(roots), jax.random.PRNGKey(1))
    PL = min(Mx - 1, max_depth) if max_depth else Mx - 1
    tcfg = M.MCTSConfig(**{f.name: getattr(mcfg, f.name)
                           for f in dataclasses.fields(JM.MCTSConfig)})

    @jax.jit
    def jselect(tree, sim_idx):
        z = jnp.zeros((B, PL), jnp.int32)
        return JM._select(mcfg, tree, sim_idx, z + Mx, z, z, PL)

    stats = torch.from_numpy(np.array(tree.stats))
    for sim_idx in (S - 1, S + 7):
        jout = jselect(tree, jnp.int32(sim_idx))
        tout = M._select(tcfg, stats, sim_idx, PL, min(S + 1, PL))
        for name, j, t in zip(("parent", "action", "existing", "depth",
                               "parent_rot", "path_p", "path_a", "path_r"),
                              jout, tout):
            np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                          err_msg=name)
    assert int(np.asarray(jout[3]).max()) >= 2


def test_stage_schedules_are_validated():
    assert M._resolve_stage_schedule(M.MCTSConfig(num_sims=64)) == (16, 16, 32)
    with pytest.raises(ValueError):
        M.build_search(M.MCTSConfig(num_sims=64, stage_sims="16,16"), 2,
                       None, None, None, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        M.build_search(M.MCTSConfig(stats_dtype="bfloat16"), 2, None, None,
                       None, device="cpu")
