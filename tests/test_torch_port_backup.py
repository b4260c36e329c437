"""Port parity: the fused-backup kernel's plain version on the CPU.

Split contract (the Pallas kernel's): exact against a sequential numpy
reference, and within the Pallas kernel's own bf16 tolerance (``atol=1e-2``,
as ``tests/test_ops.py`` holds it) against ``fused_backup(...,
interpret=True)``.  Packed contract (the search's): exact against the JAX
search's ``_backprop_fused`` on trees and paths taken from a JAX search.
The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.ops.fused_backup import fused_backup as pallas_backup
from alphazero_tpu.search import mcts as JM
from alphazero_tpu_torch.ops import fused_backup as FB
from alphazero_tpu_torch.search import mcts as M


def _sequential(stats, path_p, path_a, w, child_p, child_a, child_v, pv,
                slot):
    """One board and one level at a time, in level order."""
    B, Mx, _, A = stats.shape
    ref = stats.copy()
    slots = np.broadcast_to(np.asarray(slot), (B,))
    for b in range(B):
        for s in range(path_p.shape[1]):
            if path_p[b, s] < Mx:
                ref[b, path_p[b, s], 2, path_a[b, s]] += w[b, s, 0]
                ref[b, path_p[b, s], 3, path_a[b, s]] += w[b, s, 1]
        if child_v[b] != 0:
            ref[b, child_p[b], 1, child_a[b]] += child_v[b]
        ref[b, slots[b], 0, :] += pv[b]
    return ref


def _split_inputs(seed, B=16, Mx=9, A=57, S1=7):
    rng = np.random.default_rng(seed)
    stats = rng.normal(size=(B, Mx, 4, A)).astype(np.float32)
    path_p = rng.integers(0, Mx + 1, size=(B, S1)).astype(np.int32)
    path_a = rng.integers(0, A, size=(B, S1)).astype(np.int32)
    # repeated (p, a) pairs within a board's path
    path_p[:, 3], path_a[:, 3] = path_p[:, 1], path_a[:, 1]
    path_p[:, 5] = Mx                                   # drop sentinels
    w = rng.normal(size=(B, S1, 2)).astype(np.float32)
    child_p = rng.integers(0, Mx, size=(B,)).astype(np.int32)
    child_a = rng.integers(0, A, size=(B,)).astype(np.int32)
    child_v = (rng.integers(0, 2, size=(B,))
               * rng.integers(1, Mx, size=(B,))).astype(np.float32)
    assert (child_v == 0).any() and (child_v != 0).any()
    pv = rng.normal(size=(B, A)).astype(np.float32)
    return stats, path_p, path_a, w, child_p, child_a, child_v, pv


@pytest.mark.parametrize("slot", ["scalar", "per_board"])
def test_split_contract(slot):
    args = _split_inputs(0 if slot == "scalar" else 1)
    B, Mx = args[0].shape[:2]
    slot_np = (3 if slot == "scalar" else
               np.random.default_rng(2).integers(0, Mx, B).astype(np.int32))
    ref = _sequential(*args, slot_np)
    t_args = [torch.from_numpy(a.copy()) for a in args]
    t_slot = slot_np if isinstance(slot_np, int) else torch.from_numpy(slot_np)
    out = FB.fused_backup(*t_args, t_slot).numpy()
    np.testing.assert_array_equal(out, ref)
    # the row may also come as [B, 1, C]
    t_args = [torch.from_numpy(a.copy()) for a in args]
    t_args[-1] = t_args[-1][:, None, :]
    np.testing.assert_array_equal(FB.fused_backup(*t_args, t_slot).numpy(),
                                  ref)
    # the Pallas kernel computes the path part as a bf16 one-hot matmul
    pal = np.asarray(pallas_backup(*(jnp.asarray(a) for a in args),
                                   jnp.asarray(slot_np), tile_b=8,
                                   interpret=True))
    np.testing.assert_allclose(out, pal, atol=1e-2)


def test_wrapper_checks_operands():
    args = [torch.from_numpy(a) for a in _split_inputs(3)]
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="path_p"):
        FB.fused_backup(*bad, 0)
    with pytest.raises(ValueError, match="node_col"):
        FB.fused_backup(*args, 0, node_col=args[0].shape[3])
    bad = list(args)
    bad[-1] = torch.zeros(args[0].shape[0], 2, args[0].shape[3])
    with pytest.raises(ValueError, match="row"):
        FB.fused_backup(*bad, 0)
    launches = FB.fused_backup.launches
    FB.fused_backup(*args, 0)
    assert FB.fused_backup.launches == launches   # CPU: plain version only


@pytest.mark.parametrize("num_players", [2, 3])
def test_packed_contract_matches_jax(num_players):
    """Trees and paths from a JAX search; the port's backup operands and
    kernel against the JAX ``_backprop_fused``, bit for bit."""
    jcfg = JE.SplendorConfig(num_players=num_players)
    B, S = 6, 10
    mcfg = JM.MCTSConfig(num_sims=S, stage_sims="off", fpu=0.2)
    eval_fn = JA.make_uniform_eval_fn(jcfg)
    step_fn = JA.make_search_step_fn(jcfg)
    valid_fn = JA.make_valid_fn(jcfg)
    init_tree, core, Mx = JM._build_core(mcfg, num_players, eval_fn, step_fn,
                                         valid_fn, keep_cap=0)
    keys = jax.random.split(jax.random.PRNGKey(num_players), B)
    roots = jax.jit(jax.vmap(lambda k: JE.initial_state(jcfg, k)))(keys)
    _, tree, _ = jax.jit(core)(None, *init_tree(roots), jax.random.PRNGKey(0))
    # the tree is full (S sims); back up one more sim into a grown copy
    tree = JM._grow_tree(tree, Mx + 1)
    PL = Mx - 1
    slot = S + 1
    rng = np.random.default_rng(num_players)
    # random values, priors and terminal flags so every lane is exercised
    term_np = np.where(rng.random((B, 1)) < 0.5,
                       rng.choice([-1.0, 1.0], (B, num_players)),
                       0.0).astype(np.float32)
    values_np = rng.uniform(-1, 1, (B, num_players)).astype(np.float32)
    probs_np = rng.random((B, 409), np.float32)
    rot_np = rng.integers(0, num_players, B).astype(np.int32)

    @jax.jit
    def jax_side(tree, term_vec, values, probs, ex_rot):
        z = jnp.zeros((B, PL), jnp.int32)
        (parent, action, existing, depth, prot, path_p, path_a,
         path_r) = JM._select(mcfg, tree, jnp.int32(S), z + Mx + 1, z, z, PL)
        _, _, child_valid, adv = jax.vmap(step_fn)(
            JM._row(tree.states, parent), action)
        fresh = existing == 0
        child_term = jnp.abs(term_vec).sum(-1) > 0
        child_rot = jnp.mod(prot + adv, num_players)
        leaf_rot = jnp.where(fresh, child_rot, ex_rot)
        pvalid = JM._pack_pvalid(JM._normalize_masked(probs, child_valid),
                                 child_valid)
        stats = JM._backprop_fused(
            tree, path_p, path_a, path_r, depth, values, leaf_rot, parent,
            action, fresh, jnp.full((B,), slot, jnp.int32), pvalid,
            child_term, child_rot, values[:, 0], term_vec).stats
        return (stats, path_p, path_a, path_r, depth, leaf_rot, parent,
                action, fresh, pvalid, child_term, child_rot)

    (jstats, path_p, path_a, path_r, depth, leaf_rot, parent, action, fresh,
     pvalid, child_term, child_rot) = jax_side(tree, term_np, values_np,
                                                probs_np, rot_np)
    values, term_vec = values_np, term_np

    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    tstats = t(tree.stats)
    M._backprop_packed(tstats, t(path_p), t(path_a), t(path_r), t(depth),
                       t(values), t(leaf_rot).long(), t(parent).long(),
                       t(action).long(), t(fresh), slot, t(pvalid),
                       t(child_term), t(child_rot).long(), t(values[:, 0]),
                       t(term_vec))
    assert int(np.asarray(depth).max()) >= 2
    np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))
