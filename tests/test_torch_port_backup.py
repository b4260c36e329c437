"""Port parity: the fused-backup kernels' plain versions on the CPU.

Split contract (the Pallas kernel's): exact against a sequential numpy
reference, and within the Pallas kernel's own bf16 tolerance (``atol=1e-2``,
as ``tests/test_ops.py`` holds it) against ``fused_backup(...,
interpret=True)``.  Packed contract (the search's), through
``backprop_packed``: exact against the JAX search's ``_backprop_fused`` on
trees and paths taken from a JAX search, and exact against a sequential
numpy reference (path, then child, then row) on made-up inputs with
negative rotation differences, repeated nodes and collisions with the
slot's row.  The CUDA kernels themselves are held to the plain versions on
the card by ``chip_smoke.py``."""

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


def _sequential(stats, path_p, path_a, w, child_p, child_a, child_v, pv,
                slot):
    """One board and one level at a time, in level order."""
    B, Mx, _, A = stats.shape
    ref = stats.copy()
    for b in range(B):
        for s in range(path_p.shape[1]):
            if path_p[b, s] < Mx:
                ref[b, path_p[b, s], 2, path_a[b, s]] += w[b, s, 0]
                ref[b, path_p[b, s], 3, path_a[b, s]] += w[b, s, 1]
        if child_v[b] != 0:
            ref[b, child_p[b], 1, child_a[b]] += child_v[b]
        ref[b, slot[b], 0, :] += pv[b]
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
    """``scalar``: one slot on every board; ``per_board``: a slot each."""
    args = _split_inputs(0 if slot == "scalar" else 1)
    B, Mx = args[0].shape[:2]
    slot_np = (np.full(B, 3, np.int32) if slot == "scalar" else
               np.random.default_rng(2).integers(0, Mx, B).astype(np.int32))
    ref = _sequential(*args, slot_np)
    t_args = [torch.from_numpy(a.copy()) for a in args]
    t_slot = torch.from_numpy(slot_np)
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
    B, Mx = args[0].shape[:2]
    slot = torch.zeros(B, dtype=torch.int32)
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="path_p"):
        FB.fused_backup(*bad, slot)
    with pytest.raises(ValueError, match="node_col"):
        FB.fused_backup(*args, slot, node_col=args[0].shape[3])
    bad = list(args)
    bad[-1] = torch.zeros(B, 2, args[0].shape[3])
    with pytest.raises(ValueError, match="row"):
        FB.fused_backup(*bad, slot)
    # the slot is an int32 [B] tensor inside [0, M)
    for bad_slot in (0, slot.long(), slot[:-1], torch.full_like(slot, Mx)):
        with pytest.raises(ValueError, match="slot"):
            FB.fused_backup(*args, bad_slot)
    launches = FB.fused_backup.launches
    FB.fused_backup(*args, slot)
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
    slot = np.full(B, S + 1, np.int32)
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
            action, fresh, jnp.asarray(slot), pvalid,
            child_term, child_rot, values[:, 0], term_vec).stats
        return (stats, path_p, path_a, path_r, depth, leaf_rot, parent,
                action, fresh, pvalid, child_term, child_rot)

    (jstats, path_p, path_a, path_r, depth, leaf_rot, parent, action, fresh,
     pvalid, child_term, child_rot) = jax_side(tree, term_np, values_np,
                                                probs_np, rot_np)
    values, term_vec = values_np, term_np

    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    tstats = t(tree.stats)
    launches = FB.fused_backup.launches
    FB.backprop_packed(tstats, t(path_p), t(path_a), t(path_r), t(depth),
                       t(values), t(leaf_rot).long(), t(parent).long(),
                       t(action).long(), t(fresh), t(slot), t(pvalid),
                       t(child_term), t(child_rot).long(), t(values)[:, 0],
                       t(term_vec))
    assert FB.fused_backup.launches == launches   # CPU: plain version only
    assert int(np.asarray(depth).max()) >= 2
    np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))


def _entry_inputs(seed, B=12, Mx=9, A=21, S1=6, P=2, slot="scalar"):
    """Made-up arguments of ``backprop_packed``, as numpy arrays, in its
    order.  Stats are random so that every add's order shows in the bits."""
    rng = np.random.default_rng(seed)
    stats = rng.normal(size=(B, Mx, 4, A + 2)).astype(np.float32)
    path_p = rng.integers(0, Mx, size=(B, S1)).astype(np.int32)
    path_a = rng.integers(0, A, size=(B, S1)).astype(np.int32)
    path_r = rng.integers(0, P, size=(B, S1)).astype(np.int32)
    depth = rng.integers(0, S1 + 1, size=B).astype(np.int32)
    path_p[0, 0] = Mx                  # a drop sentinel below the depth
    depth[0] = max(depth[0], 1)
    return [stats, path_p, path_a, path_r, depth,
            rng.normal(size=(B, P)).astype(np.float32),      # value_vec
            rng.integers(0, P, size=B).astype(np.int64),     # leaf_rot
            rng.integers(0, Mx, size=B).astype(np.int64),    # parent
            rng.integers(0, A, size=B).astype(np.int64),     # action
            rng.random(B) < 0.6,                             # fresh
            (np.full(B, 5, np.int32) if slot == "scalar" else
             rng.integers(1, Mx, size=B).astype(np.int32)),
            rng.random((B, A), np.float32),                  # pvalid_new
            rng.random(B) < 0.4,                             # child_term
            rng.integers(0, P, size=B).astype(np.int64),     # child_rot
            rng.normal(size=B).astype(np.float32),           # leaf_init_v
            rng.normal(size=(B, P)).astype(np.float32)]      # term_vec


def _sequential_entry(stats, path_p, path_a, path_r, depth, value_vec,
                      leaf_rot, parent, action, fresh, slot, pvalid_new,
                      child_term, child_rot, leaf_init_v, term_vec,
                      level_order=1):
    """``backprop_packed`` one board, one level and one element at a time:
    the path in level order, then the child pointer, then the slot's row."""
    B, Mx, _, C = stats.shape
    A, P = C - 2, value_vec.shape[1]
    one = np.float32(1)
    ref = stats.copy()
    for b in range(B):
        for l in range(int(depth[b]))[::level_order]:
            p = path_p[b, l]
            if p >= Mx:
                continue
            v = value_vec[b, (int(path_r[b, l]) - int(leaf_rot[b])) % P]
            for col in (path_a[b, l], A):
                ref[b, p, FB.EN, col] += one
                ref[b, p, FB.EW, col] += v
        s = slot[b]
        if fresh[b] and s != 0:
            ref[b, parent[b], FB.CHILD, action[b]] += np.float32(
                -s if child_term[b] else s)
        ref[b, s, FB.PVALID, :A] += pvalid_new[b] + one
        ref[b, s, FB.PVALID, A] += np.float32(child_term[b])
        ref[b, s, FB.CHILD, A] += np.float32(child_rot[b])
        ref[b, s, FB.EW, A] += leaf_init_v[b]
        ref[b, s, :P, A + 1] += term_vec[b]
    return ref


def _t(args):
    return [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a
            for a in args]


@pytest.mark.parametrize("slot", ["scalar", "per_board"])
def test_backprop_packed_plain(slot):
    """The plain entry equals operand building followed by the operand
    contract's plain version, and both equal the sequential reference."""
    args = _entry_inputs(10 if slot == "scalar" else 11, slot=slot)
    ref = _sequential_entry(*args)
    got = FB.backprop_packed_plain(*_t(args)).numpy()
    np.testing.assert_array_equal(got, ref)
    targs = _t(args)
    ops = FB.packed_operands(*targs)
    assert ops[2].shape == args[1].shape + (2,) and ops[6].shape[1] == 4
    via = FB.fused_backup_plain(targs[0], *ops, node_col=ref.shape[3] - 2)
    np.testing.assert_array_equal(via.numpy(), ref)
    np.testing.assert_array_equal(FB.backprop_packed(*_t(args)).numpy(), ref)


@pytest.mark.parametrize("num_players", [2, 3, 4])
def test_backprop_packed_negative_rotation(num_players):
    """``path_r - leaf_rot`` below zero takes the mathematical modulo."""
    P = num_players
    args = _entry_inputs(20 + P, P=P)
    args[3][:] = 0                                       # path_r
    args[6][:] = np.arange(len(args[6])) % (P - 1) + 1   # leaf_rot in 1..P-1
    args[4][:] = np.maximum(args[4], 2)                  # depth
    args[1][1:, :2] = [1, 2]                             # live levels
    ref = _sequential_entry(*args)
    # the lane read is P - leaf_rot, never lane 0 and never a negative index
    b = 1
    v = args[5][b, P - int(args[6][b])]
    assert ref[b, 1, FB.EW, args[2][b, 0]] == (
        args[0][b, 1, FB.EW, args[2][b, 0]] + v)
    np.testing.assert_array_equal(FB.backprop_packed(*_t(args)).numpy(), ref)


def test_backprop_packed_slot_collisions():
    """A live level at the slot's node and a child pointer into the slot's
    row: the path's term, then the child's, then the row's."""
    args = _entry_inputs(30)
    slot = int(args[10][0])                              # on every board
    args[4][:] = np.maximum(args[4], 3)                  # depth
    args[1][:, 2] = slot                                 # a live p == slot
    args[1][::2, 1] = slot                               # ... twice on some
    args[7][:] = slot                                    # parent == slot
    args[9][:6] = True                                   # fresh
    ref = _sequential_entry(*args)
    A = ref.shape[3] - 2
    # the node column's value sum got the path's terms and the row's
    assert (ref[:, slot, FB.EW, A] != args[0][:, slot, FB.EW, A]).all()
    np.testing.assert_array_equal(FB.backprop_packed(*_t(args)).numpy(), ref)
    # the operand contract on the same case: a random four-lane row overlaps
    # the path's edge elements and the child pointer too
    ops = [o.numpy() for o in FB.packed_operands(*_t(args))[:7]]
    ops[6] = ops[6] + np.random.default_rng(31).normal(
        size=ops[6].shape).astype(np.float32)
    p_, a_, w_, cp_, ca_, cv_, row_ = ops
    seq = args[0].copy()
    for b in range(len(seq)):
        for l in range(p_.shape[1]):
            if p_[b, l] < seq.shape[1]:
                for col in (a_[b, l], A):
                    seq[b, p_[b, l], FB.EN, col] += w_[b, l, 0]
                    seq[b, p_[b, l], FB.EW, col] += w_[b, l, 1]
        if cv_[b] != 0:
            seq[b, cp_[b], FB.CHILD, ca_[b]] += cv_[b]
        seq[b, slot] += row_[b]
    assert (cv_ != 0).any() and (cp_ == slot).all()
    got = FB.packed_backup(torch.from_numpy(args[0].copy()), *_t(ops),
                           torch.from_numpy(args[10]))
    np.testing.assert_array_equal(got.numpy(), seq)


def test_backprop_packed_repeated_node():
    """One node twice on a path, at different actions: its node column
    receives both terms in level order."""
    args = _entry_inputs(40, P=3)
    args[4][:] = np.maximum(args[4], 4)                  # depth
    args[1][:, 3] = args[1][:, 1]                        # p repeats
    args[2][:, 3] = (args[2][:, 1] + 1) % 21             # at another action
    args[3][:, 1], args[3][:, 3] = 0, 1                  # and another value
    ref = _sequential_entry(*args)
    np.testing.assert_array_equal(FB.backprop_packed(*_t(args)).numpy(), ref)
    # the order of the two terms shows in the bits of some board
    assert (_sequential_entry(*args, level_order=-1) != ref).any()


def test_backprop_packed_checks_arguments():
    args = _entry_inputs(50)
    bad = _t(args)
    bad[7] = bad[7].to(torch.int32)                      # parent
    with pytest.raises(ValueError, match="parent"):
        FB.backprop_packed(*bad)
    bad = _t(args)
    bad[11] = bad[11][:, :-1]                            # pvalid_new
    with pytest.raises(ValueError, match="pvalid_new"):
        FB.backprop_packed(*bad)
    bad = _t(args)
    bad[10] = torch.full_like(bad[10], args[0].shape[1])  # slot == M
    with pytest.raises(ValueError, match="slot"):
        FB.backprop_packed(*bad)
    # a live level at a node column would alias the node's own sums; the
    # check reads the tensors, which costs nothing on the CPU
    bad = _t(args)
    bad[4][:] = 2
    bad[1][3, 1], bad[2][3, 1] = 1, args[0].shape[3] - 2
    with pytest.raises(ValueError, match="edge column"):
        FB.backprop_packed(*bad)
    ops = list(FB.packed_operands(*_t(args)))
    ops[1][0, 0], ops[0][0, 0] = args[0].shape[3] - 2, 1
    with pytest.raises(ValueError, match="node column"):
        FB.packed_backup(torch.from_numpy(args[0].copy()), *ops)
