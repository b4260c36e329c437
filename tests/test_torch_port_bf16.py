"""Port parity: the bfloat16 search and the bfloat16 net trunk.

``MCTSConfig.stats_dtype="bfloat16"`` stores the tree stats in bf16 and
``NetConfig.dtype="bfloat16"`` runs the net's trunk in bf16, in both
packages.  Here, on the CPU (the kernels' plain versions):

- the five cases of ``tests/test_mcts_bf16.py`` on the port, at the same
  B=48, S=48 and thresholds: bf16 stats, a bf16 trunk and both against the
  float32 search, the guard against trees past 256, and ``"auto"``;
- ``tests/test_net_dtype.py``'s case on the port: one parameter tree for
  both dtypes, float32 outputs, close numerics;
- the port's bf16 search against JAX's bf16 search on the same roots,
  weights (``from_flax``) and Gamma draws: with a float32 trunk the counts,
  ``q`` and ``root_prior`` are equal bit for bit (``root_value`` is the
  net's float32 output, whose matmuls sum in another order: 1e-6); with a
  bf16 trunk as well, the counts agree within ``test_mcts_bf16``'s bounds;
- ``select_plain`` and ``backprop_packed_plain`` on bf16 stats against
  JAX's ``_select`` and ``_backprop_fused`` on made-up trees, bit for bit;
- the port's bf16 net against JAX's bf16 net, inference and one train-mode
  forward, within a stated tolerance.

The kernels are held to the plain versions on the card by
``chip_smoke.py``."""

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
from alphazero_tpu_torch.ops import fused_backup as FB
from alphazero_tpu_torch.search import mcts as M
from alphazero_tpu_torch.utils import checkpoint as C
from tests.test_torch_port_backup import _entry_inputs, _t
from tests.test_torch_port_descent import CASES, OUTPUTS, _tree
from tests.test_torch_port_search import _run_both
from tests.test_torch_port_train import _one_thread  # noqa: F401
from tests.test_torch_port_train import batch_np, jax_net

B, SIMS = 48, 48
_japply_inference = jax.jit(JN.apply_inference, static_argnums=0)
_japply_train = jax.jit(JN.apply_train, static_argnums=0)
R6 = os.path.join(os.path.dirname(__file__), "..", "runs", "r6")
BF16 = torch.bfloat16


# ------------------------------------------- tests/test_mcts_bf16.py's cases
@pytest.fixture(scope="module")
def setup():
    """JAX's ``init_params`` weights and ``initial_state`` roots, as
    ``tests/test_mcts_bf16.py`` makes them, on the port."""
    jcfg = JE.SplendorConfig(num_players=2)
    params, bs = JN.init_params(JA.net_config_for(jcfg), jax.random.PRNGKey(0))
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    roots = jax.jit(jax.vmap(lambda k: JE.initial_state(jcfg, k)))(keys)
    return N.from_flax(params, bs), torch.from_numpy(np.array(roots))


def _port_search(setup, net_dtype, stats_dtype):
    state_dict, roots = setup
    cfg = E.SplendorConfig(num_players=2)
    net_cfg = A.net_config_for(cfg, dtype=net_dtype)
    net = N.build_net(net_cfg, device="cpu")
    net.load_state_dict(state_dict)
    search = M.build_search(M.MCTSConfig(num_sims=SIMS,
                                         stats_dtype=stats_dtype),
                            2, A.make_eval_fn(net_cfg),
                            A.make_search_step_fn(cfg), A.make_valid_fn(cfg),
                            device="cpu")
    return search(net, roots)


@pytest.fixture(scope="module")
def f32_result(setup):
    return _port_search(setup, "float32", "float32")


def _assert_close_search(res, ref, argmax_agree=0.9, q_p95=0.02, q_max=0.15):
    """``tests/test_mcts_bf16.py``'s bounds."""
    counts = res.counts.numpy().astype(np.float64)
    ref_counts = ref.counts.numpy().astype(np.float64)
    pi = counts / counts.sum(1, keepdims=True)
    ref_pi = ref_counts / ref_counts.sum(1, keepdims=True)
    l1 = np.abs(pi - ref_pi).sum(1)
    assert np.median(l1) < 0.25, f"median L1 {np.median(l1)}"
    agree = (pi.argmax(1) == ref_pi.argmax(1)).mean()
    assert agree >= argmax_agree, f"argmax agreement {agree}"
    dq = np.abs(res.q.numpy().astype(np.float64)
                - ref.q.numpy().astype(np.float64))
    assert np.percentile(dq, 95) < q_p95, f"p95 |dQ| {np.percentile(dq, 95)}"
    assert dq.max() < q_max, f"max |dQ| {dq.max()}"
    assert np.allclose(counts, np.round(counts))
    for name in ("counts", "q", "root_value", "root_prior"):
        assert getattr(res, name).dtype == torch.float32, name


def test_bf16_stats_matches_f32(setup, f32_result):
    _assert_close_search(_port_search(setup, "float32", "bfloat16"),
                         f32_result)


def test_bf16_net_matches_f32(setup, f32_result):
    _assert_close_search(_port_search(setup, "bfloat16", "float32"),
                         f32_result, argmax_agree=0.8)


def test_bf16_full_fast_path(setup, f32_result):
    _assert_close_search(_port_search(setup, "bfloat16", "bfloat16"),
                         f32_result, argmax_agree=0.8, q_p95=0.03, q_max=0.2)


def _build(num_sims, stats_dtype, reuse=False, keep_cap=0):
    cfg = E.SplendorConfig(num_players=2)
    args = (M.MCTSConfig(num_sims=num_sims, stats_dtype=stats_dtype), 2,
            A.make_uniform_eval_fn(cfg), A.make_search_step_fn(cfg),
            A.make_valid_fn(cfg))
    if reuse:
        return M.build_reusing_search(*args, keep_cap=keep_cap, device="cpu")
    return M.build_search(*args, device="cpu")


def test_bf16_stats_guard_rejects_large_trees():
    with pytest.raises(ValueError, match="bfloat16"):
        _build(400, "bfloat16")
    # the largest fresh tree bf16 takes: capacity 256
    _build(255, "bfloat16")
    with pytest.raises(ValueError, match="bfloat16"):
        _build(256, "bfloat16")


def test_auto_stats_dtype_resolves_f32_on_cpu_and_guards_reuse():
    """``"auto"`` is float32 (the JAX rule off a TPU; the port's, on cuda
    too), and bf16 is refused for a reused tree of any size."""
    _build(300, "auto")
    for keep_cap in (0, 16):
        assert M.stats_dtype(M.MCTSConfig(stats_dtype="auto"),
                             keep_cap) == torch.float32
    assert M.stats_dtype(M.MCTSConfig(num_sims=16, stats_dtype="bfloat16"),
                         0) == BF16
    with pytest.raises(ValueError, match="bfloat16"):
        _build(16, "bfloat16", reuse=True, keep_cap=16)
    with pytest.raises(ValueError, match="stats_dtype"):
        _build(16, "float16")
    rs = _build(4, "auto", reuse=True, keep_cap=4)
    tree, _ = rs.init_tree(E.initial_state(E.SplendorConfig(), 2,
                                           torch.Generator().manual_seed(0),
                                           "cpu"))
    assert tree.stats.dtype == torch.float32


def test_bf16_tree_and_selfplay_reuse_guard():
    """A bf16 search's tree holds bf16 stats; self-play with tree reuse
    refuses bf16 as the JAX engine does (its reusing search raises)."""
    from alphazero_tpu_torch.train import selfplay as SP
    cfg = E.SplendorConfig(num_players=2)
    search = _build(8, "bfloat16")
    out = search(None, E.initial_state(cfg, 2,
                                       torch.Generator().manual_seed(0),
                                       "cpu"))
    assert int(out.raw_counts.sum()) == 2 * 8
    with pytest.raises(ValueError, match="bfloat16"):
        SP.SelfPlayEngine(cfg, A.make_uniform_eval_fn(cfg),
                          SP.SelfPlayConfig(batch_size=4, num_sims=8,
                                            tree_reuse=True,
                                            stats_dtype="bfloat16"),
                          device="cpu")
    SP.SelfPlayEngine(cfg, A.make_uniform_eval_fn(cfg),
                      SP.SelfPlayConfig(batch_size=4, num_sims=8,
                                        stats_dtype="bfloat16"),
                      device="cpu")


def test_pallas_backup_raises_as_in_jax():
    """``pallas_backup=True`` raises ``NotImplementedError`` in both
    packages, fresh and reusing."""
    cfg, jcfg = E.SplendorConfig(), JE.SplendorConfig()
    with pytest.raises(NotImplementedError):
        JM.build_search(JM.MCTSConfig(num_sims=4, pallas_backup=True), 2,
                        JA.make_uniform_eval_fn(jcfg),
                        JA.make_search_step_fn(jcfg), JA.make_valid_fn(jcfg))
    args = (M.MCTSConfig(num_sims=4, pallas_backup=True), 2,
            A.make_uniform_eval_fn(cfg), A.make_search_step_fn(cfg),
            A.make_valid_fn(cfg))
    with pytest.raises(NotImplementedError, match="pallas_backup"):
        M.build_search(*args, device="cpu")
    with pytest.raises(NotImplementedError, match="pallas_backup"):
        M.build_reusing_search(*args, keep_cap=4, device="cpu")


# ------------------------------------------- tests/test_net_dtype.py's case
@pytest.mark.parametrize("version", [0, 1, 2])
def test_bf16_matches_f32_and_shares_params(version, setup):
    jcfg = JE.SplendorConfig(num_players=2)
    f32 = A.net_config_for(E.SplendorConfig(), nn_version=version)
    bf16 = dataclasses.replace(f32, dtype="bfloat16")
    params, bs = JN.init_params(JA.net_config_for(jcfg, nn_version=version),
                                jax.random.PRNGKey(0))
    net32 = N.build_net(f32, device="cpu")
    net32.load_state_dict(N.from_flax(params, bs))
    net16 = N.build_net(bf16, device="cpu")
    # one parameter tree: a bf16 net loads float32 checkpoints as they are
    s32 = {k: (v.shape, v.dtype) for k, v in net32.state_dict().items()}
    s16 = {k: (v.shape, v.dtype) for k, v in net16.state_dict().items()}
    assert s32 == s16
    net16.load_state_dict(net32.state_dict())
    boards = setup[1][:16].float()
    valids = E.valid_moves(E.SplendorConfig(), setup[1][:16], 0)
    pi32, v32, _ = N.apply_inference(net32, boards, valids)
    pi16, v16, sd16 = N.apply_inference(net16, boards, valids)
    assert pi16.dtype == v16.dtype == sd16.dtype == torch.float32
    np.testing.assert_allclose(v16.numpy(), v32.numpy(), atol=0.15)
    l1 = (pi16 - pi32).abs().sum(-1)
    assert float(l1.max()) < 0.35, float(l1.max())
    agree = (pi16.argmax(-1) == pi32.argmax(-1)).double().mean()
    assert agree >= 0.8, agree


# --------------------------------------- the port's bf16 net against JAX's
# Tolerances: JAX and PyTorch round the bf16 trunk's products to bf16 after
# summing in another order, so a few activations differ in their last bf16
# bit (with the products upcast to float32 on both sides the outputs agree
# to 1e-6); the largest differences over these nets and batches were 3.2e-3
# (policy), 5.8e-3 (value) and 2.4e-2 (score-diff log-probabilities).
NET_TOL = dict(pi=1e-2, v=1.5e-2, log_pi=2e-2, sd=6e-2)


@pytest.mark.parametrize("version,width", [(1, 48), (1, 128), (2, 256)])
def test_bf16_net_matches_jax_bf16_net(version, width):
    jcfg, params, bs, net32 = jax_net(version, width)
    j16 = dataclasses.replace(jcfg, dtype="bfloat16")
    net = N.build_net(N.NetConfig(**j16.__dict__), device="cpu")
    net.load_state_dict(net32.state_dict())
    b = batch_np(2, 64, seed=version + width)
    boards = torch.from_numpy(b["boards"]).float()
    valids = torch.from_numpy(b["valids"])
    jb, jv = jnp.asarray(b["boards"], jnp.float32), jnp.asarray(b["valids"])
    jpi, jval, jsd = _japply_inference(j16, params, bs, jb, jv)
    pi, val, sd = N.apply_inference(net, boards, valids)
    np.testing.assert_allclose(pi.numpy(), np.asarray(jpi), atol=NET_TOL["pi"])
    np.testing.assert_allclose(val.numpy(), np.asarray(jval),
                               atol=NET_TOL["v"])
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), atol=NET_TOL["sd"])
    # one train-mode forward (dropout 0: the masks come from different
    # generators) and the running statistics it moves
    (jlp, jval, jsd), jbs = _japply_train(j16, params, bs, jb, jv,
                                          jax.random.PRNGKey(0))
    (lp, val, sd), _ = N.apply_train(net, boards, valids)
    ok = b["valids"]
    np.testing.assert_allclose(lp.detach().numpy()[ok], np.asarray(jlp)[ok],
                               atol=NET_TOL["log_pi"])
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval),
                               atol=NET_TOL["v"])
    np.testing.assert_allclose(sd.detach().numpy(), np.asarray(jsd),
                               atol=NET_TOL["sd"])
    assert lp.dtype == torch.float32
    _, new_bs = N.to_flax(net.state_dict())
    got = dict(C.tree_items(new_bs))
    for k, want in C.tree_items(jbs):
        # float32 statistics of bf16 activations, a few of which differ by
        # a bf16 ulp (see NET_TOL): 1e-3 relative, 1e-4 absolute
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=1e-3,
                                   atol=1e-4, err_msg=str(k))


# ------------------------------- the port's bf16 search against JAX's
def _r6_nets(dtype):
    ckpt = C.load_checkpoint(R6, "best.pt")
    cfg, jcfg = E.SplendorConfig(), JE.SplendorConfig()
    net_cfg = A.net_config_for(cfg, dtype=dtype)
    net = N.build_net(net_cfg, device="cpu")
    net.load_state_dict(N.from_flax(ckpt["params"], ckpt["batch_stats"]))
    return ((ckpt["params"], ckpt["batch_stats"]),
            JA.make_eval_fn(JA.net_config_for(jcfg, dtype=dtype)), net,
            A.make_eval_fn(net_cfg))


def test_bf16_search_equals_jax_bf16_search():
    """bf16 stats, float32 trunk, the r6 weights, root noise and forced
    playouts; JAX staged ("auto") and the port unstaged."""
    kw = dict(num_sims=48, add_noise=True, prior_temp=1.25,
              forced_playouts=True, fpu=0.2, stats_dtype="bfloat16")
    jr, tr = _run_both(kw, "auto", *_r6_nets("float32"), B=12, seed=5)
    for name in ("raw_counts", "counts", "q", "root_prior"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tr.root_value.numpy(),
                               np.asarray(jr.root_value), atol=1e-6)
    assert np.abs(tr.q.numpy()).max() > 1e-3       # the net's values count


def test_bf16_full_fast_path_against_jax():
    """bf16 stats and a bf16 trunk in both packages: the trunks' products
    round apart (see ``NET_TOL``), so the searches are held to each other
    within ``test_mcts_bf16``'s full-fast-path bounds."""
    kw = dict(num_sims=48, stats_dtype="bfloat16")
    jr, tr = _run_both(kw, "off", *_r6_nets("bfloat16"), B=16, seed=6)

    class R:                                         # the JAX result as torch
        counts = torch.from_numpy(np.array(jr.counts))
        q = torch.from_numpy(np.array(jr.q))
    _assert_close_search(tr, R, argmax_agree=0.8, q_p95=0.03, q_max=0.2)


# ---------------------------------- the plain versions on made-up bf16 trees
def _chain_last_board(st):
    """The last board's path runs through every node, so the deepest node
    is the last row of the tensor (``b = B-1, m = M-1``)."""
    Mx, A = st.shape[1], st.shape[3] - 2
    st[-1, :, D.PVALID, :A] = 0.25
    st[-1, :, D.EN, :A] = 0.0
    st[-1, :, D.CHILD, :A] = np.arange(1, Mx + 1, dtype=np.float32)[:, None]
    st[-1, -1, D.CHILD, :A] = 0.0
    return st


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES) if c[5] > 0])
def test_select_plain_bf16_equals_jax_select(i):
    B_, Mx, A_, fpu, forced, _, p_child, sim = CASES[i]
    cap = Mx                     # deep enough for the chained board
    kw = dict(cpuct=1.25, fpu=fpu, forced_playouts=forced, k_forced=0.5)
    st = _chain_last_board(_tree(200 + i, B_, Mx, A_, p_child))
    stats = torch.from_numpy(st).to(BF16)
    jtree = JM.Tree(states=jnp.zeros((B_, Mx, 1, 7), jnp.int8),
                    stats=jnp.asarray(stats.float().numpy(), jnp.bfloat16),
                    parent=jnp.zeros((B_, Mx), jnp.int32))
    z = jnp.zeros((B_, cap), jnp.int32)
    jout = jax.jit(lambda t, s: JM._select(JM.MCTSConfig(**kw), t, s,
                                           z + Mx, z, z, cap))(
        jtree, jnp.int32(sim))
    tout = D.select(M.MCTSConfig(**kw), stats, sim, cap, cap)
    for name, j, t in zip(OUTPUTS, jout, tout):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
    assert int(tout[3][-1]) == Mx and int(tout[0][-1]) == Mx - 1


def _jax_backprop(args):
    (stats, path_p, path_a, path_r, depth, value_vec, leaf_rot, parent,
     action, fresh, slot, pvalid_new, child_term, child_rot, leaf_init_v,
     term_vec) = args
    B_, Mx = stats.shape[:2]
    tree = JM.Tree(states=jnp.zeros((B_, Mx, 1, 7), jnp.int8),
                   stats=jnp.asarray(stats, jnp.bfloat16),
                   parent=jnp.zeros((B_, Mx), jnp.int32))
    i32 = lambda x: jnp.asarray(x, jnp.int32)   # noqa: E731
    out = jax.jit(JM._backprop_fused)(
        tree, i32(path_p), i32(path_a), i32(path_r), i32(depth),
        jnp.asarray(value_vec), i32(leaf_rot), i32(parent), i32(action),
        jnp.asarray(fresh), i32(slot), jnp.asarray(pvalid_new),
        jnp.asarray(child_term), i32(child_rot), jnp.asarray(leaf_init_v),
        jnp.asarray(term_vec))
    return np.asarray(out.stats.astype(jnp.float32))


@pytest.mark.parametrize("case", ["plain", "collisions", "repeated", "p4"])
def test_backprop_packed_plain_bf16_equals_jax(case):
    """Made-up arguments (``tests/test_torch_port_backup.py``'s) on bf16
    stats; values on a 1/8 grid, so that the float32 sum over an element's
    levels is exact in any order (JAX's einsum sums them in its own)."""
    P = 4 if case == "p4" else 2
    args = _entry_inputs({"plain": 60, "collisions": 61, "repeated": 62,
                          "p4": 63}[case], P=P,
                         slot="scalar" if case == "collisions" else "board")
    args[5] = np.round(args[5] * 8) / 8                  # value_vec
    if case == "collisions":
        slot = int(args[10][0])
        args[4][:] = np.maximum(args[4], 3)              # depth
        args[1][:, 2] = slot                             # a live p == slot
        args[7][:] = slot                                # parent == slot
    elif case == "repeated":
        args[4][:] = np.maximum(args[4], 4)
        args[1][:, 3] = args[1][:, 1]                    # p repeats
    # as in a tree: the child pointer's element holds 0 before its install,
    # the slot's priors -1
    b = np.arange(len(args[7]))
    args[0][b, args[7], FB.CHILD, args[8]] = 0.0
    args[0][b, args[10], FB.PVALID, :-2] = -1.0
    stats = torch.from_numpy(args[0]).to(BF16)
    args[0] = stats.float().numpy()
    want = _jax_backprop(args)
    targs = _t(args)
    targs[0] = stats
    got = FB.backprop_packed(*targs)
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the priors land on JAX's 1/128 grid, -1 + bf16(p + 1)
    sl = args[10]
    pr = got[b, sl, FB.PVALID, :-2].float().numpy()
    np.testing.assert_array_equal(pr * 128, np.round(pr * 128))


def test_operand_contract_stays_float32():
    args = _entry_inputs(70)
    stats = torch.from_numpy(args[0]).to(BF16)
    ops = FB.packed_operands(*_t(args))
    with pytest.raises(ValueError, match="float32"):
        FB.packed_backup(stats, *ops)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        D.select(M.MCTSConfig(), stats.half(), 0, 2, 2)


@pytest.mark.parametrize("A_,f32,bf16", [(409, 15_312, 8_752),
                                         (410, 15_344, 8_784)])
def test_smem_bytes_bf16(A_, f32, bf16):
    """A bf16 row buffer holds ``8 * C + 8`` bytes rounded up to 16: the
    row copied from the 16-byte boundary at or below its start."""
    C_ = A_ + 2
    assert D.smem_bytes(C_) == f32
    assert D.smem_bytes(C_, 2) == bf16
    assert D.row_buf_bytes(C_, 2) >= 8 * C_ + 8
    assert D.row_buf_bytes(C_, 2) % 16 == 0
