"""Port parity: the cases of ``tests/test_mcts.py`` and
``tests/test_mcts_staged.py`` run against the port's search on the CPU,
where its descent is ``ops/descent.py::select``'s plain version.

Every case takes its roots from the JAX test's seeds (``jax.random`` keys,
or numpy for the hand-built positions) and feeds the same boards to the
port.  A case that checks an invariant checks it on the port's results.
A case that compares two searches (descent unroll factors, stage
schedules) compares the port's runs with each other and holds them to the
unstaged, single-level JAX search on the same roots: visit counts and
pruned counts equal, ``q``, root values and root priors within 1e-6 (as
``test_torch_port_search.py`` holds them: the priors' normalizing sums run
in another order).  With noise the port takes the
JAX search's Gamma draws (``jax.random.gamma`` with the search's key) as
``noise_gamma``."""

import dataclasses
import functools

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
from alphazero_tpu_torch.ops import descent as D
from alphazero_tpu_torch.search import mcts as M
from tests.test_torch_port_train import _one_thread  # noqa: F401

CFG = E.SplendorConfig(num_players=2)
JCFG = JE.SplendorConfig(num_players=2)


def _fns():
    return (A.make_uniform_eval_fn(CFG), A.make_search_step_fn(CFG),
            A.make_valid_fn(CFG))


@functools.lru_cache(maxsize=None)
def _jroots(B, seed):
    """The JAX tests' roots: ``initial_state`` of split keys."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return np.array(jax.jit(jax.vmap(
        lambda k: JE.initial_state(JCFG, k)))(keys))


def _search(kw, roots, seed=None):
    """The port's fresh search of ``roots`` (numpy int8) with the uniform
    evaluator; with ``add_noise`` the JAX search's Gamma draws for
    ``PRNGKey(seed)``."""
    assert roots.dtype == np.int8
    return _cached_search(tuple(sorted(kw.items())), roots.tobytes(),
                          roots.shape, seed)


@functools.lru_cache(maxsize=None)
def _cached_search(items, roots_bytes, shape, seed):
    """``_search`` once per configuration and roots: the staged cases share
    their unstaged reference run."""
    kw = dict(items)
    roots = np.frombuffer(roots_bytes, np.int8).reshape(shape).copy()
    mcfg = M.MCTSConfig(**kw)
    search = M.build_search(mcfg, 2, *_fns(), device="cpu")
    gamma = None
    if mcfg.add_noise:
        gamma = torch.from_numpy(np.array(jax.random.gamma(
            jax.random.PRNGKey(seed), mcfg.dirichlet_alpha,
            (roots.shape[0], 409))))
    before = D.select.launches
    res = search(None, torch.from_numpy(roots), noise_gamma=gamma)
    assert D.select.launches == before          # the plain descent ran
    return res


@functools.lru_cache(maxsize=None)
def _jax_search(items, B, roots_seed, key_seed):
    """The JAX search (unstaged, single-level descent) of the JAX tests'
    roots; ``items`` are its config's fields as a sorted tuple."""
    search = jax.jit(JM.build_search(
        JM.MCTSConfig(**dict(items)), 2, JA.make_uniform_eval_fn(JCFG),
        JA.make_search_step_fn(JCFG), JA.make_valid_fn(JCFG)))
    res = search(None, jnp.asarray(_jroots(B, roots_seed)),
                 jax.random.PRNGKey(key_seed))
    return {k: np.asarray(getattr(res, k)) for k in res._fields}


def _assert_port_equals_jax(res, kw, B, roots_seed, key_seed):
    ref = dict(kw, stage_sims="off", descent_unroll=1)
    want = _jax_search(tuple(sorted(ref.items())), B, roots_seed, key_seed)
    for name in ("raw_counts", "counts"):
        np.testing.assert_array_equal(want[name],
                                      getattr(res, name).numpy(),
                                      err_msg=name)
    for name in ("q", "root_value", "root_prior"):
        np.testing.assert_allclose(want[name], getattr(res, name).numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def _assert_same(a, b):
    for name in ("raw_counts", "counts", "q", "root_value", "root_prior"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# -- the cases of tests/test_mcts.py --------------------------------------

def test_counts_sum_and_validity():
    B = 4
    roots = _jroots(B, 0)
    res = _search(dict(num_sims=40), roots)
    counts = res.raw_counts.numpy()
    valids = A.make_valid_fn(CFG)(torch.from_numpy(roots)).numpy()
    assert counts.shape == (B, 409)
    np.testing.assert_array_equal(counts.sum(1), 40)
    assert (counts[~valids] == 0).all()
    q = res.q.numpy()
    assert (np.abs(q) <= 1.0 + 1e-6).all()
    np.testing.assert_allclose(q[:, 0], -q[:, 1], atol=1e-6)


def test_mcts_finds_winning_buy():
    """Player 0 can buy a card that reaches 15 points; the search with the
    uniform evaluator must prefer such a buy."""
    rng = np.random.default_rng(0)
    u24 = rng.random(24).astype(np.float32)
    nobles = rng.choice(10, size=3, replace=False)
    st = np.array(JE.init_with_uniforms(JCFG, u24, nobles))
    st[CFG.row_pcards + 0, 6] = 14
    st[CFG.row_pcards + 0, :5] = 7
    st[CFG.row_nobles:CFG.row_nobles + CFG.num_nobles] = 0
    st[0, 6] = 10
    state = torch.from_numpy(st)[None]
    valids = E.valid_moves(CFG, state, 0)[0].numpy()
    pts = st[2:26:2, 6]
    winning = [a for a in np.flatnonzero(valids[:12]) if pts[a] >= 1]
    assert winning, "fixture must offer a winning buy"
    res = _search(dict(num_sims=200), st[None])
    best = int(res.raw_counts[0].argmax())
    assert best in winning, (best, winning)
    assert float(res.q[0, 0]) > 0.3


def test_dirichlet_noise_changes_distribution():
    roots = torch.from_numpy(_jroots(2, 3))
    fns = _fns()
    plain = M.build_search(M.MCTSConfig(num_sims=30), 2, *fns, device="cpu")
    noisy = M.build_search(M.MCTSConfig(num_sims=30, add_noise=True,
                                        dirichlet_alpha=0.2, prior_temp=1.25),
                           2, *fns, device="cpu")
    r1 = plain(None, roots)
    r2 = noisy(None, roots, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(r1.root_prior, r2.root_prior)


def test_forced_playouts_pruning():
    res = _search(dict(num_sims=60, forced_playouts=True), _jroots(2, 4))
    counts, raw = res.counts.numpy(), res.raw_counts.numpy()
    assert (counts <= raw + 1e-6).all()
    for b in range(2):
        assert counts[b].argmax() == raw[b].argmax()
    assert (counts.sum(1) > 0).all()


def test_depth_cap_preserves_invariants():
    roots = _jroots(3, 7)
    res = _search(dict(num_sims=40, max_depth=4), roots)
    counts = res.raw_counts.numpy()
    np.testing.assert_array_equal(counts.sum(1), 40)
    valids = A.make_valid_fn(CFG)(torch.from_numpy(roots)).numpy()
    assert (counts[~valids] == 0).all()
    q = res.q.numpy()
    np.testing.assert_allclose(q[:, 0], -q[:, 1], atol=1e-6)


def test_terminal_backup():
    """One move from the opponent's win, the mover's root q is ~ -1."""
    rng = np.random.default_rng(1)
    u24 = rng.random(24).astype(np.float32)
    st = np.array(JE.init_with_uniforms(JCFG, u24, rng.choice(10, 3, False)))
    st[CFG.row_pcards + 0, 6] = 15
    st[0, 6] = 11
    stc = E.swap_players(CFG, torch.from_numpy(st)[None], 1).numpy()
    res = _search(dict(num_sims=50), stc)
    assert float(res.q[0, 0]) < -0.9


@pytest.mark.parametrize("extra", [{}, {"max_depth": 4},
                                   {"forced_playouts": True}],
                         ids=["plain", "depth_cap", "forced"])
def test_descent_unroll_is_exact(extra):
    """``descent_unroll`` changes how the JAX descent runs, not its result:
    the port's search at every factor equals the JAX search at factor 1."""
    roots = _jroots(6, 4)
    kw = dict(num_sims=24, **extra)
    results = [_search(dict(kw, descent_unroll=u), roots) for u in (1, 2, 3)]
    for res in results[1:]:
        _assert_same(res, results[0])
    _assert_port_equals_jax(results[0], kw, 6, 4, 7)


def test_edge_visits_only_on_valid_actions_all_nodes():
    """Every expanded node's edge visits lie within its own state's valid
    moves, on the port's reusing search tree."""
    mcfg = M.MCTSConfig(num_sims=48, forced_playouts=True, add_noise=True,
                        dirichlet_alpha=0.2, prior_temp=1.25, max_depth=32)
    rs = M.build_reusing_search(mcfg, 2, *_fns(), keep_cap=48, device="cpu")
    tree, n = rs.init_tree(torch.from_numpy(_jroots(4, 11)))
    _, tree, _ = rs.run(None, tree, n,
                        generator=torch.Generator().manual_seed(3))
    stats, states = tree.stats.numpy(), tree.states
    B, Mx = states.shape[:2]
    vm_all = A.make_valid_fn(CFG)(states.reshape(B * Mx, *states.shape[2:])
                                  ).reshape(B, Mx, -1).numpy()
    A_ = 409
    expanded = 0
    for b in range(B):
        en, pv = stats[b, :, 2, :A_], stats[b, :, 0, :A_]
        for m in np.flatnonzero((pv >= 0).any(1)):
            expanded += 1
            bad = (en[m] > 0) & ~vm_all[b, m]
            assert not bad.any(), (b, m, np.flatnonzero(bad)[:8])
    assert expanded > B


# -- the cases of tests/test_mcts_staged.py --------------------------------

STAGED_B, STAGED_ROOTS, STAGED_KEY = 6, 0, 3


def _staged_pair(base, spec):
    """The port's search with ``stage_sims=spec`` and unstaged; both equal,
    and equal to the JAX search."""
    roots = _jroots(STAGED_B, STAGED_ROOTS)
    kw = dataclasses.asdict(base)
    unstaged = _search(kw, roots, seed=STAGED_KEY)
    staged = _search(dict(kw, stage_sims=spec), roots, seed=STAGED_KEY)
    _assert_same(staged, unstaged)
    ref = {k: v for k, v in kw.items()
           if v != getattr(JM.MCTSConfig(), k)}
    _assert_port_equals_jax(staged, ref, STAGED_B, STAGED_ROOTS, STAGED_KEY)


@pytest.mark.parametrize("spec", ["16,16,32", "auto", "8,8,16,32"])
def test_staged_exactness_plain(spec):
    _staged_pair(M.MCTSConfig(num_sims=64, stage_sims="off"), spec)


def test_staged_exactness_noise_forced():
    """Noise once and forced playouts on the call's sim index, whatever the
    schedule."""
    _staged_pair(M.MCTSConfig(num_sims=96, stage_sims="off", add_noise=True,
                              dirichlet_alpha=0.2, dirichlet_frac=0.25,
                              forced_playouts=True, fpu=0.3),
                 "16,16,32,32")


def test_auto_schedule_shape():
    for S in (64, 128, 48):
        for spec in ("auto", "off"):
            assert M._resolve_stage_schedule(
                M.MCTSConfig(num_sims=S, stage_sims=spec)) == \
                JM._resolve_stage_schedule(
                    JM.MCTSConfig(num_sims=S, stage_sims=spec))
    assert M._resolve_stage_schedule(M.MCTSConfig(num_sims=64)) == (16, 16, 32)
    assert M._resolve_stage_schedule(
        M.MCTSConfig(num_sims=128)) == (16, 16, 32, 64)
    assert M._resolve_stage_schedule(M.MCTSConfig(num_sims=48)) is None
    with pytest.raises(ValueError):
        M._resolve_stage_schedule(M.MCTSConfig(num_sims=64,
                                               stage_sims="16,16"))


def test_staged_respects_unroll():
    _staged_pair(M.MCTSConfig(num_sims=64, stage_sims="off", descent_unroll=2),
                 "auto")


def test_staged_with_depth_cap():
    """A depth cap composes with any schedule (self-play's S=128,
    max_depth=64 relies on it)."""
    _staged_pair(M.MCTSConfig(num_sims=96, stage_sims="off", max_depth=24,
                              fpu=0.0),
                 "16,16,32,32")
