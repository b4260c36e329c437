"""The descent wrapper's host side, and the plain descent on made-up trees.

The descent kernel (``ops/csrc/descent.cu``) runs only on the card, where
``chip_smoke.py`` holds it to ``select_plain``.  Here: the shared memory
its wrapper asks for per block (two node rows, the barriers, the warps'
winners and their column lists), that ``select`` on CPU tensors is ``select_plain`` bit
for bit, and that the plain descent equals JAX's ``_select`` on the trees
``chip_smoke.py`` makes up (ties, all-invalid rows, terminal and -0.0 child
pointers, NaN values, cycles that run to the depth cap, 700-edge rows),
which searches
rarely build.  ``tests/test_torch_port_search.py`` holds it to
``_select`` on trees that JAX searches built."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.search import mcts as JM
from alphazero_tpu_torch.ops import descent as D
from alphazero_tpu_torch.search import mcts as M

OUTPUTS = ("parent", "action", "existing", "depth", "parent_rot", "path_p",
           "path_a", "path_r")
DTYPES = [torch.int64] * 3 + [torch.int32, torch.int64] + [torch.int32] * 3

# (boards, nodes, actions, fpu, forced playouts, depth cap, share of edges
# with a child, sim_idx): chip_smoke.py's made-up cases at fewer boards
CASES = [
    (48, 24, 409, 0.25, True, 23, 0.5, 37),
    (48, 24, 409, -0.1, True, 23, 0.9, 50),
    (48, 24, 409, 0.0, False, 6, 0.9, 0),
    (48, 24, 409, 0.3, False, 23, 0.5, 5),
    (48, 24, 409, 0.0, True, 1, 0.9, 20),
    (16, 12, 409, 0.25, True, 0, 0.5, 9),
    (16, 12, 700, 0.25, True, 11, 0.7, 44),
]


def _tree(seed, B, Mx, A, p_child):
    """Random float32 stats [B, Mx, 4, A+2], made as chip_smoke.py's are:
    priors and values on coarse grids (ties in u), a sixth of the child
    pointers negative (terminal; -0.0 where there is no child), every 5th
    board with one prior on every valid edge and no visits (exact ties),
    every 9th with an all-invalid root, every 7th with all-invalid rows
    below it, and every 11th with a NaN value sum on some visited edges
    (NaN wins the argmax, as in ``torch.argmax``)."""
    rng = np.random.default_rng(seed)
    shape = (B, Mx, A)

    def r():
        return rng.random(shape, dtype=np.float32)

    def ri(lo, hi, *s):
        return rng.integers(lo, hi, s or shape).astype(np.float32)
    st = np.zeros((B, Mx, 4, A + 2), np.float32)
    st[:, :, D.PVALID, :A] = np.where(r() < 0.3, -1.0, ri(0, 8) / 8)
    en = ri(0, 5) * (r() < 0.6)
    st[:, :, D.EN, :A] = en
    st[:, :, D.EW, :A] = en * ri(-2, 3) / 2
    sign = np.where(r() < 1 / 6, -1.0, 1.0).astype(np.float32)
    st[:, :, D.CHILD, :A] = ri(1, Mx) * (r() < p_child) * sign
    st[:, :, D.EN, A] = ri(0, 60, B, Mx)
    st[:, :, D.EW, A] = ri(-20, 21, B, Mx) / 4
    st[:, :, D.CHILD, A] = ri(0, 3, B, Mx)
    tie = st[1::5, :, D.PVALID, :A]
    st[1::5, :, D.PVALID, :A] = np.where(tie >= 0, 0.25, -1.0)
    st[1::5, :, D.EN, :A] = 0.0
    st[2::9, 0, D.PVALID, :A] = -1.0
    st[3::7, 1:, D.PVALID, :A] = -1.0
    nan = (r() < 0.05) & (en > 0)
    st[4::11, :, D.EW, :A][nan[4::11]] = np.nan
    return st


def _case(i):
    B, Mx, A, fpu, forced, cap, p_child, sim = CASES[i]
    kw = dict(cpuct=1.25, fpu=fpu, forced_playouts=forced, k_forced=0.5)
    return (JM.MCTSConfig(**kw), M.MCTSConfig(**kw),
            _tree(100 + i, B, Mx, A, p_child), sim, cap)


@pytest.mark.parametrize("A,nbytes", [(409, 15_312), (700, 24_624),
                                      (1600, 53_424)])
def test_smem_bytes(A, nbytes):
    """Two rows of 16 * (A + 2) bytes, 16 bytes of barriers, 96 of winners
    and 2,048 of column lists: 15,312 at the game's 409 actions, 24,624 at
    chip_smoke.py's 700-edge rows, and above the 48 KB usable without
    opting in at 1,600."""
    assert D.smem_bytes(A + 2) == nbytes
    assert nbytes % 16 == 0


def test_smem_bytes_raises_beyond_a_block():
    assert D.smem_bytes(7196) == 232_432 <= D.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        D.smem_bytes(7197)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_cpu_select_is_select_plain(i):
    """On CPU tensors ``select`` returns ``select_plain``'s outputs, values
    and dtypes, launches no kernel, and every board that does not stop
    earlier runs to the cap."""
    _, cfg, st, sim, cap = _case(i)
    stats = torch.from_numpy(st)
    before = D.select.launches
    got = D.select(cfg, stats, sim, cap, cap)
    want = D.select_plain(cfg, stats, sim, cap, cap)
    assert D.select.launches == before
    assert [t.dtype for t in got] == DTYPES
    for name, g, w in zip(OUTPUTS, got, want):
        assert torch.equal(g, w), name
    depth = got[3]
    assert int(depth.max()) == cap
    if cap > 1:
        assert int(depth.min()) < cap


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES) if c[5] > 0])
def test_made_up_trees_equal_jax_select(i):
    """The plain descent equals JAX's ``_select`` in all eight outputs on
    the made-up trees (a cap of 0 levels never reaches ``_select``: the
    JAX search's path buffer holds at least one level)."""
    jcfg, cfg, st, sim, cap = _case(i)
    B, Mx = st.shape[:2]
    tree = JM.Tree(states=jnp.zeros((B, Mx, 1, 7), jnp.int8),
                   stats=jnp.asarray(st),
                   parent=jnp.zeros((B, Mx), jnp.int32))
    z = jnp.zeros((B, cap), jnp.int32)
    jout = jax.jit(lambda t, s: JM._select(jcfg, t, s, z + Mx, z, z, cap))(
        tree, jnp.int32(sim))
    tout = D.select(cfg, torch.from_numpy(st), sim, cap, cap)
    for name, j, t in zip(OUTPUTS, jout, tout):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
