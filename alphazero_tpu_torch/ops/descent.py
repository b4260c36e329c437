"""PUCT descent of the batched search: the CUDA kernel's wrapper and its
plain version.

Port of ``alphazero_tpu/search/mcts.py::_select`` with ``_ucb_pick_rows``,
which the JAX search runs in XLA (it was never a Pallas kernel).  Every
simulation of every search walks each board from its root: read the node
row of ``stats [B, M, 4, A+2]``, take the PUCT argmax with FPU (and the
root's forced playouts), record the edge, and follow the child pointer
until an unexpanded edge, a terminal child or the depth cap.

``select`` takes the plain version, ``select_plain``, for CPU tensors; for
CUDA tensors it launches ``csrc/descent.cu`` (one block of four warps per
board, each running until its path stops, each level's node row brought
whole into shared memory by one TMA bulk copy) or raises.
``select.launches`` counts the kernel's launches.

Stats are float32 or bfloat16 (``MCTSConfig.stats_dtype``); like the JAX
descent, both versions upcast each node row to float32 before any
arithmetic, so a bf16 tree is scored as the float32 tree of its values.

Precondition, not checked on the card (it would cost a device sync): every
child pointer ``|stats[b, n, CHILD, a]|`` lies in ``[0, M)``.  On the CPU an
index outside raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# lane indices of the stats array (same as the JAX search's); the node
# scalars live in column A: terminal flag, seat rotation, visit count and
# value sum
PVALID, CHILD, EN, EW = 0, 1, 2, 3
EPS = 1e-8

# the plain descent checks for "every board stopped" (a host sync) only this
# often
_STOP_CHECK_LEVELS = 8

STATS_DTYPES = (torch.float32, torch.bfloat16)

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_PTR, _INT, _INT, _INT, _INT, _FLOAT, _FLOAT, _INT, _INT, _FLOAT,
             _FLOAT, _PTR, _PTR, _PTR, _INT, _PTR]

# shared memory a block of the kernel may use on Hopper (227 KB), and what
# it lays out after its two node rows: two mbarriers (8 bytes each), two
# sets of four warps' winners (key, column and first forced column, 4 bytes
# each) and four warps' column lists of 128 int32
SMEM_LIMIT = 232_448
_SMEM_TAIL = 2 * 8 + 2 * 4 * 3 * 4 + 4 * 128 * 4


def row_buf_bytes(C: int, elem: int = 4) -> int:
    """Shared memory one node row of ``C`` columns takes in the kernel: a
    float32 row (``elem`` 4) is ``16 * C`` bytes, copied whole; a bfloat16
    row (``elem`` 2) is copied from the 16-byte boundary at or below its
    start, ``8 * C + 8`` bytes at most, rounded up to 16."""
    return 16 * C if elem == 4 else (8 * C + 8 + 15) // 16 * 16


def smem_bytes(C: int, elem: int = 4) -> int:
    """Dynamic shared memory of one kernel block for rows of ``C = A + 2``
    columns of ``elem``-byte elements: two node row buffers (one per level
    parity), then the barriers, the warps' winners and their column lists.
    Raises where a block cannot hold it."""
    n = 2 * row_buf_bytes(C, elem) + _SMEM_TAIL
    if n > SMEM_LIMIT:
        raise ValueError(f"rows of {C} columns need {n} bytes of shared "
                         f"memory per block; a block may use {SMEM_LIMIT}")
    return n


def _ucb_pick_rows(cfg, prior_r, valid_r, en_r, ew_r, ns, qs, sim_idx: int,
                   is_root):
    """PUCT over per-node rows [B, A], in the JAX search's float32 order."""
    A = prior_r.shape[-1]
    visited = en_r > 0
    q_a = ew_r / en_r.clamp(min=1.0)
    fpu_init = (qs - cfg.fpu if cfg.fpu > 0
                else torch.full_like(qs, cfg.fpu))[:, None]
    ns_f = ns[:, None]
    cp = cfg.cpuct * prior_r
    u = torch.where(visited,
                    q_a + cp * torch.sqrt(ns_f) / (1.0 + en_r),
                    fpu_init + cp * torch.sqrt(ns_f + EPS))
    u = torch.where(valid_r, u, -torch.inf)
    best = torch.argmax(u, -1)                      # first maximum

    if cfg.forced_playouts:
        thresh = torch.floor(torch.sqrt(cfg.k_forced * prior_r
                                        * float(sim_idx)))
        force = valid_r & (en_r < thresh) & is_root[:, None]
        idx = torch.arange(A, device=prior_r.device)[None, :]
        first_forced = torch.where(force, idx, A).min(-1).values
        best = torch.where(force.any(-1), first_forced, best)
    return best


def select_plain(cfg, stats, sim_idx: int, depth_cap: int, levels: int):
    """Batched descent with path recording, in plain PyTorch.

    Returns ``(parent, action, existing, depth, parent_rot, path_p, path_a,
    path_r)`` exactly as the JAX ``_select`` does.  The JAX loop runs every
    board in lockstep until all have stopped; a stopped board records only
    drop sentinels, which are also the buffers' initial values, so running
    fewer levels gives the same outputs as long as every board stops.
    ``levels`` is that bound: a tree of ``n`` nodes has no path longer than
    ``n`` levels, so ``min(n, depth_cap)`` levels for the largest ``n`` of
    the batch suffice; boards that stop earlier are masked, and the loop
    ends early when all have stopped (checked every few levels).  The
    kernel needs no bound: each of its boards runs until it stops, which is
    within ``min(n, depth_cap)`` levels, so both give the same outputs."""
    B, M, _, A2 = stats.shape
    A = A2 - 2
    dev = stats.device
    ar = torch.arange(B, device=dev)
    path_p = torch.full((B, depth_cap), M, dtype=torch.int32, device=dev)
    path_a = torch.zeros((B, depth_cap), dtype=torch.int32, device=dev)
    path_r = torch.zeros((B, depth_cap), dtype=torch.int32, device=dev)
    zeros = torch.zeros(B, dtype=torch.long, device=dev)
    node, parent, action, existing, prot = (zeros.clone() for _ in range(5))
    depth = torch.zeros(B, dtype=torch.int32, device=dev)
    stop = torch.zeros(B, dtype=torch.bool, device=dev)

    for level in range(levels):
        if level and level % _STOP_CHECK_LEVELS == 0 and bool(stop.all()):
            break
        row = stats[ar, node].to(torch.float32)               # [B, 4, A+2]
        pv = row[:, PVALID, :A]
        nn_ = row[:, EN, A]
        rot = row[:, CHILD, A].long()
        qs = row[:, EW, A] / (nn_ + 1.0)
        a = _ucb_pick_rows(cfg, pv.clamp(min=0.0), pv >= 0.0, row[:, EN, :A],
                           row[:, EW, :A], nn_, qs, sim_idx, node == 0)
        # the sign-packed pointer gives the child and its terminal flag
        child_raw = row[:, CHILD, :A].gather(1, a[:, None])[:, 0]
        child = child_raw.abs().long()
        now_stop = (child == 0) | (child_raw < 0.0) | (level >= depth_cap - 1)

        path_p[:, level] = torch.where(stop, M, node)
        path_a[:, level] = torch.where(stop, 0, a)
        path_r[:, level] = torch.where(stop, 0, rot)
        depth += (~stop).to(torch.int32)
        parent = torch.where(stop, parent, node)
        action = torch.where(stop, action, a)
        existing = torch.where(stop, existing, child)
        prot = torch.where(stop, prot, rot)
        node = torch.where(stop | now_stop, node, child)
        stop = stop | now_stop
    return parent, action, existing, depth, prot, path_p, path_a, path_r


@functools.lru_cache(maxsize=None)
def _launch(dtype: torch.dtype):
    """The library's launch function for ``dtype`` stats, built and
    declared once."""
    lib = _build.load("descent")
    launch = (lib.descent_launch if dtype == torch.float32
              else lib.descent_bf16_launch)
    launch.argtypes, launch.restype = _ARGTYPES, ctypes.c_int
    return launch


def _check(stats, depth_cap):
    if (stats.dtype not in STATS_DTYPES or stats.dim() != 4
            or stats.shape[2] != 4):
        raise ValueError(f"stats must be float32 or bfloat16 [B, M, 4, A+2], "
                         f"got {tuple(stats.shape)} {stats.dtype}")
    if stats.shape[3] < 3:
        raise ValueError(f"stats need at least one action column, got "
                         f"{tuple(stats.shape)}")
    if stats.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the descent runs on cuda or cpu tensors, not "
                         f"{stats.device}")
    if not stats.is_contiguous():
        raise ValueError("stats must be contiguous")
    if depth_cap < 0:
        raise ValueError(f"depth_cap must be >= 0, got {depth_cap}")


def select(cfg, stats, sim_idx: int, depth_cap: int, levels: int):
    """One descent of every board of ``stats [B, M, 4, A+2]`` (float32 or
    bfloat16) for simulation ``sim_idx`` (forced playouts read it) with a
    path buffer of ``depth_cap`` levels.  Returns ``(parent, action,
    existing, depth, parent_rot, path_p, path_a, path_r)``: int64 ``[B]``
    but ``depth``, int32 ``[B]``, and the paths int32 ``[B, depth_cap]``;
    the outputs of ``select_plain``, which takes ``levels`` as its loop
    bound.  On CUDA tensors one kernel launch computes them and ``levels``
    is not read."""
    _check(stats, depth_cap)
    if stats.device.type == "cpu":
        return select_plain(cfg, stats, sim_idx, depth_cap, levels)
    B, M, _, C = stats.shape
    smem = smem_bytes(C, stats.element_size())
    if stats.data_ptr() % 16:
        raise ValueError("stats must be 16-byte aligned on the card (the "
                         "kernel copies node rows with TMA from 16-byte "
                         "boundaries)")
    dev = stats.device
    out64 = torch.empty((4, B), dtype=torch.int64, device=dev)
    depth = torch.empty(B, dtype=torch.int32, device=dev)
    paths = torch.empty((3, B, depth_cap), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            err = _launch(stats.dtype)(
                stats.data_ptr(), B, M, C, depth_cap, float(cfg.cpuct),
                float(cfg.fpu), int(cfg.fpu > 0),
                int(bool(cfg.forced_playouts)),
                float(cfg.k_forced), float(sim_idx), out64.data_ptr(),
                depth.data_ptr(), paths.data_ptr(), smem,
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"descent kernel launch failed: CUDA error "
                               f"{err}")
        select.launches += 1
    parent, action, existing, prot = out64
    return parent, action, existing, depth, prot, paths[0], paths[1], paths[2]


select.launches = 0

