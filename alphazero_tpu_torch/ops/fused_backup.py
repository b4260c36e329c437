"""Fused MCTS backup: the CUDA kernel's wrapper and its plain version.

Port of the Pallas kernel ``alphazero_tpu/ops/fused_backup.py::fused_backup``
(which the JAX search no longer calls) and of the packed-layout update of
``alphazero_tpu/search/mcts.py::_backprop_fused`` (which it does call, in
XLA).  One hand-written kernel, ``csrc/fused_backup.cu``, serves both
contracts; see that file for what it computes, what bounds it and how it
is laid out.  In place, for each board ``b``:

    stats[b, path_p[b,s], EN, path_a[b,s]] += w[b,s,0]   (levels s with
    stats[b, path_p[b,s], EW, path_a[b,s]] += w[b,s,1]    path_p < M)
    ... the same at column ``node_col`` when it is given (packed layout)
    stats[b, child_p[b], CHILD, child_a[b]] += child_v[b]  (if child_v != 0)
    stats[b, slot[b], PVALID, :] += row[b]                 (split: one lane)
    stats[b, slot[b], :, :]      += row[b]                 (packed: 4 lanes)

``fused_backup`` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  ``fused_backup.launches`` counts
the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# lane indices of the stats array (same as the JAX search's)
PVALID, CHILD, EN, EW = 0, 1, 2, 3

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _check(stats, path_p, path_a, w, child_p, child_a, child_v, row, slot,
           node_col):
    """Validate the operands; returns ``(row [B, lanes, C], slot [B])``."""
    if stats.dtype != torch.float32 or stats.dim() != 4 or stats.shape[2] != 4:
        raise ValueError(f"stats must be float32 [B, M, 4, C], got "
                         f"{tuple(stats.shape)} {stats.dtype}")
    B, M, _, C = stats.shape
    S1 = path_p.shape[1] if path_p.dim() == 2 else -1
    want = [(path_p, (B, S1), torch.int32, "path_p"),
            (path_a, (B, S1), torch.int32, "path_a"),
            (w, (B, S1, 2), torch.float32, "w"),
            (child_p, (B,), torch.int32, "child_p"),
            (child_a, (B,), torch.int32, "child_a"),
            (child_v, (B,), torch.float32, "child_v")]
    if row.dim() == 2:
        row = row[:, None, :]
    want.append((row, (B, row.shape[1], C), torch.float32, "row"))
    if row.shape[1] not in (1, 4):
        raise ValueError(f"row must be [B, C], [B, 1, C] or [B, 4, C], got "
                         f"{tuple(row.shape)}")
    if isinstance(slot, int):
        slot = torch.full((B,), slot, dtype=torch.int32, device=stats.device)
    want.append((slot, (B,), torch.int32, "slot"))
    for t, shape, dtype, name in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != stats.device:
            raise ValueError(f"{name} is on {t.device}, stats on "
                             f"{stats.device}")
    for t, name in ((stats, "stats"), (path_p, "path_p"), (path_a, "path_a"),
                    (w, "w"), (row, "row")):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if node_col is not None and not 0 <= node_col < C:
        raise ValueError(f"node_col {node_col} outside [0, {C})")
    return row, slot


def fused_backup_plain(stats, path_p, path_a, w, child_p, child_a, child_v,
                       row, slot, node_col=None):
    """The same update in plain PyTorch.  It loops over levels with advanced
    indexing; within one level every board is a different index, so no
    index repeats inside one assignment, and repeated pairs across levels
    accumulate in level order."""
    row, slot = _check(stats, path_p, path_a, w, child_p, child_a, child_v,
                       row, slot, node_col)
    M = stats.shape[1]
    ar = torch.arange(stats.shape[0], device=stats.device)
    for s in range(path_p.shape[1]):
        p, a = path_p[:, s].long(), path_a[:, s].long()
        keep = (p >= 0) & (p < M)
        b, p, a = ar[keep], p[keep], a[keep]
        w_en, w_ew = w[keep, s, 0], w[keep, s, 1]
        stats[b, p, EN, a] += w_en
        stats[b, p, EW, a] += w_ew
        if node_col is not None:
            stats[b, p, EN, node_col] += w_en
            stats[b, p, EW, node_col] += w_ew
    inst = child_v != 0
    b = ar[inst]
    stats[b, child_p[inst].long(), CHILD, child_a[inst].long()] += child_v[inst]
    if row.shape[1] == 1:
        stats[ar, slot.long(), PVALID] += row[:, 0]
    else:
        stats[ar, slot.long()] += row
    return stats


def fused_backup(stats, path_p, path_a, w, child_p, child_a, child_v, row,
                 slot, node_col=None):
    """Apply the backup to ``stats`` in place and return it.

    stats    [B, M, 4, C] float32
    path_p   [B, S1] int32 — node per level, M = drop sentinel
    path_a   [B, S1] int32 — action per level
    w        [B, S1, 2] float32 — (EN increment, EW value) per level
    child_p, child_a [B] int32, child_v [B] float32 — child install
             (child_v == 0: none)
    row      [B, C] or [B, 1, C] (lane PVALID) or [B, 4, C] (all lanes)
    slot     int or [B] int32 — the row's node per board
    node_col optional column that receives every level's weights too
    """
    if stats.device.type == "cpu":
        return fused_backup_plain(stats, path_p, path_a, w, child_p, child_a,
                                  child_v, row, slot, node_col)
    if stats.device.type != "cuda":
        raise ValueError(f"fused_backup runs on cuda or cpu tensors, not "
                         f"{stats.device}")
    row, slot = _check(stats, path_p, path_a, w, child_p, child_a, child_v,
                       row, slot, node_col)
    child_p, child_a, child_v, slot = (t.contiguous() for t in
                                       (child_p, child_a, child_v, slot))
    lib = _build.load("fused_backup")
    fn = lib.fused_backup_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    B, M, _, C = stats.shape
    with torch.cuda.device(stats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(stats.data_ptr(), B, M, C, -1 if node_col is None else
                 node_col, path_p.data_ptr(), path_a.data_ptr(), w.data_ptr(),
                 path_p.shape[1], child_p.data_ptr(), child_a.data_ptr(),
                 child_v.data_ptr(), row.data_ptr(), row.shape[1],
                 slot.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_backup kernel launch failed: CUDA error "
                           f"{err}")
    fused_backup.launches += 1
    return stats


fused_backup.launches = 0


def packed_backup(stats, path_p, path_a, w, child_p, child_a, child_v, row,
                  slot):
    """The search's contract: packed ``stats [B, M, 4, A+2]`` whose node
    column ``A`` receives every level's weights, and the expanded node's
    full ``[B, 4, A+2]`` row."""
    return fused_backup(stats, path_p, path_a, w, child_p, child_a, child_v,
                        row, slot, node_col=stats.shape[3] - 2)
