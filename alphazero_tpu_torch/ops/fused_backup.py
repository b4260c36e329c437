"""Fused MCTS backup: the CUDA kernels' wrappers and their plain versions.

Port of the Pallas kernel ``alphazero_tpu/ops/fused_backup.py::fused_backup``
(which the JAX search no longer calls) and of the packed-layout update of
``alphazero_tpu/search/mcts.py::_backprop_fused`` (which it does call, in
XLA).  One hand-written source, ``csrc/fused_backup.cu``, serves three
contracts; see that file for what bounds each and how it is laid out.

``fused_backup`` takes operands that the caller built.  In place, for each
board ``b``:

    stats[b, path_p[b,s], EN, path_a[b,s]] += w[b,s,0]   (levels s with
    stats[b, path_p[b,s], EW, path_a[b,s]] += w[b,s,1]    path_p < M)
    ... the same at column ``node_col`` when it is given (packed layout)
    stats[b, child_p[b], CHILD, child_a[b]] += child_v[b]  (if child_v != 0)
    stats[b, slot[b], PVALID, :] += row[b]                 (split: one lane)
    stats[b, slot[b], :, :]      += row[b]                 (packed: 4 lanes)

``backprop_packed`` takes the arguments of ``_backprop_fused``, the raw
outputs of descent, env step and evaluation, and does the same packed
update in one launch: the kernel builds the operands in registers.
``packed_operands`` builds them as tensors, and ``backprop_packed_plain``
is that followed by ``fused_backup_plain``.

``backprop_packed`` also takes bfloat16 stats (``MCTSConfig.stats_dtype =
"bfloat16"``), as the JAX update does: each element's float32 sum over the
levels, the child pointer and the expanded row are rounded to bf16 and then
added, each add rounded to bf16, the row's after the path's.  The operand
contract and the split stay float32, as the Pallas kernel is.

Each wrapper takes its plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.  ``fused_backup.launches`` counts every
kernel launch of any contract.  While a profiler records,
``backprop_packed`` (kernel or plain) also adds each board's live levels,
``min(depth, S1)``, and its child install to
``utils/profiling.py::path_counter``: the kernel with one atomic add per
board, in the launch it makes anyway.

Precondition, not checked on the card (it would cost a device sync): with a
node column, a live level's ``path_a`` and a fresh edge's action are edge
columns, never the node columns.  The kernel relies on it to keep a
level's loads ahead of its stores.  CPU tensors are checked.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import profiling
from . import _build

# lane indices of the stats array (same as the JAX search's)
PVALID, CHILD, EN, EW = 0, 1, 2, 3

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_OPERAND_ARGTYPES = [_PTR, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _INT,
                     _PTR, _PTR, _PTR, _PTR, _INT, _PTR, _PTR]
_ENTRY_ARGTYPES = [_PTR, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _INT, _PTR,
                   _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                   ctypes.c_longlong, _PTR, _PTR, _PTR]


@functools.lru_cache(maxsize=None)
def _kernels():
    """The library's launch functions (the operand contract, the entry on
    float32 stats and on bfloat16 stats), built and declared once."""
    lib = _build.load("fused_backup")
    operand = lib.fused_backup_launch
    entry = {torch.float32: lib.fused_backup_entry_launch,
             torch.bfloat16: lib.fused_backup_entry_bf16_launch}
    operand.argtypes, operand.restype = _OPERAND_ARGTYPES, ctypes.c_int
    for fn in entry.values():
        fn.argtypes, fn.restype = _ENTRY_ARGTYPES, ctypes.c_int
    return operand, entry


def _launch(fn, stats, *args):
    """Call a launch function on the current stream of ``stats``' device."""
    if stats.shape[0] == 0:
        return stats
    with torch.cuda.device(stats.device):
        err = fn(stats.data_ptr(), *args,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_backup kernel launch failed: CUDA error "
                           f"{err}")
    fused_backup.launches += 1
    return stats


def _check_stats(stats, dtypes=(torch.float32,)):
    if stats.dtype not in dtypes or stats.dim() != 4 or stats.shape[2] != 4:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"stats must be {names} [B, M, 4, C], got "
                         f"{tuple(stats.shape)} {stats.dtype}")
    if stats.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the backup runs on cuda or cpu tensors, not "
                         f"{stats.device}")
    if not stats.is_contiguous() or stats.data_ptr() % 16:
        raise ValueError("stats must be contiguous and 16-byte aligned")


def _check_tensors(stats, want):
    for t, shape, dtype, name in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != stats.device:
            raise ValueError(f"{name} is on {t.device}, stats on "
                             f"{stats.device}")


def _check_slot(stats, slot):
    """``slot`` must be int32 ``[B]`` on the stats' device; CPU tensors are
    also checked to lie in ``[0, M)``."""
    if not torch.is_tensor(slot):
        raise ValueError(f"slot must be an int32 [B] tensor, got "
                         f"{type(slot).__name__}")
    _check_tensors(stats, [(slot, (stats.shape[0],), torch.int32, "slot")])
    if stats.device.type == "cpu" and bool(
            ((slot < 0) | (slot >= stats.shape[1])).any()):
        raise ValueError(f"a slot lies outside [0, {stats.shape[1]})")


def _check(stats, path_p, path_a, w, child_p, child_a, child_v, row, slot,
           node_col):
    """Validate the operands; returns the row as ``[B, lanes, C]``."""
    _check_stats(stats)
    B, M, _, C = stats.shape
    S1 = path_p.shape[1] if path_p.dim() == 2 else -1
    if row.dim() == 2:
        row = row[:, None, :]
    if row.dim() != 3 or row.shape[1] not in (1, 4):
        raise ValueError(f"row must be [B, C], [B, 1, C] or [B, 4, C], got "
                         f"{tuple(row.shape)}")
    _check_slot(stats, slot)
    _check_tensors(stats, [
        (path_p, (B, S1), torch.int32, "path_p"),
        (path_a, (B, S1), torch.int32, "path_a"),
        (w, (B, S1, 2), torch.float32, "w"),
        (child_p, (B,), torch.int32, "child_p"),
        (child_a, (B,), torch.int32, "child_a"),
        (child_v, (B,), torch.float32, "child_v"),
        (row, (B, row.shape[1], C), torch.float32, "row")])
    for t, name in ((path_p, "path_p"), (path_a, "path_a"), (w, "w"),
                    (row, "row")):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if node_col is not None:
        if not 0 <= node_col < C:
            raise ValueError(f"node_col {node_col} outside [0, {C})")
        if stats.device.type == "cpu":
            live = (path_p >= 0) & (path_p < M)
            if bool((path_a[live] == node_col).any()):
                raise ValueError("a live level's path_a is the node column")
    return row


def fused_backup_plain(stats, path_p, path_a, w, child_p, child_a, child_v,
                       row, slot, node_col=None):
    """The same update in plain PyTorch.  It loops over levels with advanced
    indexing; within one level every board is a different index, so no
    index repeats inside one assignment, and repeated pairs across levels
    accumulate in level order."""
    row = _check(stats, path_p, path_a, w, child_p, child_a, child_v, row,
                 slot, node_col)
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
    slot     [B] int32 — the row's node per board
    node_col optional column that receives every level's weights too
    """
    if stats.device.type == "cpu":
        return fused_backup_plain(stats, path_p, path_a, w, child_p, child_a,
                                  child_v, row, slot, node_col)
    row = _check(stats, path_p, path_a, w, child_p, child_a, child_v, row,
                 slot, node_col)
    child_p, child_a, child_v, slot = (t.contiguous() for t in
                                       (child_p, child_a, child_v, slot))
    B, M, _, C = stats.shape
    return _launch(_kernels()[0], stats, B, M, C,
                   -1 if node_col is None else node_col, path_p.data_ptr(),
                   path_a.data_ptr(), w.data_ptr(), path_p.shape[1],
                   child_p.data_ptr(), child_a.data_ptr(), child_v.data_ptr(),
                   row.data_ptr(), row.shape[1], slot.data_ptr())


fused_backup.launches = 0


def packed_backup(stats, path_p, path_a, w, child_p, child_a, child_v, row,
                  slot):
    """The packed operand contract: ``stats [B, M, 4, A+2]`` whose node
    column ``A`` receives every level's weights, and the expanded node's
    full ``[B, 4, A+2]`` row."""
    return fused_backup(stats, path_p, path_a, w, child_p, child_a, child_v,
                        row, slot, node_col=stats.shape[3] - 2)


def _check_entry(stats, path_p, path_a, path_r, depth, value_vec, leaf_rot,
                 parent, action, fresh, slot, pvalid_new, child_term,
                 child_rot, leaf_init_v, term_vec):
    """Validate ``backprop_packed``'s arguments."""
    _check_stats(stats, (torch.float32, torch.bfloat16))
    B, M, _, C = stats.shape
    A = C - 2
    S1 = path_p.shape[1] if path_p.dim() == 2 else -1
    P = value_vec.shape[1] if value_vec.dim() == 2 else -1
    if A < 1 or not 1 <= P <= 4:
        raise ValueError(f"need stats [B, M, 4, A+2] and value_vec [B, P] "
                         f"with 1 <= P <= 4, got {tuple(stats.shape)} and "
                         f"{tuple(value_vec.shape)}")
    _check_tensors(stats, [
        (path_p, (B, S1), torch.int32, "path_p"),
        (path_a, (B, S1), torch.int32, "path_a"),
        (path_r, (B, S1), torch.int32, "path_r"),
        (depth, (B,), torch.int32, "depth"),
        (value_vec, (B, P), torch.float32, "value_vec"),
        (leaf_rot, (B,), torch.int64, "leaf_rot"),
        (parent, (B,), torch.int64, "parent"),
        (action, (B,), torch.int64, "action"),
        (fresh, (B,), torch.bool, "fresh"),
        (pvalid_new, (B, A), torch.float32, "pvalid_new"),
        (child_term, (B,), torch.bool, "child_term"),
        (child_rot, (B,), torch.int64, "child_rot"),
        (leaf_init_v, (B,), torch.float32, "leaf_init_v"),
        (term_vec, (B, P), torch.float32, "term_vec")])
    if stats.device.type == "cpu":
        live = ((torch.arange(S1)[None, :] < depth[:, None])
                & (path_p >= 0) & (path_p < M))
        if bool((path_a[live] >= A).any()) or bool((action[fresh] >= A).any()):
            raise ValueError(f"a live level's path_a or a fresh edge's "
                             f"action is not an edge column (< {A})")
    _check_slot(stats, slot)


def packed_operands(stats, path_p, path_a, path_r, depth, value_vec, leaf_rot,
                    parent, action, fresh, slot, pvalid_new, child_term,
                    child_rot, leaf_init_v, term_vec):
    """``backprop_packed``'s arguments turned into ``packed_backup``'s
    operands ``(path_p, path_a, w, child_p, child_a, child_v, row, slot)``
    with plain PyTorch ops."""
    B, _, _, C = stats.shape
    A, P = C - 2, value_vec.shape[1]
    mask = torch.arange(path_p.shape[1], device=stats.device)[None, :] \
        < depth[:, None]
    v_l = value_vec.gather(1, (path_r.long() - leaf_rot[:, None]) % P)
    w = torch.stack([mask.to(torch.float32), torch.where(mask, v_l, 0.0)], -1)
    child_v = (torch.where(fresh, slot.to(torch.float32), 0.0)
               * torch.where(child_term, -1.0, 1.0))
    row = torch.zeros((B, 4, C), dtype=torch.float32, device=stats.device)
    row[:, PVALID, :A] = pvalid_new + 1.0
    row[:, PVALID, A] = child_term.to(torch.float32)
    row[:, CHILD, A] = child_rot.to(torch.float32)
    row[:, EW, A] = leaf_init_v
    row[:, :P, A + 1] = term_vec
    return (path_p.contiguous(), path_a.contiguous(), w.contiguous(),
            parent.to(torch.int32), action.to(torch.int32), child_v, row, slot)


def backprop_packed_plain(stats, *args):
    """``backprop_packed`` in plain PyTorch: the operands as tensors, then
    ``fused_backup_plain``.  On bfloat16 stats, the JAX update's roundings:
    the path's and the child's float32 sums (``fused_backup_plain`` on a
    float32 zero tensor) rounded to bf16 and added to every element, then
    the expanded row rounded to bf16 and added to its slot."""
    _check_entry(stats, *args)
    path_p, path_a, w, child_p, child_a, child_v, row, slot = \
        packed_operands(stats, *args)
    ctr = profiling.path_counter(stats.device)
    if ctr is not None:
        levels = args[3].clamp(0, path_p.shape[1]).sum()
        ctr.add_(levels + ((child_v != 0).sum() << profiling.PATH_LEVEL_BITS))
    node_col = stats.shape[3] - 2
    if stats.dtype == torch.float32:
        return fused_backup_plain(stats, path_p, path_a, w, child_p, child_a,
                                  child_v, row, slot, node_col=node_col)
    delta = fused_backup_plain(
        torch.zeros(stats.shape, dtype=torch.float32, device=stats.device),
        path_p, path_a, w, child_p, child_a, child_v, torch.zeros_like(row),
        slot, node_col=node_col)
    stats.copy_(stats.float() + delta.to(stats.dtype).float())
    ar, sl = torch.arange(stats.shape[0], device=stats.device), slot.long()
    stats[ar, sl] = (stats[ar, sl].float()
                     + row.to(stats.dtype).float()).to(stats.dtype)
    return stats


def backprop_packed(stats, path_p, path_a, path_r, depth, value_vec, leaf_rot,
                    parent, action, fresh, slot, pvalid_new, child_term,
                    child_rot, leaf_init_v, term_vec):
    """Whole-path backup and node expansion of one simulation on the packed
    ``stats [B, M, 4, A+2]`` (float32 or bfloat16), in place: the JAX
    ``_backprop_fused`` as one kernel launch.  Returns ``stats``.

    path_p, path_a, path_r [B, S1] int32 and depth [B] int32: level
        ``l < depth[b]`` holds edge ``(path_p[l], path_a[l])``; the edge and
        its node's column ``A`` receive one visit and ``value_vec[(path_r[l]
        - leaf_rot) mod P]`` (``value_vec [B, P]`` is in the leaf's frame,
        so each ancestor reads the lane of its own mover seat)
    leaf_rot, parent, action, child_rot [B] int64; fresh, child_term [B]
        bool: a fresh edge ``(parent, action)`` gets the child pointer
        ``+slot``, or ``-slot`` when the child is terminal
    slot [B] int32: the node this simulation expands on each board.  Its row
        receives ``pvalid_new [B, A]`` stored as ``-1 + (p + 1)`` over the
        -1 initialization (the JAX update's arithmetic, so the stored bits
        agree), the terminal flag, ``child_rot``, ``leaf_init_v [B]`` and
        ``term_vec [B, P]`` in the node columns
    """
    args = (path_p, path_a, path_r, depth, value_vec, leaf_rot, parent,
            action, fresh, slot, pvalid_new, child_term, child_rot,
            leaf_init_v, term_vec)
    if stats.device.type == "cpu":
        return backprop_packed_plain(stats, *args)
    _check_entry(stats, *args)
    # no launch where a tensor is contiguous already; leaf_init_v is often a
    # column of the value tensor, so its stride goes along instead
    (path_p, path_a, path_r, depth, value_vec, leaf_rot, parent, action,
     fresh, slot, pvalid_new, child_term, child_rot, term_vec) = (
        t.contiguous() for t in (
            path_p, path_a, path_r, depth, value_vec, leaf_rot, parent,
            action, fresh, slot, pvalid_new, child_term, child_rot,
            term_vec))
    B, M, _, C = stats.shape
    ctr = profiling.path_counter(stats.device)
    return _launch(
        _kernels()[1][stats.dtype], stats, B, M, C, value_vec.shape[1],
        path_p.data_ptr(), path_a.data_ptr(), path_r.data_ptr(),
        path_p.shape[1],
        depth.data_ptr(), value_vec.data_ptr(), leaf_rot.data_ptr(),
        parent.data_ptr(), action.data_ptr(), fresh.data_ptr(),
        slot.data_ptr(), pvalid_new.data_ptr(), child_term.data_ptr(),
        child_rot.data_ptr(), leaf_init_v.data_ptr(), leaf_init_v.stride(0),
        term_vec.data_ptr(), None if ctr is None else ctr.data_ptr())
