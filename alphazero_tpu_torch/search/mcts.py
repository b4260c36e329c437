"""Batched array MCTS in PyTorch: fresh-tree and tree-reusing searches.

Port of ``build_search``, ``build_reusing_search`` and ``reroot`` of
``alphazero_tpu/search/mcts.py``.  The tree of each board lives in
fixed-shape tensors (``Tree``) with the JAX search's packed layout:
``stats [B, M, 4, A+2]`` float32, whose action columns ``0..A-1`` hold the
edge lanes (prior or -1 where invalid, sign-packed child pointer, edge
visits, edge value sum) and whose columns ``A`` and ``A+1`` hold the node
scalars (terminal flag, seat rotation, visit count, value sum; the
terminal value vector); ``states [B, M, R, 7]`` and ``parent [B, M]``.
One search core serves both: it runs on a tree whose board ``b`` holds
``n0[b]`` nodes (1 for a fresh root), and each simulation:

1. descends every board from its root with PUCT: one launch of the
   descent kernel (``ops/descent.py::select``), each board running until
   its path stops;
2. steps the chosen edge with the env and evaluates the leaf;
3. backs the value up the recorded path, installs the child pointer and
   writes the expanded node ``n0 + i``'s row: one launch of the
   fused-backup kernel (``ops/fused_backup.py::backprop_packed``) on every
   simulation, which takes the raw outputs of steps 1 and 2.

While a profiler records, the search's host time falls into leaf spans
(``utils/profiling.py::span``), one after another, never nested:
``mcts.root`` (entering the search: the tree, the root's mask,
evaluation, noise and row, the one host sync), then per simulation
``mcts.descent``, ``mcts.env_step``, ``mcts.evaluate`` (steps 1 and 2),
``mcts.store`` (the child's seat rotation, terminal flag and state stored
into the tree) and ``mcts.backup`` (the leaf frame and step 3), and last
``mcts.result`` (the root's counts, Q and pruning).  It counts
``mcts.searches``, ``mcts.board_sims`` (boards x simulations) and
``mcts.path_cells`` (those x the path buffer's width); the backup counts
the live path levels and installs.  ``reroot`` runs once per move:
gathers, one stable sort and scatters, no host read.

Results equal the JAX search's: the PUCT score keeps its float32
association, ties go to the lowest index, forced playouts read the sim
index of the call and policy-target pruning its sims.  The JAX search may
split a fresh search's sim loop into stages of growing capacity
(``stage_sims``); staged and unstaged searches return equal results, so
the port validates the schedule and runs one stage at full capacity.

Stats are float32, or bfloat16 with ``stats_dtype="bfloat16"`` under the
JAX search's guard: a fresh tree of capacity and sims at most 256, where
visit counts and child pointers are exact integers in bf16.  Both kernels
take bf16 stats and round where the JAX search rounds: the root row, the
backup's addends and adds (``ops/fused_backup.py``); everything read from
the tree is upcast to float32 first.  ``"auto"`` resolves to float32, as
the JAX rule does on any backend but a TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..ops.descent import select as _select
from ..ops.fused_backup import backprop_packed
from ..utils.device import resolve_device
from ..utils.profiling import count, span

EPS = 1e-8

# stats lanes; node-scalar columns A (flag/rotation/Ns/value) and A+1
_PVALID = 0   # prior where valid, -1 where invalid | node: terminal flag
_CHILD = 1    # +child id, -id if the child is terminal, 0 = unexpanded |
              # node: seat rotation from the root
_EN = 2       # edge visits | node: visit count Ns
_EW = 3       # edge value sum | node: value sum

@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    """The JAX search's configuration, field for field.  ``descent_unroll``
    changes how the JAX search runs, not what it returns: the port's descent
    has no unroll.  ``pallas_backup`` raises, as in the JAX search: the
    port's backup is always its own kernel."""
    num_sims: int = 100
    cpuct: float = 1.0
    fpu: float = 0.0                  # >0: parent-Q reduction; <=0: absolute
    forced_playouts: bool = False
    k_forced: float = 0.5
    dirichlet_alpha: float = 0.2
    dirichlet_frac: float = 0.25
    prior_temp: float = 1.0
    add_noise: bool = False
    max_depth: int = 0                # 0: no cap beyond the tree's capacity
    descent_unroll: int = 1
    pallas_backup: bool = False
    stats_dtype: str = "auto"         # "auto" | "float32" | "bfloat16"
    stage_sims: str = "auto"


class Tree(NamedTuple):
    """One tree per board; ``M`` = capacity = num_sims + keep_cap + 1."""
    states: torch.Tensor      # [B, M, R, 7] int8, canonical
    stats: torch.Tensor       # [B, M, 4, A+2] f32 or bf16, lanes as above
    parent: torch.Tensor      # [B, M] i32, parent node id (0 for the root)


class SearchResult(NamedTuple):
    counts: torch.Tensor      # [B, A] f32 — visit counts, pruned if forced
    raw_counts: torch.Tensor  # [B, A] i32
    q: torch.Tensor           # [B, P] f32 — root Q per seat
    root_value: torch.Tensor  # [B, P] f32 — NN value at the root
    root_prior: torch.Tensor  # [B, A] f32


class ReusingSearch(NamedTuple):
    """The tree-reusing search:

    init_tree(roots [B,R,7]) -> (Tree, n [B])            root-only trees
    run(params, tree, n, generator=None, noise_gamma=None)
        -> (SearchResult, tree, n + num_sims)            one search call
    reroot(tree, actions [B], next_states [B,R,7]) -> (Tree, n [B])
    """
    init_tree: Callable
    run: Callable
    reroot: Callable
    capacity: int


# eval_fn(params, states [B,R,7] int8, valids [B,A]) -> (probs, values [B,P])
EvalFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]
# step_fn(states [B,R,7], actions [B]) ->
#   (canonical child states, term_vec [B,P], valid [B,A], seat advance [B])
StepFn = Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]]


def _resolve_stage_schedule(cfg: MCTSConfig):
    """Parse ``cfg.stage_sims`` like the JAX search (same errors); the port
    runs every schedule as one stage, which gives the same results."""
    spec = str(cfg.stage_sims or "off").strip().lower()
    if spec == "off":
        return None
    if spec == "auto":
        S = cfg.num_sims
        if S < 64:
            return None
        sched, done, step = [], 0, 16
        while done + step < S:
            sched.append(step)
            done += step
            if len(sched) >= 2:
                step *= 2
        sched.append(S - done)
        return tuple(sched)
    parts = tuple(int(x) for x in spec.split(","))
    if any(p <= 0 for p in parts) or sum(parts) != cfg.num_sims:
        raise ValueError(
            f"stage_sims={spec!r}: entries must be positive and sum to "
            f"num_sims={cfg.num_sims}")
    return parts if len(parts) > 1 else None


def _normalize_masked(p, valid):
    p = torch.where(valid, p, 0.0)
    return p / p.sum(-1, keepdim=True).clamp(min=EPS)


def stats_dtype(cfg: MCTSConfig, keep_cap: int) -> torch.dtype:
    """The dtype of the tree stats, resolved as the JAX search resolves
    ``cfg.stats_dtype`` for a tree of capacity ``num_sims + keep_cap + 1``
    (``keep_cap > 0``: a carried tree): ``"auto"`` is float32, which the
    JAX rule picks on any backend but a TPU, and ``"bfloat16"`` raises the
    JAX search's ``ValueError`` where counts or pointers could pass 256."""
    S = cfg.num_sims
    M = S + keep_cap + 1
    names = {"auto": torch.float32, "float32": torch.float32,
             "bfloat16": torch.bfloat16}
    if cfg.stats_dtype not in names:
        raise ValueError(f"stats_dtype={cfg.stats_dtype!r}: one of "
                         f"{sorted(names)}")
    sdt = names[cfg.stats_dtype]
    if sdt == torch.bfloat16 and (M > 256 or S > 256 or keep_cap > 0):
        raise ValueError(
            f"stats_dtype=bfloat16 stores visit counts and the sign-packed "
            f"child pointers exactly only up to 256 on a FRESH tree, but "
            f"tree capacity is {M} (num_sims={S}, keep_cap={keep_cap}); "
            f"use float32 (reuse trees accumulate root Ns past 256, where "
            f"bf16 +1 increments vanish)")
    return sdt


def _build_core(cfg: MCTSConfig, num_players: int, eval_fn: EvalFn,
                step_fn: StepFn, valid_fn, keep_cap: int, dev: torch.device):
    """The search over a caller's tree with per-board node counts ``n0``
    (1: a fresh root-only tree).  Returns ``(init_tree, run, search, M)``
    with capacity ``M = num_sims + keep_cap + 1``: ``search`` runs on fresh
    root-only trees."""
    sdt = stats_dtype(cfg, keep_cap)
    if cfg.pallas_backup:
        raise NotImplementedError(
            "pallas_backup=True: the JAX search raises here (its Pallas "
            "kernel targets the split stats layout); the port's backup is "
            "always ops/fused_backup.py::backprop_packed")
    S = cfg.num_sims
    M = S + keep_cap + 1
    P = num_players
    PL = min(M - 1, cfg.max_depth) if cfg.max_depth > 0 else M - 1

    def init_tree(roots):
        """Root-only trees for ``roots [B, R, 7]``: ``(Tree, n0 = ones(B))``."""
        roots = roots.to(dev)
        B, R, C = roots.shape
        A = valid_fn(roots[:1]).shape[1]
        stats = torch.zeros((B, M, 4, A + 2), dtype=sdt, device=dev)
        stats[:, :, _PVALID, :A] = -1.0
        states = torch.zeros((B, M, R, C), dtype=torch.int8, device=dev)
        states[:, 0] = roots
        return (Tree(states, stats,
                     torch.zeros((B, M), dtype=torch.int32, device=dev)),
                torch.ones(B, dtype=torch.int32, device=dev))

    def run(params, tree, n0, generator=None, noise_gamma=None):
        """``num_sims`` simulations on ``tree`` (updated in place); returns
        ``(SearchResult, tree, n0 + num_sims)``.  With ``add_noise``,
        ``noise_gamma [B, A]`` replaces the Gamma(alpha) draws of the
        Dirichlet noise; without it they come from ``generator``."""
        return simulate(params, lambda: (tree, n0), generator, noise_gamma)

    def search(params, roots, generator=None, noise_gamma=None):
        """``run`` on root-only trees for ``roots``; the ``SearchResult``."""
        return simulate(params, lambda: init_tree(roots), generator,
                        noise_gamma)[0]

    def simulate(params, make_tree, generator, noise_gamma):
        """``run`` on the tree and node counts ``make_tree()`` returns,
        which counts as the search's root time."""
        with span("mcts.root"):
            tree, n0 = make_tree()
            states, stats, parent_ids = tree
            B = states.shape[0]
            ar = torch.arange(B, device=dev)
            roots = states[:, 0]
            root_valid = valid_fn(roots)                          # [B, A]
            A = root_valid.shape[1]
            pi0, v0 = eval_fn(params, roots, root_valid)
            pi0 = _normalize_masked(pi0, root_valid)
            if cfg.add_noise:
                if cfg.prior_temp != 1.0:
                    pi0 = _normalize_masked(pi0 ** (1.0 / cfg.prior_temp),
                                            root_valid)
                if noise_gamma is None:
                    alpha = torch.full((B, A), cfg.dirichlet_alpha,
                                       dtype=torch.float32, device=dev)
                    noise_gamma = torch._standard_gamma(alpha,
                                                        generator=generator)
                noise = _normalize_masked(noise_gamma.to(dev), root_valid)
                pi0 = _normalize_masked((1.0 - cfg.dirichlet_frac) * pi0
                                        + cfg.dirichlet_frac * noise,
                                        root_valid)

            # the root's prior row is rewritten on every call; a carried
            # root keeps its visit count, value sum and edge stats, a fresh
            # one starts from the net's value (each stored in the stats'
            # dtype)
            carried = n0 > 1
            stats[:, 0, _PVALID, :A] = torch.where(root_valid, pi0, -1.0)
            stats[:, 0, _EN, A] = torch.where(carried, stats[:, 0, _EN, A],
                                              0.0)
            stats[:, 0, _EW, A] = torch.where(carried, stats[:, 0, _EW, A],
                                              v0[:, 0])
            # board b holds n0[b] + i nodes before sim i and a path never
            # revisits a node, so the largest count bounds every descent
            # (the plain descent's loop bound; the kernel's boards run
            # until they stop)
            n_max = int(n0.max())
            # row i: the node sim i expands on each board, n0 + i (made
            # once, so a sim takes its row as a view and launches nothing
            # for it)
            slots = n0[None, :] + torch.arange(S, dtype=torch.int32,
                                               device=dev)[:, None]
            slots_l = slots.long()
            count("mcts.searches")
            count("mcts.board_sims", B * S)
            count("mcts.path_cells", B * S * PL)

        for i in range(S):
            with span("mcts.descent"):
                (parent, action, existing, depth, parent_rot, path_p, path_a,
                 path_r) = _select(cfg, stats, i, PL, min(n_max + i, PL))
            with span("mcts.env_step"):
                child_state, term_vec, child_valid, adv = step_fn(
                    states[ar, parent], action)
            with span("mcts.evaluate"):
                probs, values = eval_fn(params, child_state, child_valid)
                probs = _normalize_masked(probs, child_valid)
            with span("mcts.store"):
                fresh = existing == 0
                slot = slots[i]
                child_rot = (parent_rot + adv) % P
                child_term = term_vec.abs().sum(-1) > 0
                # written on a revisit too, as an unreferenced dead slot;
                # only reroot reads parent ids, so a fresh search's tree
                # skips them
                states[ar, slots_l[i]] = child_state
                if keep_cap:
                    parent_ids[ar, slots_l[i]] = parent.to(torch.int32)

            with span("mcts.backup"):
                # leaf frame: a revisited leaf's scalars come from its row
                leaf = stats[ar, existing, :, A:].float()         # [B, 4, 2]
                leaf_term = torch.where(fresh, child_term,
                                        leaf[:, _PVALID, 0] > 0)
                leaf_rot = torch.where(fresh, child_rot,
                                       leaf[:, _CHILD, 0].long())
                leaf_tv = torch.where(fresh[:, None], term_vec,
                                      leaf[:, :P, 1])
                value_vec = torch.where(leaf_term[:, None], leaf_tv, values)
                backprop_packed(stats, path_p, path_a, path_r, depth,
                                value_vec, leaf_rot, parent, action, fresh,
                                slot, torch.where(child_valid, probs, -1.0),
                                child_term, child_rot, values[:, 0],
                                term_vec)

        with span("mcts.result"):
            root = stats[:, 0].float()                    # [B, 4, A+2]
            counts = root[:, _EN, :A].to(torch.int32)
            root_prior = root[:, _PVALID, :A].clamp(min=0.0)
            qs = root[:, _EW, A] / (root[:, _EN, A] + 1.0)
            q = torch.cat([qs[:, None],
                           (-qs / (P - 1))[:, None].expand(B, P - 1)], 1)
            out_counts = counts.to(torch.float32)
            if cfg.forced_playouts:
                # policy target pruning over this call's sims
                best = counts.max(1, keepdim=True).values
                pruned = counts - torch.floor(torch.sqrt(
                    cfg.k_forced * root_prior * S)).to(torch.int32)
                adj = torch.where(counts == best, counts, pruned)
                out_counts = torch.where(adj > 1, adj, 0).to(torch.float32)
                total = out_counts.sum(-1, keepdim=True)
                out_counts = torch.where(total > 0, out_counts,
                                         counts.to(torch.float32))
            result = SearchResult(counts=out_counts, raw_counts=counts, q=q,
                                  root_value=v0, root_prior=root_prior)
            return result, tree, n0 + S

    return init_tree, run, search, M


def build_search(mcts_cfg: MCTSConfig, num_players: int, eval_fn: EvalFn,
                 step_fn: StepFn, valid_fn, device="cuda"):
    """Returns ``search(params, roots [B,R,7] int8, generator=None,
    noise_gamma=None) -> SearchResult`` — a fresh tree per call.

    ``eval_fn(params, states, valids)`` returns normalized masked policy
    probabilities and per-seat values in the state's own frame.  With
    ``add_noise``, ``noise_gamma [B, A]`` replaces the Gamma(alpha) draws
    of the Dirichlet noise (the JAX search draws them with
    ``jax.random.gamma``); without it they come from ``generator``."""
    _resolve_stage_schedule(mcts_cfg)
    return _build_core(mcts_cfg, num_players, eval_fn, step_fn, valid_fn, 0,
                       resolve_device(device))[2]


def build_reusing_search(mcts_cfg: MCTSConfig, num_players: int,
                         eval_fn: EvalFn, step_fn: StepFn, valid_fn,
                         keep_cap: int = 0, device="cuda") -> ReusingSearch:
    """The tree-reusing search: ``run`` searches from a carried tree and
    ``reroot`` re-roots it on the played action.  ``keep_cap`` bounds the
    carried subtree (``<= 0``: ``num_sims``); the capacity is ``num_sims +
    keep_cap + 1``.  Stage schedules do not apply: a carried tree runs at
    full capacity."""
    dev = resolve_device(device)
    if keep_cap <= 0:
        keep_cap = mcts_cfg.num_sims
    init_tree, run, _, M = _build_core(mcts_cfg, num_players, eval_fn,
                                       step_fn, valid_fn, keep_cap, dev)
    P = num_players
    KMAX = keep_cap + 1          # kept nodes, the new root included

    def reroot(tree, actions, next_states):
        """Re-root every board on ``(root, actions [B])`` and compact the
        kept subtree to the buffer's head; returns ``(Tree, n_kept [B])``.
        A board keeps its subtree only when the played edge has an
        expanded, non-terminal child whose stored state equals the real
        ``next_states`` (the chance draws matched the search's collapse);
        otherwise it restarts from a fresh root.  It runs on the tree's
        device and reads no value back to the host."""
        states, stats, parent = tree
        B, Mc, _, A2 = stats.shape
        A = A2 - 2
        dev = stats.device
        ar = torch.arange(B, device=dev)
        ar_m = torch.arange(Mc, device=dev)[None, :]
        next_states = next_states.to(dev)
        c_raw = stats[:, 0, _CHILD, :A].gather(
            1, actions.to(dev).long()[:, None])[:, 0]
        c_star = c_raw.abs().long()
        match = (states[ar, c_star] == next_states).reshape(B, -1).all(-1)
        valid = (c_star > 0) & match & ~(c_raw < 0.0)   # sign: terminal

        # reachability from c_star by parent-pointer doubling; c_star and
        # the root absorb, so anc == c_star exactly on c_star's subtree
        anc = torch.where(ar_m == c_star[:, None], c_star[:, None],
                          parent.long())
        for _ in range(max(Mc - 1, 1).bit_length()):
            anc = anc.gather(1, anc)
        keep = (anc == c_star[:, None]) & valid[:, None]           # [B, M]

        # c_star first, then kept nodes by visit count, then the rest; the
        # stable sort keeps allocation order on ties, so an ancestor always
        # precedes its descendants and truncation orphans no node
        n_i = stats[:, :, _EN, A].clamp(max=2.0 ** 28).to(torch.int32)
        key = ((ar_m == c_star[:, None]).to(torch.int32) * (1 << 30)
               + keep.to(torch.int32) * (1 << 29) + n_i)
        order = torch.argsort(-key, dim=1, stable=True)             # [B, M]
        rank = torch.empty_like(order).scatter_(1, order,
                                                ar_m.expand(B, Mc))
        n_kept = torch.where(valid, keep.sum(1).clamp(max=KMAX), 1)
        keep_fin = keep & (rank < n_kept[:, None])
        new_id = torch.where(keep_fin, rank, 0)

        # child pointers (keeping the sign-packed terminal flag) and parent
        # ids remapped in the old layout, seat rotations rebased on c_star
        child_f = stats[:, :, _CHILD, :A]
        flat = child_f.abs().long().reshape(B, Mc * A)
        child_new = torch.where(
            (flat > 0) & keep_fin.gather(1, flat),
            new_id.gather(1, flat).to(torch.float32)
            * torch.where(child_f < 0, -1.0, 1.0).reshape(B, Mc * A),
            0.0).reshape(B, Mc, A)
        par = parent.long()
        par_new = torch.where(keep_fin.gather(1, par), new_id.gather(1, par),
                              0)
        rot_new = torch.remainder(
            stats[:, :, _CHILD, A] - stats[ar, c_star, _CHILD, A][:, None], P)

        # rows gathered into the new order; rows past n_kept and boards
        # without reuse are blank
        live = (ar_m < n_kept[:, None]) & valid[:, None]            # [B, M]
        rows = ar[:, None], order
        new_stats = stats[rows]
        new_stats[:, :, _CHILD, :A] = child_new[rows]
        new_stats[:, :, _CHILD, A] = rot_new.gather(1, order)
        empty = torch.zeros((4, A2), dtype=stats.dtype, device=dev)
        empty[_PVALID, :A] = -1.0
        new_stats = torch.where(live[:, :, None, None], new_stats, empty)
        new_states = torch.where(live[:, :, None, None], states[rows], 0)
        new_states[:, 0] = next_states
        new_parent = torch.where(live, par_new.gather(1, order), 0)
        return (Tree(new_states, new_stats, new_parent.to(torch.int32)),
                n_kept.to(torch.int32))

    return ReusingSearch(init_tree=init_tree, run=run, reroot=reroot,
                         capacity=M)
