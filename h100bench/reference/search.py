"""Batched fresh-tree MCTS in plain PyTorch, float32: the reference that
the program's search is held to.

Each board's tree lives in ``stats [B, M, 4, A+2]`` (lanes: prior or -1
where invalid, sign-packed child pointer, edge visits, edge value sum;
columns ``A`` and ``A+1`` hold the node's terminal flag, seat rotation,
visit count and value sum, and its terminal value vector) and ``states [B,
M, R, 7]``.  Every simulation descends each board from its root by PUCT
(FPU, the root's forced playouts), steps the chosen edge with the plain
env (chance collapsed), evaluates the leaf with the plain net, and backs
the value up the path, level by level, before it writes the expanded
node's row.  Ties go to the lowest index and every sum keeps the float32
order the search states, so two correct float32 searches of the same
roots with the same noise give the same counts."""

from __future__ import annotations

import dataclasses

import torch

from . import env as E

EPS = 1e-8
PVALID, CHILD, EN, EW = 0, 1, 2, 3
_STOP_CHECK_LEVELS = 8


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    num_sims: int
    cpuct: float = 1.0
    fpu: float = 0.0
    forced_playouts: bool = False
    k_forced: float = 0.5
    dirichlet_alpha: float = 0.2
    dirichlet_frac: float = 0.25
    prior_temp: float = 1.0
    add_noise: bool = False
    max_depth: int = 0


def _normalize_masked(p, valid):
    p = torch.where(valid, p, 0.0)
    return p / p.sum(-1, keepdim=True).clamp(min=EPS)


def search_step(ecfg: E.SplendorConfig, states, actions):
    """The in-tree transition: the deterministic step from the canonical
    frame, the seat swap, the terminal vector, the next mover's valid
    mask and the seat advance."""
    zeros = torch.zeros((states.shape[0], 2), dtype=torch.float32,
                        device=states.device)
    s2, nxt = E.step(ecfg, states, actions, 0, zeros, True)
    s2 = E.swap_players(ecfg, s2, nxt if ecfg.enable_noble_select else 1)
    return s2, E.check_end_game(ecfg, s2), E.valid_moves(ecfg, s2, 0), nxt


def _ucb_pick(cfg: SearchConfig, prior, valid, en, ew, ns, qs, sim_idx,
              is_root):
    """PUCT argmax over node rows ``[B, A]`` (first maximum), with the
    root's forced playouts."""
    A = prior.shape[-1]
    visited = en > 0
    q_a = ew / en.clamp(min=1.0)
    fpu_init = (qs - cfg.fpu if cfg.fpu > 0
                else torch.full_like(qs, cfg.fpu))[:, None]
    ns_f = ns[:, None]
    cp = cfg.cpuct * prior
    u = torch.where(visited, q_a + cp * torch.sqrt(ns_f) / (1.0 + en),
                    fpu_init + cp * torch.sqrt(ns_f + EPS))
    u = torch.where(valid, u, -torch.inf)
    best = torch.argmax(u, -1)
    if cfg.forced_playouts:
        thresh = torch.floor(torch.sqrt(cfg.k_forced * prior
                                        * float(sim_idx)))
        force = valid & (en < thresh) & is_root[:, None]
        idx = torch.arange(A, device=prior.device)[None, :]
        first = torch.where(force, idx, A).min(-1).values
        best = torch.where(force.any(-1), first, best)
    return best


def descend(cfg: SearchConfig, stats, sim_idx: int, depth_cap: int,
            levels: int):
    """Walk every board from its root until an unexpanded edge, a terminal
    child or the depth cap.  Returns ``(parent, action, existing, depth,
    parent_rot, path_p, path_a, path_r)``; a stopped board's path levels
    hold ``M`` (no node)."""
    B, M, _, A2 = stats.shape
    A = A2 - 2
    dev = stats.device
    ar = torch.arange(B, device=dev)
    path_p = torch.full((B, depth_cap), M, dtype=torch.long, device=dev)
    path_a = torch.zeros((B, depth_cap), dtype=torch.long, device=dev)
    path_r = torch.zeros((B, depth_cap), dtype=torch.long, device=dev)
    zeros = torch.zeros(B, dtype=torch.long, device=dev)
    node, parent, action, existing, prot = (zeros.clone() for _ in range(5))
    depth = torch.zeros(B, dtype=torch.long, device=dev)
    stop = torch.zeros(B, dtype=torch.bool, device=dev)
    for level in range(levels):
        if level and level % _STOP_CHECK_LEVELS == 0 and bool(stop.all()):
            break
        row = stats[ar, node]                                 # [B, 4, A+2]
        pv = row[:, PVALID, :A]
        ns = row[:, EN, A]
        rot = row[:, CHILD, A].long()
        qs = row[:, EW, A] / (ns + 1.0)
        a = _ucb_pick(cfg, pv.clamp(min=0.0), pv >= 0.0, row[:, EN, :A],
                      row[:, EW, :A], ns, qs, sim_idx, node == 0)
        child_raw = row[:, CHILD, :A].gather(1, a[:, None])[:, 0]
        child = child_raw.abs().long()
        now_stop = (child == 0) | (child_raw < 0.0) | (level >= depth_cap - 1)
        path_p[:, level] = torch.where(stop, M, node)
        path_a[:, level] = torch.where(stop, 0, a)
        path_r[:, level] = torch.where(stop, 0, rot)
        depth += (~stop).long()
        parent = torch.where(stop, parent, node)
        action = torch.where(stop, action, a)
        existing = torch.where(stop, existing, child)
        prot = torch.where(stop, prot, rot)
        node = torch.where(stop | now_stop, node, child)
        stop = stop | now_stop
    return parent, action, existing, depth, prot, path_p, path_a, path_r


def backup(stats, path_p, path_a, path_r, depth, value_vec, leaf_rot, parent,
           action, fresh, slot, pvalid_new, child_term, child_rot,
           leaf_init_v, term_vec):
    """One simulation's backup, in place: each level ``l < depth`` adds a
    visit and the value of its own mover's seat to its edge and to its
    node's column ``A``; a fresh edge gets the pointer ``+slot`` (``-slot``
    for a terminal child); the expanded node's row is added over its -1
    initialization."""
    B, M, _, C = stats.shape
    A, P = C - 2, value_vec.shape[1]
    ar = torch.arange(B, device=stats.device)
    live = torch.arange(path_p.shape[1], device=stats.device)[None, :] \
        < depth[:, None]
    v_l = value_vec.gather(1, (path_r - leaf_rot[:, None]) % P)
    w_en = live.to(torch.float32)
    w_ew = torch.where(live, v_l, 0.0)
    for s in range(path_p.shape[1]):
        p, a = path_p[:, s], path_a[:, s]
        keep = (p >= 0) & (p < M)
        if not bool(keep.any()):
            break
        b, p, a = ar[keep], p[keep], a[keep]
        stats[b, p, EN, a] += w_en[keep, s]
        stats[b, p, EW, a] += w_ew[keep, s]
        stats[b, p, EN, A] += w_en[keep, s]
        stats[b, p, EW, A] += w_ew[keep, s]
    child_v = (torch.where(fresh, slot.to(torch.float32), 0.0)
               * torch.where(child_term, -1.0, 1.0))
    inst = child_v != 0
    stats[ar[inst], parent[inst], CHILD, action[inst]] += child_v[inst]
    row = torch.zeros((B, 4, C), dtype=torch.float32, device=stats.device)
    row[:, PVALID, :A] = pvalid_new + 1.0
    row[:, PVALID, A] = child_term.to(torch.float32)
    row[:, CHILD, A] = child_rot.to(torch.float32)
    row[:, EW, A] = leaf_init_v
    row[:, :P, A + 1] = term_vec
    stats[ar, slot] += row


@torch.no_grad()
def run(cfg: SearchConfig, ecfg: E.SplendorConfig, net, roots,
        noise_gamma=None) -> dict:
    """``cfg.num_sims`` simulations on fresh trees rooted at ``roots [B, R,
    7]`` int8.  With ``add_noise``, ``noise_gamma [B, A]`` are the
    Gamma(alpha) draws of the root's Dirichlet noise.  Returns ``counts``
    (pruned by forced playouts, float32), ``raw_counts`` (int32), ``q``
    (root Q per seat), ``root_value`` and ``root_prior``."""
    dev = roots.device
    B, R, C7 = roots.shape
    S, P = cfg.num_sims, ecfg.num_players
    M = S + 1
    PL = min(M - 1, cfg.max_depth) if cfg.max_depth > 0 else M - 1
    ar = torch.arange(B, device=dev)
    root_valid = E.valid_moves(ecfg, roots, 0)
    A = root_valid.shape[1]
    pi0, v0 = net(roots.to(torch.float32), root_valid)
    pi0 = _normalize_masked(pi0, root_valid)
    if cfg.add_noise:
        if cfg.prior_temp != 1.0:
            pi0 = _normalize_masked(pi0 ** (1.0 / cfg.prior_temp), root_valid)
        noise = _normalize_masked(noise_gamma.to(dev), root_valid)
        pi0 = _normalize_masked((1.0 - cfg.dirichlet_frac) * pi0
                                + cfg.dirichlet_frac * noise, root_valid)
    stats = torch.zeros((B, M, 4, A + 2), dtype=torch.float32, device=dev)
    stats[:, :, PVALID, :A] = -1.0
    states = torch.zeros((B, M, R, C7), dtype=torch.int8, device=dev)
    states[:, 0] = roots
    stats[:, 0, PVALID, :A] = torch.where(root_valid, pi0, -1.0)
    stats[:, 0, EW, A] = v0[:, 0]
    for i in range(S):
        (parent, action, existing, depth, parent_rot, path_p, path_a,
         path_r) = descend(cfg, stats, i, PL, min(1 + i, PL))
        fresh = existing == 0
        slot = torch.full((B,), 1 + i, dtype=torch.long, device=dev)
        child_state, term_vec, child_valid, adv = search_step(
            ecfg, states[ar, parent], action)
        child_rot = (parent_rot + adv) % P
        probs, values = net(child_state.to(torch.float32), child_valid)
        probs = _normalize_masked(probs, child_valid)
        child_term = term_vec.abs().sum(-1) > 0
        states[ar, slot] = child_state
        leaf = stats[ar, existing, :, A:]
        leaf_term = torch.where(fresh, child_term, leaf[:, PVALID, 0] > 0)
        leaf_rot = torch.where(fresh, child_rot, leaf[:, CHILD, 0].long())
        leaf_tv = torch.where(fresh[:, None], term_vec, leaf[:, :P, 1])
        value_vec = torch.where(leaf_term[:, None], leaf_tv, values)
        backup(stats, path_p, path_a, path_r, depth, value_vec, leaf_rot,
               parent, action, fresh, slot,
               torch.where(child_valid, probs, -1.0), child_term, child_rot,
               values[:, 0], term_vec)
    root = stats[:, 0]
    counts = root[:, EN, :A].to(torch.int32)
    root_prior = root[:, PVALID, :A].clamp(min=0.0)
    qs = root[:, EW, A] / (root[:, EN, A] + 1.0)
    q = torch.cat([qs[:, None], (-qs / (P - 1))[:, None].expand(B, P - 1)], 1)
    out = counts.to(torch.float32)
    if cfg.forced_playouts:
        best = counts.max(1, keepdim=True).values
        pruned = counts - torch.floor(torch.sqrt(
            cfg.k_forced * root_prior * S)).to(torch.int32)
        adj = torch.where(counts == best, counts, pruned)
        out = torch.where(adj > 1, adj, 0).to(torch.float32)
        total = out.sum(-1, keepdim=True)
        out = torch.where(total > 0, out, counts.to(torch.float32))
    return {"counts": out, "raw_counts": counts, "q": q, "root_value": v0,
            "root_prior": root_prior}
