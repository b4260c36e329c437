"""The self-play actor of one ``run_games`` call in plain PyTorch, replayed
move by move against what the program did.

The actor plays B boards in lockstep from fresh initial states.  Each move
splits the boards at random into a full-search part of ``round(prob_full
* B)`` boards and a fast part (finished boards sort into the fast part),
searches both, samples each board's action from its visit counts by
Gumbel-max at the move's temperature, steps every live board with real
chance draws, swaps seats to the next mover's frame and checks the end.
Every full-search move of a live game keeps an example: the board, the
normalized counts, the valid mask and the root Q, finalized after the
last move with the game's outcome and score differences in the mover's
frame.

The replay draws from a generator of the same kind and seed as the
program's, in the same order, and takes each search's counts and root Q
from the program's recorded search calls (the searches themselves are
checked apart, by ``search.run``).  It reports every place where the
program's recorded roots, its generator state at a search, its returned
examples or its rollout count differ from its own."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import env as E


@dataclasses.dataclass(frozen=True)
class ActorConfig:
    batch_size: int
    num_sims: int
    ratio_full: int
    prob_full: float
    temp_threshold: int
    plies: int
    temp_early: float = 2.0
    temp_late: float = 0.2

    @property
    def fast_sims(self) -> int:
        return max(self.num_sims // self.ratio_full, 2)

    @property
    def b_full(self) -> int:
        B, p = self.batch_size, self.prob_full
        b = int(round(p * B))
        if p >= 1.0:
            return B
        if p > 0.0:
            return min(max(b, 1), B - 1) if B > 1 else B
        return b


def _gumbel(shape, gen, device):
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def _sample(counts, temp, gumbel):
    logits = torch.where(counts > 0, torch.log(counts.clamp(min=1e-12)),
                         -torch.inf)
    if temp > 1e-6:
        logits = logits / max(temp, 1e-6) + gumbel
    return torch.argmax(logits, -1)


def _finalize(collected, results, scores):
    out = {k: [] for k in ("boards", "pi", "winner", "scdiff", "valids",
                           "surprise")}
    for boards, pi, valids, q, pl, idx in collected:
        winner = np.roll(results[idx], -pl, axis=1)
        sc = scores[idx]
        sd = np.roll(sc - sc[:, pl:pl + 1], -pl, axis=1)
        out["boards"].append(boards)
        out["pi"].append(pi)
        out["valids"].append(valids)
        out["winner"].append(winner.astype(np.float16))
        out["scdiff"].append(np.clip(sd, -127, 127).astype(np.int8))
        out["surprise"].append(np.abs(q - winner).astype(np.float16))
    return {k: np.concatenate(v) if v else None for k, v in out.items()}


@torch.no_grad()
def replay(ecfg: E.SplendorConfig, cfg: ActorConfig, seed: int, records,
           examples: dict | None, rollouts: int, device) -> list[str]:
    """Replay one call whose generator was seeded with ``seed``;
    ``records`` are the program's search calls in order, each with
    ``kind`` ("full" or "fast"), ``roots``, ``state_in``, ``state_out``,
    ``counts`` and ``q``; ``examples`` the call's returned examples by
    field (None for none) and ``rollouts`` its count.  Returns one line per
    difference (empty when the program agrees)."""
    if ecfg.enable_noble_select:
        raise ValueError("the replay does not play the noble-select ply")
    B, P, dev = cfg.batch_size, ecfg.num_players, torch.device(device)
    b_full = cfg.b_full
    diffs: list[str] = []
    gen = torch.Generator(device=dev).manual_seed(seed)
    states = E.initial_state(ecfg, B, gen, dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    results = torch.zeros((B, P), dtype=torch.float32, device=dev)
    offset, total_sims, collected = 0, 0, []
    recs = iter(records)
    for move in range(cfg.plies):
        valids = E.valid_moves(ecfg, states, 0)
        u_b = torch.rand(B, generator=gen, device=dev)
        perm = torch.argsort(u_b + done.to(torch.float32), stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(B, device=dev)
        parts = []
        for kind, idx in (("full", perm[:b_full]), ("fast", perm[b_full:])):
            r = next(recs, None)
            if r is None or r.kind != kind:
                diffs.append(f"move {move}: no {kind} search recorded")
                return diffs
            if not torch.equal(r.state_in, gen.get_state()):
                diffs.append(f"move {move}: generator state at the {kind} "
                             f"search differs")
            bad = (r.roots != states[idx]).flatten(1).any(1)
            if bool(bad.any()):
                diffs.append(f"move {move}: {int(bad.sum())} {kind}-search "
                             f"roots differ")
            gen.set_state(r.state_out)
            parts.append(r)
        counts = torch.cat([parts[0].counts, parts[1].counts])[inv]
        q = torch.cat([parts[0].q, parts[1].q])[inv]
        is_full = (inv < b_full)
        off_mask = (counts > 0) & ~valids
        if bool(off_mask.any()):
            diffs.append(f"move {move}: {int(off_mask.sum())} root visits on "
                         f"invalid actions")
        temp = cfg.temp_early if move < cfg.temp_threshold else cfg.temp_late
        actions = _sample(counts, temp, _gumbel(counts.shape, gen, dev))
        u = torch.rand(B, 2, generator=gen, device=dev)
        s2, _ = E.step(ecfg, states, actions, 0, u, False)
        states_mid = torch.where(done[:, None, None], states, s2)
        states2 = E.swap_players(ecfg, states_mid, 1)
        offset2 = (offset + 1) % P
        ends = torch.roll(E.check_end_game(ecfg, states2), offset2, 1)
        newly = ends.any(1) & ~done
        results = torch.where(newly[:, None], ends, results)
        alive = (~done).cpu().numpy()
        full = is_full.cpu().numpy()
        total_sims += (int((alive & full).sum()) * cfg.num_sims
                       + int((alive & ~full).sum()) * cfg.fast_sims)
        keep = alive & full
        if keep.any():
            idx = np.flatnonzero(keep)
            sel = torch.from_numpy(idx).to(dev)
            vm = valids[sel].cpu().numpy()
            c = counts[sel].cpu().numpy()
            if (c * ~vm).any():
                # visits on invalid actions are dropped, and a row left
                # with none (already reported above)
                c = c * vm
                ok = c.sum(1) > 0
                idx, c, vm = idx[ok], c[ok], vm[ok]
                sel = sel[torch.from_numpy(ok).to(dev)]
            pi = c / np.maximum(c.sum(1, keepdims=True), 1e-9)
            collected.append((states[sel].cpu().numpy(),
                              pi.astype(np.float16), vm,
                              q[sel].cpu().numpy(), offset, idx))
        states, offset, done = states2, offset2, done | newly
        if bool(done.all()):
            break
    if next(recs, None) is not None:
        diffs.append("more search calls recorded than the actor makes")
    results_np = results.cpu().numpy()
    done_np = done.cpu().numpy()
    if not done_np.all():
        ends = np.roll(E.judge(ecfg, states).cpu().numpy(), offset, 1)
        results_np[~done_np] = ends[~done_np]
    if total_sims != rollouts:
        diffs.append(f"rollouts {rollouts}, the replay counts {total_sims}")
    scores = np.roll(E.all_scores(ecfg, states).cpu().numpy(), offset, 1)
    want = _finalize(collected, results_np, scores)
    for k, w in want.items():
        got = None if examples is None else examples.get(k)
        if w is None or got is None:
            if (w is None) != (got is None):
                diffs.append(f"examples.{k}: one side has none")
            continue
        if got.shape != w.shape:
            diffs.append(f"examples.{k}: shape {got.shape}, the replay's "
                         f"{w.shape}")
        elif not np.array_equal(got, w):
            n = int((got.reshape(len(got), -1)
                     != w.reshape(len(w), -1)).any(1).sum())
            diffs.append(f"examples.{k}: {n} of {len(w)} differ")
    return diffs
