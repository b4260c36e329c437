"""Batched self-play: B games stepped in lockstep on the device.

Port of ``SelfPlayEngine.run_games`` of ``alphazero_tpu/train/selfplay.py``.
Every move runs the batched MCTS over all live boards, samples an action
per board and steps the env with real chance draws.  Playout-cap
randomization is per board and per move: the batch is split into a
full-search part of ``round(prob_full * B)`` boards and a fast part, with
finished boards sorted into the fast part.  With ``tree_reuse`` each board
carries its tree across moves: both parts search from their boards'
carried trees, and after the move every tree is re-rooted on the played
action (a board whose real chance draw left the tree restarts from a
fresh root).
Examples are kept only for full-search moves of live games, tagged with
the root-Q vector, and finalized with per-player winner and score-diff
vectors rolled into each mover's frame.

The JAX actor fuses ``chunk_moves`` moves into one ``lax.scan`` call; the
port runs a Python loop over moves.  It plays the same number of moves:
whole chunks, until every game has ended or the chunk that reaches
``max_moves`` is done.  Randomness comes from one ``torch.Generator``.

While a profiler records, the actor's host time outside its search calls
falls into three leaf spans (``utils/profiling.py::span``):
``selfplay.split`` (the PCR permutation, the index splits and the merges),
``selfplay.move`` (initial states, sampling, the chance step, the noble
step, the seat swap, the end check, the results, reroot) and
``selfplay.host`` (every read back to the host: the loop's flags, the
examples, the finalize); it counts ``selfplay.plies``.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..games.splendor import adapter as A
from ..games.splendor import env as E
from ..parallel import distributed as D
from ..search import mcts as M
from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .replay import Iteration

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SelfPlayConfig:
    """The JAX actor's configuration, less the fields that steer how it is
    compiled (``donate_chunk``, ``reuse_barrier``, ``debug_outputs``)."""
    batch_size: int = 128
    num_sims: int = 100
    ratio_full: int = 5            # fast sims = num_sims // ratio_full
    prob_full: float = 0.25
    temp_threshold: int = 10       # moves at temp_early, then temp_late
    temp_early: float = 2.0
    temp_late: float = 0.2
    cpuct: float = 1.0
    fpu: float = 0.0
    forced_playouts: bool = False
    dirichlet_alpha: float = 0.2
    prior_temp: float = 1.25
    max_moves: int = 0             # 0 -> env max
    chunk_moves: int = 16          # moves per chunk (sets the move count)
    tree_reuse: bool = False
    max_depth: int = 64
    stats_dtype: str = "auto"
    stage_sims: str = "auto"


def pcr_full_size(batch: int, prob_full: float) -> int:
    """Boards per move that get the full search (the rest get the fast
    one): ``round(prob_full * B)``, kept inside [1, B-1] unless prob_full
    is 0 or 1."""
    b_full = int(round(prob_full * batch))
    if prob_full >= 1.0:
        b_full = batch
    elif prob_full > 0.0:
        b_full = min(max(b_full, 1), batch - 1) if batch > 1 else batch
    return b_full


def gumbel_noise(shape, generator=None, device="cuda") -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with ``u`` in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def sample_actions(counts: torch.Tensor, temp: float,
                   gumbel: torch.Tensor) -> torch.Tensor:
    """Sample ``a ~ counts^(1/temp)`` by Gumbel-max; ``temp ~ 0`` takes the
    argmax."""
    logits = torch.where(counts > 0, torch.log(counts.clamp(min=1e-12)),
                         -torch.inf)
    if temp > 1e-6:
        logits = logits / max(temp, 1e-6) + gumbel
    return torch.argmax(logits, -1)


class SelfPlayEngine:
    def __init__(self, env_cfg: E.SplendorConfig, eval_fn, cfg: SelfPlayConfig,
                 device="cuda", mesh=None):
        """``mesh``: an optional ``DeviceMesh`` with an 'env' axis
        (``parallel/mesh.py``).  With it, each rank plays its block of
        ``cfg.batch_size / W`` boards (W = the axis size, which must divide
        the batch) with the generator its caller gives it (the coach's
        comes from ``(seed, rank)``), and ``run_games`` returns every
        rank's examples, in rank order, and the summed statistics on every
        rank: W single-process runs of those blocks, with the same
        generators, gathered."""
        self.device = resolve_device(device)
        self.env_cfg = env_cfg
        self.mesh = mesh
        if mesh is not None:
            _, _, world = D.axis_group(mesh, "env")
            if cfg.batch_size % world:
                raise ValueError(f"self-play batch {cfg.batch_size} does not "
                                 f"split evenly over {world} ranks")
            cfg = dataclasses.replace(cfg, batch_size=cfg.batch_size // world)
        self.cfg = cfg
        self.n = env_cfg.num_players
        step_fn = A.make_search_step_fn(env_cfg)
        self.valid_fn = A.make_valid_fn(env_cfg)
        full = M.MCTSConfig(
            num_sims=cfg.num_sims, cpuct=cfg.cpuct, fpu=cfg.fpu,
            forced_playouts=cfg.forced_playouts, add_noise=True,
            dirichlet_alpha=cfg.dirichlet_alpha, prior_temp=cfg.prior_temp,
            max_depth=cfg.max_depth, stats_dtype=cfg.stats_dtype,
            stage_sims=cfg.stage_sims)
        # an explicit stage list sums to the full search's sims; the fast
        # search runs unstaged (every schedule gives the same results)
        fast_stage = (cfg.stage_sims
                      if str(cfg.stage_sims).strip().lower() in ("auto", "off")
                      else "off")
        fast = M.MCTSConfig(
            num_sims=self.fast_sims, cpuct=cfg.cpuct, fpu=cfg.fpu,
            max_depth=cfg.max_depth, stats_dtype=cfg.stats_dtype,
            stage_sims=fast_stage)
        self.search_full = M.build_search(full, self.n, eval_fn, step_fn,
                                          self.valid_fn, self.device)
        self.search_fast = M.build_search(fast, self.n, eval_fn, step_fn,
                                          self.valid_fn, self.device)
        self.b_full = pcr_full_size(cfg.batch_size, cfg.prob_full)
        if cfg.tree_reuse:
            # one capacity for both searches, so a board's tree serves
            # whichever part it lands in; reroot keeps what the full
            # search may carry
            self.rs_full = M.build_reusing_search(
                full, self.n, eval_fn, step_fn, self.valid_fn,
                keep_cap=full.num_sims, device=self.device)
            self.rs_fast = M.build_reusing_search(
                fast, self.n, eval_fn, step_fn, self.valid_fn,
                keep_cap=self.rs_full.capacity - fast.num_sims - 1,
                device=self.device)

    @property
    def fast_sims(self) -> int:
        return max(self.cfg.num_sims // self.cfg.ratio_full, 2)

    def _search(self, bundle, states, done, gen, carry=None):
        """Counts, root Q and the full-search flag for every board, and
        with tree reuse the carried ``(tree, n)`` after the searches (the
        trees' roots are ``states``)."""
        B, b_full = states.shape[0], self.b_full
        if b_full >= B or b_full == 0:
            if carry is None:
                search = self.search_full if b_full >= B else self.search_fast
                res = search(bundle, states, generator=gen)
            else:
                rs = self.rs_full if b_full >= B else self.rs_fast
                res, tree, n = rs.run(bundle, *carry, generator=gen)
                carry = tree, n
            with span("selfplay.split"):
                is_full = torch.full((B,), b_full >= B, dtype=torch.bool,
                                     device=self.device)
            return res.counts, res.q, is_full, carry
        with span("selfplay.split"):
            # stratified split; finished boards sort last (into the fast
            # part)
            u_b = torch.rand(B, generator=gen, device=self.device)
            perm = torch.argsort(u_b + done.to(torch.float32), stable=True)
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(B, device=self.device)
            idx_f, idx_s = perm[:b_full], perm[b_full:]

            def merge(a, b):
                return torch.cat([a, b])[inv]
            if carry is None:
                parts = states[idx_f], states[idx_s]
            else:
                # each part searches a copy of its boards' trees, which
                # then goes back into the batch's tensors
                tree, n = carry
                parts = ((M.Tree(*(t[idx_f] for t in tree)), n[idx_f]),
                         (M.Tree(*(t[idx_s] for t in tree)), n[idx_s]))
        if carry is None:
            res_f = self.search_full(bundle, parts[0], generator=gen)
            res_s = self.search_fast(bundle, parts[1], generator=gen)
        else:
            res_f, tf, nf = self.rs_full.run(bundle, *parts[0], generator=gen)
            res_s, ts, ns = self.rs_fast.run(bundle, *parts[1], generator=gen)
        with span("selfplay.split"):
            if carry is not None:
                for t, a, b in zip(tree, tf, ts):
                    t[idx_f], t[idx_s] = a, b
                carry = tree, merge(nf, ns)
            is_full = merge(torch.ones(b_full, dtype=torch.bool,
                                       device=self.device),
                            torch.zeros(B - b_full, dtype=torch.bool,
                                        device=self.device))
            return (merge(res_f.counts, res_s.counts),
                    merge(res_f.q, res_s.q), is_full, carry)

    def _resolve_nobles(self, bundle, states_mid, adv, gen):
        """Boards whose move left a pending noble choice (``adv == 0``) pick
        a noble with a fast search in the same mover's frame."""
        with span("selfplay.move"):
            pend = adv == 0
        with span("selfplay.host"):
            if not bool(pend.any()):
                return states_mid
        res = self.search_fast(bundle, states_mid, generator=gen)
        with span("selfplay.move"):
            acts = torch.argmax(res.counts, -1)
            u = torch.rand(states_mid.shape[0], 2, generator=gen,
                           device=self.device)
            s3, _ = E.step(self.env_cfg, states_mid, acts, 0, u, False)
            return torch.where(pend[:, None, None], s3, states_mid)

    def run_games(self, params_bundle, generator: torch.Generator | None = None,
                  collect: bool = True):
        """Play one batch of games to completion (or the move cap).

        Returns ``(Iteration | None, stats dict)``."""
        it, stats = self.run_local_games(params_bundle, generator, collect)
        if self.mesh is None:
            return it, stats
        return gather_games(self.mesh, it, stats)

    def run_local_games(self, params_bundle, generator=None, collect=True):
        """``run_games`` of this rank's boards only, nothing gathered."""
        cfg, n, ecfg, dev = self.cfg, self.n, self.env_cfg, self.device
        with span("selfplay.move"):
            B = cfg.batch_size
            max_moves = cfg.max_moves or ecfg.max_moves
            n_moves = -(-max_moves // cfg.chunk_moves) * cfg.chunk_moves
            gen = generator
            if gen is None:
                gen = torch.Generator(device=dev).manual_seed(0)

            states = E.initial_state(ecfg, B, gen, dev)
            offset = 0
            done = torch.zeros(B, dtype=torch.bool, device=dev)
            results = torch.zeros((B, n), dtype=torch.float32, device=dev)
            collected = []
            total_moves = total_sims = 0
            carry = self.rs_full.init_tree(states) if cfg.tree_reuse else None

        for move in range(n_moves):
            with span("selfplay.move"):
                valids = self.valid_fn(states)
            counts, q, is_full, carry = self._search(params_bundle, states,
                                                     done, gen, carry)
            with span("selfplay.move"):
                temp = (cfg.temp_early if move < cfg.temp_threshold
                        else cfg.temp_late)
                actions = sample_actions(counts, temp,
                                         gumbel_noise(counts.shape, gen, dev))
                u = torch.rand(B, 2, generator=gen, device=dev)
                # finished boards keep their final position but still
                # rotate seats, so the batch shares one canonical rotation
                # offset
                s2, nxt = E.step(ecfg, states, actions, 0, u, False)
                states_mid = torch.where(done[:, None, None], states, s2)
                if ecfg.enable_noble_select:
                    adv = torch.where(done, 1, nxt)
            if ecfg.enable_noble_select:
                states_mid = self._resolve_nobles(params_bundle, states_mid,
                                                  adv, gen)
            with span("selfplay.move"):
                states2 = E.swap_players(ecfg, states_mid, 1)
                offset2 = (offset + 1) % n
                ends = torch.roll(E.check_end_game(ecfg, states2), offset2, 1)
                newly = ends.any(1) & ~done
                done2 = done | newly
                results = torch.where(newly[:, None], ends, results)
                if carry is not None:
                    # a board whose real chance draw (or noble choice) left
                    # the tree fails reroot's state match and restarts fresh
                    carry = self.rs_full.reroot(carry[0], actions, states2)
                count("selfplay.plies")

            with span("selfplay.host"):
                alive = (~done).cpu().numpy()
                full = is_full.cpu().numpy()
                total_moves += int(alive.sum())
                total_sims += (int((alive & full).sum()) * cfg.num_sims
                               + int((alive & ~full).sum()) * self.fast_sims)
                if collect:
                    self._collect(collected, alive & full, states, counts,
                                  valids, q, offset)
                states, offset, done = states2, offset2, done2
                if bool(done.all()):
                    break

        with span("selfplay.host"):
            results_np = results.cpu().numpy()
            done_np = done.cpu().numpy()
            if not done_np.all():
                # settle unfinished games by the unconditional judge: at the
                # cap the round count need not sit on a turn boundary
                ends = np.roll(E.judge(ecfg, states).cpu().numpy(), offset, 1)
                results_np[~done_np] = ends[~done_np]

            stats = {"games": B, "avg_moves": total_moves / B,
                     "rollouts": total_sims, "examples": 0}
            if not collect or not collected:
                return None, stats
            scores = np.roll(E.all_scores(ecfg, states).cpu().numpy(),
                             offset, 1)
            it = finalize_examples(collected, results_np, scores)
            if it is None:
                return None, stats
            stats["examples"] = len(it)
            return it, stats

    @staticmethod
    def _collect(collected, mask, states, counts, valids, q, player):
        """Host copies of one move's full-search examples."""
        if not mask.any():
            return
        idx = np.flatnonzero(mask)
        sel = torch.from_numpy(idx).to(states.device)
        counts_h = counts[sel].cpu().numpy()
        vm = valids[sel].cpu().numpy()
        # correctness backstop: root visits on an invalid action mean the
        # counts belong to another state; drop that mass, and a row whose
        # every visit was invalid
        bad = counts_h * ~vm
        if bad.any():
            log.warning("masking %d root visits on invalid actions across %d "
                        "examples", int(bad.sum()), int((bad.sum(1) > 0).sum()))
            counts_h = counts_h * vm
            keep = counts_h.sum(1) > 0
            if not keep.all():
                idx, counts_h, vm = idx[keep], counts_h[keep], vm[keep]
                sel = sel[torch.from_numpy(keep).to(sel.device)]
                if len(idx) == 0:
                    return
        pi = counts_h / np.maximum(counts_h.sum(1, keepdims=True), 1e-9)
        collected.append((states[sel].cpu().numpy(), pi.astype(np.float16), vm,
                          q[sel].cpu().numpy(), int(player), idx))


def gather_games(mesh, it: Iteration | None, stats: dict):
    """Every rank's ``(Iteration | None, stats)`` of one ``run_games``
    call, gathered on every rank: the examples concatenated in rank order,
    the games, rollouts and examples summed, ``avg_moves`` over all
    games."""
    parts = D.gather_objects((it, stats), mesh)
    its = [i for i, _ in parts if i is not None]
    total = {k: sum(st[k] for _, st in parts)
             for k in ("games", "rollouts", "examples")}
    total["avg_moves"] = sum(st["avg_moves"] * st["games"]
                             for _, st in parts) / total["games"]
    if not its:
        return None, total
    return Iteration(*(np.concatenate([getattr(i, f.name) for i in its])
                       for f in dataclasses.fields(Iteration))), total


def finalize_examples(collected, results: np.ndarray,
                      scores: np.ndarray) -> Iteration | None:
    """Roll each game's final outcome into every stored example's mover
    frame: ``winner = roll(result, -player)``, ``scdiff = roll(scores -
    scores[player], -player)``, plus the per-player surprise ``|q -
    winner|``.

    ``collected``: per-move tuples ``(boards [E,R,7], pi [E,A], valids
    [E,A], q [E,P] mover-frame root Q, player, board_idx [E])``;
    ``results``/``scores``: ``[B, P]`` absolute-seat final arrays."""
    boards_l, pi_l, val_l, win_l, sd_l, sur_l = [], [], [], [], [], []
    for boards, pi, valids, q, pl, idx in collected:
        if len(idx) == 0:
            continue
        winner = np.roll(results[idx], -pl, axis=1)
        sc = scores[idx]
        sd = np.roll(sc - sc[:, pl:pl + 1], -pl, axis=1)
        boards_l.append(boards)
        pi_l.append(pi)
        val_l.append(valids)
        win_l.append(winner.astype(np.float16))
        sd_l.append(np.clip(sd, -127, 127).astype(np.int8))
        sur_l.append(np.abs(q - winner).astype(np.float16))
    if not boards_l:
        return None
    return Iteration(
        boards=np.concatenate(boards_l),
        pi=np.concatenate(pi_l),
        winner=np.concatenate(win_l),
        scdiff=np.concatenate(sd_l),
        valids=np.concatenate(val_l),
        surprise=np.concatenate(sur_l),
    )
