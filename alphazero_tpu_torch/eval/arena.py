"""Batched arena: head-to-head matches between agents.

Port of ``alphazero_tpu/eval/arena.py``.  B games advance in lockstep; each
seat is controlled by an agent that acts on the whole batch at once:
``agent(canonical states [B, R, 7] int8, generator) -> actions [B]``.

- ``BatchArena.play`` steps the games one move at a time from the mover's
  canonical frame, resolves a pending noble choice with the same mover's
  agent, tells every stateful agent (one with ``on_move``, such as
  ``ReusingAgent``) the move and the next mover's canonical states, and
  settles games still running at the move cap by the engine's judge.  It
  takes the initial states and the chance draws as optional inputs, so a
  caller can replay the JAX package's.
- ``FusedMatch`` is the JAX arena's device-fused match (``chunk_moves``
  moves per ``lax.scan`` call) as a Python loop over moves.  It keeps its
  semantics: states stay canonical with one shared ``offset`` (the absolute
  seat at canonical seat 0), the seat's bundle is picked by ``offset``, a
  pending noble choice is resolved inside the macro-move with the same
  seat's bundle, the moves are counted in whole chunks, and the judge's
  verdict at the cap is rolled back by ``offset``.

Randomness comes from one ``torch.Generator`` on the arena's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..games.splendor import env as E
from ..train.selfplay import gumbel_noise
from ..utils.device import resolve_device

# Agent: (canonical_states [B,R,7] int8, generator) -> actions [B]
Agent = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


@dataclasses.dataclass
class MatchResult:
    outcomes: np.ndarray      # (B, n) terminal vectors, absolute seats
    scores: np.ndarray        # (B, n)
    moves: int

    def tally(self, seat_of_agent: list[int]):
        """wins per agent index given one entry per seat (N-player aware)."""
        wins = [0] * (max(seat_of_agent) + 1)
        draws = 0
        for r in self.outcomes:
            top = np.flatnonzero(r > 0)
            if len(top) == 1:
                wins[seat_of_agent[top[0]]] += 1
            else:
                draws += 1
        return wins, draws


def _draw(draws, t, B, generator, device):
    """Move ``t``'s chance uniforms [B, 2]: from ``draws`` when given."""
    if draws is not None:
        return torch.as_tensor(np.asarray(draws[t]), dtype=torch.float32,
                               device=device)
    return torch.rand(B, 2, generator=generator, device=device)


class BatchArena:
    def __init__(self, env_cfg: E.SplendorConfig, batch_size: int,
                 token_limits: list[int] | None = None, device="cuda"):
        """``token_limits``: optional per-seat gem-holding limit (the
        handicap lever); rules seen by seat p use
        ``token_limit=token_limits[p]``."""
        self.device = resolve_device(device)
        self.cfg = env_cfg
        self.B = batch_size
        cfg = env_cfg
        self.token_limits = (list(token_limits) if token_limits
                             else [cfg.token_limit] * cfg.num_players)
        self.handicapped = any(l != cfg.token_limit for l in self.token_limits)
        self._seat_cfgs = [dataclasses.replace(cfg, token_limit=lim)
                           for lim in self.token_limits]

    def init(self, generator=None):
        return E.initial_state(self.cfg, self.B, generator, self.device)

    def canon(self, states, player):
        return E.swap_players(self.cfg, states, player)

    def step(self, states, actions, player, uniforms):
        return E.step(self._seat_cfgs[player], states, actions, player,
                      uniforms, False)

    def valids(self, states, player: int = 0):
        return E.valid_moves(self._seat_cfgs[player], states, 0)

    def play(self, agents: list[Agent], generator=None, start_states=None,
             start_player: int = 0, uniforms=None,
             noble_uniforms=None) -> MatchResult:
        """agents[p] acts for seat p; all B games run to completion or the
        move cap.  ``uniforms[t]`` / ``noble_uniforms[t]`` ([B, 2]), when
        given, replace move t's chance draws for the move and for its noble
        choice."""
        cfg, B, dev = self.cfg, self.B, self.device
        states = (self.init(generator) if start_states is None
                  else torch.as_tensor(np.array(start_states)).to(dev))
        player = start_player
        done = np.zeros(B, bool)
        outcomes = np.zeros((B, cfg.num_players), np.float32)
        moves = 0
        for t in range(cfg.max_moves + 1):
            canon = self.canon(states, player)
            actions = agents[player](canon, generator)
            states, nxt = self.step(states, actions, player,
                                    _draw(uniforms, t, B, generator, dev))
            pending = nxt == player
            if cfg.enable_noble_select and bool(pending.any()):
                # the same mover picks a noble; boards without a pending
                # choice keep their stepped state
                acts2 = agents[player](self.canon(states, player), generator)
                stepped2, _ = self.step(states, acts2, player,
                                        _draw(noble_uniforms, t, B, generator,
                                              dev))
                states = torch.where(pending[:, None, None], stepped2, states)
            player = (player + 1) % cfg.num_players
            moves += 1
            # stateful agents follow every move of the game, their own and
            # the others'; an agent holding several seats hears it once
            observers = {id(a): a for a in agents if hasattr(a, "on_move")}
            if observers:
                next_canon = self.canon(states, player)
                for a in observers.values():
                    a.on_move(actions, next_canon)
            ends = E.check_end_game(cfg, states).cpu().numpy()
            newly = ends.any(1) & ~done
            outcomes[newly] = ends[newly]
            done |= newly
            if done.all():
                break
        if not done.all():
            # move-cap cutoff: settle by score + card-count tiebreak even off
            # a turn boundary
            forced = E.judge(cfg, states).cpu().numpy()
            outcomes[~done] = forced[~done]
        return MatchResult(outcomes=outcomes,
                           scores=E.all_scores(cfg, states).cpu().numpy(),
                           moves=moves)


def _pick(counts, temp, generator, gumbel=None):
    """Greedy (temp ~ 0) or Gumbel-sampled action from visit counts;
    ``gumbel [B, A]`` replaces the draw when given."""
    if temp <= 1e-6:
        return torch.argmax(counts, -1)
    if gumbel is None:
        gumbel = gumbel_noise(counts.shape, generator, counts.device)
    logits = torch.log(counts.clamp(min=1e-12)) / temp
    return torch.argmax(logits + gumbel.to(counts.device), -1)


def make_search_agent(search_fn, params_bundle, temp: float = 0.0) -> Agent:
    """Greedy (temp=0) agent over a batched search: the gating player."""
    def agent(canon, generator=None):
        res = search_fn(params_bundle, canon, generator=generator)
        return _pick(res.counts, temp, generator)
    return agent


class ReusingAgent:
    """An agent that keeps one tree per board for the whole game, all seats
    included: it searches from the tree on its own turns and re-roots it on
    every move played (``on_move``, which ``BatchArena.play`` calls after
    each move).  A board whose real next state differs from the tree's
    child restarts from a fresh root.  ``reusing_search`` comes from
    ``search.mcts.build_reusing_search``."""

    def __init__(self, reusing_search, bundle, temp: float = 0.0):
        self.rs = reusing_search
        self.bundle = bundle
        self.temp = temp
        self.tree = None
        self.n = None

    def reset(self):
        self.tree = None

    def __call__(self, canon, generator=None, gumbel=None):
        if self.tree is None:
            self.tree, self.n = self.rs.init_tree(canon)
        res, self.tree, self.n = self.rs.run(self.bundle, self.tree, self.n,
                                             generator=generator)
        return _pick(res.counts, self.temp, generator, gumbel)

    def on_move(self, actions, next_canon):
        if self.tree is not None:
            self.tree, self.n = self.rs.reroot(self.tree, actions, next_canon)


def _masked_argmax(pool, generator, gumbel):
    if gumbel is None:
        gumbel = gumbel_noise(pool.shape, generator, pool.device)
    return torch.argmax(torch.where(pool, gumbel, -torch.inf), -1)


def make_random_agent(valids_fn) -> Agent:
    """Uniform random over valid moves; ``gumbel [B, A]`` replaces the
    draw when given."""
    def agent(canon, generator=None, gumbel=None):
        return _masked_argmax(valids_fn(canon), generator, gumbel)
    return agent


# Only buys (board 0-11, reserved 27-29) can raise the mover's score (card
# points + noble award); every other action is score-neutral, so the 1-ply
# lookahead only steps these 15 candidates.
_GREEDY_CANDIDATES = list(range(12)) + [27, 28, 29]


def greedy_gains(cfg: E.SplendorConfig, canon):
    """``(valid [B, A], gain [B, A] int32)``: the immediate score gain of
    each valid move for the mover (seat 0), ``-2**14`` where invalid."""
    B, dev = canon.shape[0], canon.device
    A, K = cfg.num_actions, len(_GREEDY_CANDIDATES)
    valid = E.valid_moves(cfg, canon, 0)
    s0 = E.all_scores(cfg, canon)[:, 0]
    cand = torch.tensor(_GREEDY_CANDIDATES, device=dev)
    s2, _ = E.step(cfg, canon.repeat_interleave(K, 0), cand.repeat(B), 0,
                   torch.zeros((B * K, 2), device=dev), True)
    cand_gain = E.all_scores(cfg, s2)[:, 0].view(B, K) - s0[:, None]
    gain = torch.zeros((B, A), dtype=cand_gain.dtype, device=dev)
    gain[:, cand] = cand_gain
    return valid, torch.where(valid, gain, -(2 ** 14))


def greedy_pool(valid, gain):
    """The reference's tie-break ladder: the valid moves of the largest
    positive gain; if nothing gains, the buys (actions < 12), then the
    3-gem takes (30-59), else any valid move."""
    best = gain.max(-1, keepdim=True).values
    ids = torch.arange(gain.shape[1], device=gain.device)[None, :]
    pool_gain = valid & (gain == best)
    pool_buy = valid & (ids < 12)
    pool_take = valid & (ids >= 30) & (ids < 60)
    fallback = torch.where(
        pool_buy.any(-1, keepdim=True), pool_buy,
        torch.where(pool_take.any(-1, keepdim=True), pool_take, valid))
    return torch.where(best > 0, pool_gain, fallback)


def make_greedy_agent(env_cfg: E.SplendorConfig) -> Agent:
    """1-ply score maximizer (``greedy_pool`` of ``greedy_gains``), random
    within the pool; ``gumbel [B, A]`` replaces the draw when given."""
    def agent(canon, generator=None, gumbel=None):
        pool = greedy_pool(*greedy_gains(env_cfg, canon))
        return _masked_argmax(pool, generator, gumbel)
    return agent


def two_player_gate(env_cfg, search_fn, new_bundle, old_bundle, games: int,
                    generator=None, device="cuda") -> tuple[int, int, int]:
    """Arena gating: play ``games`` split into both seat orders.
    Returns (new_wins, old_wins, draws)."""
    half = max(games // 2, 1)
    arena = BatchArena(env_cfg, half, device=device)
    new_agent = make_search_agent(search_fn, new_bundle)
    old_agent = make_search_agent(search_fn, old_bundle)
    r1 = arena.play([new_agent, old_agent], generator)
    r2 = arena.play([old_agent, new_agent], generator)
    w1, d1 = r1.tally([0, 1])
    w2, d2 = r2.tally([1, 0])
    return w1[0] + w2[0], w1[1] + w2[1], d1 + d2


class FusedMatch:
    """Whole games with one shared search program and a per-seat parameter
    bundle: each move runs the search with the mover's bundle on the
    canonical states, plays its greedy action, steps the env with chance
    and rotates the seats."""

    def __init__(self, env_cfg: E.SplendorConfig, search_fn,
                 batch_size: int, chunk_moves: int = 16, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = env_cfg
        self.search = search_fn
        self.B = batch_size
        self.chunk_moves = chunk_moves

    def play(self, seat_bundles: list, generator=None, start_states=None,
             uniforms=None, noble_uniforms=None) -> MatchResult:
        """seat_bundles[p] = parameter bundle controlling seat p.
        ``uniforms[t]`` / ``noble_uniforms[t]`` ([B, 2]), when given,
        replace move t's chance draws for the move and for its noble
        choice."""
        cfg, B, dev, n = self.cfg, self.B, self.device, self.cfg.num_players
        states = (E.initial_state(cfg, B, generator, dev)
                  if start_states is None
                  else torch.as_tensor(np.array(start_states)).to(dev))
        offset = 0
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        results = torch.zeros((B, n), dtype=torch.float32, device=dev)
        moves = t = 0
        for _ in range(-(-cfg.max_moves // self.chunk_moves)):
            for _ in range(self.chunk_moves):
                bundle = seat_bundles[offset]
                res = self.search(bundle, states, generator=generator)
                actions = torch.argmax(res.counts, -1)
                s2, nxt = E.step(cfg, states, actions, 0,
                                 _draw(uniforms, t, B, generator, dev), False)
                states_mid = torch.where(done[:, None, None], states, s2)
                if cfg.enable_noble_select:
                    # resolve a pending noble choice inside the macro-move
                    # (same mover, hence the same seat bundle) so every
                    # board advances exactly one seat per move
                    pend = torch.where(done, 1, nxt) == 0
                    if bool(pend.any()):
                        res2 = self.search(bundle, states_mid,
                                           generator=generator)
                        s3, _ = E.step(cfg, states_mid,
                                       torch.argmax(res2.counts, -1), 0,
                                       _draw(noble_uniforms, t, B, generator,
                                             dev), False)
                        states_mid = torch.where(pend[:, None, None], s3,
                                                 states_mid)
                states = E.swap_players(cfg, states_mid, 1)
                offset = (offset + 1) % n
                ends = torch.roll(E.check_end_game(cfg, states), offset, 1)
                newly = ends.any(1) & ~done
                results = torch.where(newly[:, None], ends, results)
                done = done | newly
                t += 1
            moves += self.chunk_moves
            if bool(done.all()):
                break
        results_np = results.cpu().numpy()
        done_np = done.cpu().numpy()
        if not done_np.all():
            # games still running at the cap are settled by the engine
            # judge; states are canonical, so roll back to absolute seats
            forced = np.roll(E.judge(cfg, states).cpu().numpy(), offset, 1)
            results_np = np.where(done_np[:, None], results_np, forced)
        scores = np.roll(E.all_scores(cfg, states).cpu().numpy(), offset, 1)
        return MatchResult(outcomes=results_np, scores=scores, moves=moves)


def fused_two_player_gate(env_cfg, raw_search_fn, new_bundle, old_bundle,
                          games: int, generator=None, chunk_moves: int = 16,
                          device="cuda") -> tuple[int, int, int]:
    """Gating with ``FusedMatch``: both seat orders, ``games // 2`` boards
    each."""
    half = max(games // 2, 1)
    match = FusedMatch(env_cfg, raw_search_fn, half, chunk_moves, device)
    r1 = match.play([new_bundle, old_bundle], generator)
    r2 = match.play([old_bundle, new_bundle], generator)
    w1, d1 = r1.tally([0, 1])
    w2, d2 = r2.tally([1, 0])
    return w1[0] + w2[0], w1[1] + w2[1], d1 + d2
