"""Single-board move traffic: ``cli/pit.py::MCTSPlayer.play`` at B=1, one
client in a closed loop with no think time, each request a position drawn
in seeded order from a pool of mid-game positions.

Parameters (the cell's ``params``): ``num_sims``, the player's
simulations; ``pool``, the number of positions; ``pool_seed``; ``rounds``,
the [lowest, highest] round a position is taken at; ``trace_requests``,
the requests of the traced slice; ``check_requests``, how many of the
window's requests (drawn from the seed) the reference searches again.
The pool is made at set-up by random playouts of the reference env from
``pool_seed``, every board in the mover's canonical frame, none of them
ended: every run serves the same positions, each in the order its own
seed draws, so that the seed changes the order of the work and not the
work (a window cycles through the pool about three times).

A request runs from the ``play(board)`` call to the returned action; the
window's metric is the 90th percentile of every request's latency.  The
check holds every returned action to the argmax of the counts of its own
search and to the position's valid moves, and the sampled requests'
searches to the reference's search of the same position."""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import core, program, trace
from h100bench.reference import env as RE
from h100bench.reference import search as RS


@torch.no_grad()
def position_pool(ecfg: RE.SplendorConfig, n: int, rounds, seed: int,
                  device) -> torch.Tensor:
    """``n`` positions of random legal play, each taken at a round drawn
    uniformly from ``rounds`` (inclusive), in the mover's canonical frame;
    boards whose game ended are replaced from a larger batch."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = 2 * n
    states = RE.initial_state(ecfg, B, gen, dev)
    lo, hi = rounds
    target = torch.randint(lo * ecfg.num_players, (hi + 1) * ecfg.num_players,
                           (B,), generator=gen, device=dev)
    ended = torch.zeros(B, dtype=torch.bool, device=dev)
    for ply in range(int(target.max())):
        valid = RE.valid_moves(ecfg, states, 0)
        u = torch.rand(valid.shape, generator=gen, device=dev)
        actions = torch.where(valid, u, -1.0).argmax(-1)
        chance = torch.rand(B, 2, generator=gen, device=dev)
        s2, _ = RE.step(ecfg, states, actions, 0, chance, False)
        s2 = RE.swap_players(ecfg, s2, 1)
        live = (ply < target) & ~ended
        states = torch.where(live[:, None, None], s2, states)
        ended |= live & RE.check_end_game(ecfg, states).abs().sum(-1).gt(0)
    keep = torch.nonzero(~ended)[:, 0][:n]
    if len(keep) < n:
        raise RuntimeError(f"only {len(keep)} of {n} playouts did not end")
    return states[keep]


class Cell:
    def __init__(self, ctx: core.Context):
        self.ctx, self.cfg, self.p = ctx, ctx.config, ctx.cell["params"]
        self.dev = ctx.device
        self.requests = []          # (pool index, action, record)
        self.log = []

    def setup(self):
        from alphazero_tpu_torch.cli.pit import MCTSPlayer
        from alphazero_tpu_torch.games.game_api import SplendorGame
        self.ck = program.checkpoint(self.ctx.root, self.cfg)
        self.net, _ = program.build_net(self.cfg, self.ck, self.dev)
        game = SplendorGame(num_players=self.cfg["num_players"],
                            device=self.dev)
        self.ref_ecfg = program.ref_env_config(self.cfg)
        if game.cfg.score_win != self.cfg["score_win"]:
            raise ValueError("the pit's game and the configuration differ")
        log = self.log

        class Player(MCTSPlayer):
            """The pit's player, its search recorded."""
            @property
            def search(self):
                s = super().search
                if getattr(self, "_rec", None) is None or self._rec.search \
                        is not s:
                    self._rec = program.Recorder(s, "move", log)
                return self._rec

        self.player = Player(game, self.net, int(self.p["num_sims"]),
                             cpuct=self.cfg["cpuct"], fpu=self.cfg["fpu"],
                             temp=0.0)
        pool = position_pool(self.ref_ecfg, int(self.p["pool"]),
                             self.p["rounds"],
                             core.derived_seed(int(self.p["pool_seed"]),
                                               1 << 30), self.dev)
        self.pool = pool.cpu().numpy()
        rng = np.random.default_rng([core.seed_entropy(self.ctx.seed), 3])
        self.order = rng.permutation(len(self.pool))
        # the one shape of the window: a B=1 search, twice
        for i in (0, 1):
            self.player.play(self.pool[self.order[-1 - i]])
        self.log.clear()

    def _request(self):
        i = int(self.order[len(self.requests) % len(self.order)])
        t = time.perf_counter()
        a = self.player.play(self.pool[i])
        lat = time.perf_counter() - t
        self.requests.append((i, a, self.log[-1]))
        return lat

    def window(self, seconds: float) -> dict:
        lats, t0 = [], time.perf_counter()
        while not lats or time.perf_counter() - t0 < seconds:
            lats.append(self._request())
        self.window_n = len(self.requests)
        self.latencies = lats
        return {"move_ms_p90": float(np.percentile(lats, 90)) * 1e3}

    def traced(self):
        n = int(self.p["trace_requests"])
        with trace.traced(self.dev) as prof:
            for _ in range(n):
                self._request()
        return (trace.reduce(*trace.events(prof)),
                {"sims": n * int(self.p["num_sims"]),
                 "requests": n})

    def release(self):
        del self.player, self.net

    def judged(self) -> list:
        """The recorded searches of the sampled requests."""
        rng = np.random.default_rng([core.seed_entropy(self.ctx.seed), 5])
        pick = rng.choice(self.window_n, size=min(
            int(self.p["check_requests"]), self.window_n), replace=False)
        return [self.requests[k][2] for k in sorted(pick)]

    def _ref_search(self, rec, net) -> dict:
        c = self.cfg
        scfg = RS.SearchConfig(num_sims=int(self.p["num_sims"]),
                               cpuct=c["cpuct"], fpu=c["fpu"])
        return RS.run(scfg, self.ref_ecfg, net, rec.roots)

    def search_gaps(self, judged_side) -> dict:
        net = program.ref_net(self.cfg, self.ck, self.dev)
        gaps = {}
        for rec in self.judged():
            g = program.compare_search(judged_side(rec),
                                       self._ref_search(rec, net))
            gaps = {n: max(v, gaps.get(n, 0.0)) for n, v in g.items()}
        return gaps

    def control(self) -> dict:
        net = program.ref_net(self.cfg, self.ck, self.dev, tf32=True)
        return self.search_gaps(lambda rec: self._ref_search(rec, net))

    def check(self):
        # every answer: the argmax of its own search's counts, and legal
        acts = torch.tensor([a for _, a, _ in self.requests])
        best = torch.stack([r.counts[0] for _, _, r in self.requests]) \
            .argmax(-1).cpu()
        pos = torch.as_tensor(self.pool[[i for i, _, _ in self.requests]],
                              device=self.dev)
        legal = RE.valid_moves(self.ref_ecfg, pos, 0).cpu()
        answer_diffs = int(((acts != best)
                            | ~legal[torch.arange(len(acts)), acts]).sum())
        gaps = self.search_gaps(lambda rec: rec._asdict())
        lim = self.ctx.cell["limits"]
        checks = [("answer_diffs", float(answer_diffs), lim["answer_diffs"])]
        checks += [(n, gaps[n], lim[n]) for n in
                   ("value_gap", "prior_gap", "q_gap")]
        return checks, len(self.requests), answer_diffs
