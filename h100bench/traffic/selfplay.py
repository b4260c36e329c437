"""Self-play traffic: back-to-back ``SelfPlayEngine.run_games`` calls of the
configuration's actor, fresh trees, each call ``plies`` moves of
``selfplay_batch`` new games from a generator seeded by (seed, call).

Parameters (the cell's ``params``): ``plies``, the moves each call plays;
``trace_plies``, the moves of the traced slice's one call; ``check_plies``,
how many of the window's moves (drawn from the seed) have both their
searches replayed by the reference.  The window's rate is the rollouts
that ``run_games`` counted over every whole call, over the window's wall
time; a call starts only while time remains and none is cut.

The check replays every call's actor move by move (``reference/actor.py``)
and the sampled moves' full and fast searches (``reference/search.py``),
with the same roots and the same Dirichlet draws."""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from h100bench import core, program, trace, work
from h100bench.reference import actor as RA
from h100bench.reference import search as RS


class Cell:
    def __init__(self, ctx: core.Context):
        self.ctx, self.cfg, self.p = ctx, ctx.config, ctx.cell["params"]
        self.dev = ctx.device
        # (generator seed, plies, search records, examples, rollouts)
        self.calls = []

    # ---------------------------------------------------------------- set-up
    def _actor_config(self, plies: int):
        from alphazero_tpu_torch.train import selfplay as SP
        c = self.cfg
        return SP.SelfPlayConfig(
            batch_size=c["selfplay_batch"], num_sims=c["num_sims"],
            ratio_full=c["ratio_full"], prob_full=c["prob_full"],
            temp_threshold=c["temp_threshold"], cpuct=c["cpuct"],
            fpu=c["fpu"], forced_playouts=c["forced_playouts"],
            dirichlet_alpha=c["dirichlet_alpha"], prior_temp=c["prior_temp"],
            max_depth=c["max_depth"], max_moves=plies, chunk_moves=plies,
            tree_reuse=False)

    def _engine(self, plies: int):
        """The program's actor at the configuration playing ``plies`` moves
        a call, its two searches wrapped in recorders (``_call`` gives them
        each call's log)."""
        from alphazero_tpu_torch.games.splendor import adapter as A
        from alphazero_tpu_torch.train import selfplay as SP
        eng = SP.SelfPlayEngine(self.ecfg, A.make_eval_fn(self.net_cfg),
                                self._actor_config(plies), device=self.dev)
        eng.search_full = program.Recorder(eng.search_full, "full", [])
        eng.search_fast = program.Recorder(eng.search_fast, "fast", [])
        return eng

    def setup(self):
        self.ck = program.checkpoint(self.ctx.root, self.cfg)
        self.ecfg = program.env_config(self.cfg)
        self.ref_ecfg = program.ref_env_config(self.cfg)
        self.net, self.net_cfg = program.build_net(self.cfg, self.ck, self.dev)
        self.engine = self._engine(int(self.p["plies"]))
        # every shape of the window: both searches and the actor's moves
        warm = self._engine(1)
        warm.run_games(self.net, torch.Generator(device=self.dev).manual_seed(
            core.derived_seed(self.ctx.seed, 1 << 30)), collect=True)

    def _call(self, engine, plies: int):
        k = len(self.calls)
        seed = core.derived_seed(self.ctx.seed, k)
        log = []
        engine.search_full.log = engine.search_fast.log = log
        it, stats = engine.run_games(
            self.net, torch.Generator(device=self.dev).manual_seed(seed))
        ex = (None if it is None else
              {f.name: getattr(it, f.name) for f in dataclasses.fields(it)})
        self.calls.append((seed, plies, log, ex, stats["rollouts"]))
        return stats["rollouts"]

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        plies = int(self.p["plies"])
        rollouts, t0 = 0, time.perf_counter()
        while not self.calls or time.perf_counter() - t0 < seconds:
            rollouts += self._call(self.engine, plies)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.window_s = time.perf_counter() - t0
        self.window_calls = len(self.calls)
        return {"rollouts_per_s": rollouts / self.window_s}

    def _sims(self) -> dict:
        """Simulations of each search kind."""
        S = self.cfg["num_sims"]
        return {"full": S, "fast": max(S // self.cfg["ratio_full"], 2)}

    def _leaf_evals(self, calls) -> int:
        """Boards evaluated by the net: each search's roots once and its
        boards once per simulation."""
        sims = self._sims()
        return sum(r.roots.shape[0] * (sims[r.kind] + 1)
                   for c in calls for r in c[2])

    def traced(self):
        plies = int(self.p["trace_plies"])
        engine = self._engine(plies)
        with trace.traced(self.dev) as prof:
            self._call(engine, plies)
        reduced = trace.reduce(*trace.events(prof))
        recs, sims = self.calls[-1][2], self._sims()
        P = self.cfg["num_players"]
        launches = [(r.roots.shape[0], sims[r.kind]) for r in recs]
        flops = work.forward_flops(work.rows(P), self.cfg["net_width"], 409, P)
        counts = {
            "sims": sum(s for _, s in launches),
            "env_step_bytes": sum(work.env_step_bytes(b, P) * s
                                  for b, s in launches),
            "env_step_launches": sum(s for _, s in launches),
            "window_s": self.window_s,
            "window_flops": flops * self._leaf_evals(
                self.calls[:self.window_calls]),
        }
        return reduced, counts

    def release(self):
        del self.engine, self.net

    # ----------------------------------------------------------------- check
    def _ref_search(self, rec: program.Record, net) -> dict:
        c = self.cfg
        if rec.kind == "full":
            scfg = RS.SearchConfig(
                num_sims=c["num_sims"], cpuct=c["cpuct"], fpu=c["fpu"],
                forced_playouts=c["forced_playouts"],
                dirichlet_alpha=c["dirichlet_alpha"],
                prior_temp=c["prior_temp"], add_noise=True,
                max_depth=c["max_depth"])
            g = torch.Generator(device=self.dev)
            g.set_state(rec.state_in)
            alpha = torch.full((rec.roots.shape[0], 409), c["dirichlet_alpha"],
                               dtype=torch.float32, device=self.dev)
            gamma = torch._standard_gamma(alpha, generator=g)
        else:
            scfg = RS.SearchConfig(
                num_sims=self._sims()["fast"], cpuct=c["cpuct"],
                fpu=c["fpu"], max_depth=c["max_depth"])
            gamma = None
        return RS.run(scfg, self.ref_ecfg, net, rec.roots, gamma)

    def sampled_moves(self) -> list[tuple[int, int]]:
        """(call, move) pairs whose searches the reference replays, drawn
        from the seed among the window's calls."""
        rng = np.random.default_rng([core.seed_entropy(self.ctx.seed), 7])
        pairs = [(k, m) for k, c in enumerate(self.calls[:self.window_calls])
                 for m in range(c[1])]
        pick = rng.choice(len(pairs), size=min(int(self.p["check_plies"]),
                                               len(pairs)), replace=False)
        return [pairs[i] for i in sorted(pick)]

    def judged(self) -> list:
        """The recorded searches the reference replays: both searches of
        each sampled move."""
        return [rec for k, m in self.sampled_moves()
                for rec in self.calls[k][2][2 * m:2 * m + 2]]

    def search_gaps(self, judged_side) -> dict:
        """The largest gaps over the judged searches between
        ``judged_side(rec)`` (a search's outputs) and the reference."""
        net = program.ref_net(self.cfg, self.ck, self.dev)
        gaps = {}
        for rec in self.judged():
            g = program.compare_search(judged_side(rec),
                                       self._ref_search(rec, net))
            gaps = {n: max(v, gaps.get(n, 0.0)) for n, v in g.items()}
        return gaps

    def control(self) -> dict:
        """The gaps of the control: the reference in TF32 in the program's
        place."""
        net = program.ref_net(self.cfg, self.ck, self.dev, tf32=True)
        return self.search_gaps(lambda rec: self._ref_search(rec, net))

    def check(self):
        c = self.cfg
        acfg = dict(batch_size=c["selfplay_batch"], num_sims=c["num_sims"],
                    ratio_full=c["ratio_full"], prob_full=c["prob_full"],
                    temp_threshold=c["temp_threshold"])
        diffs, failed = 0, 0
        for seed, plies, log, ex, rollouts in self.calls:
            d = RA.replay(self.ref_ecfg, RA.ActorConfig(plies=plies, **acfg),
                          seed, log, ex, rollouts, self.dev)
            diffs += len(d)
            failed += bool(d)
            for line in d[:5]:
                print(f"actor: {line}", file=sys.stderr)
        gaps = self.search_gaps(lambda rec: rec._asdict())
        lim = self.ctx.cell["limits"]
        checks = [("actor_diffs", float(diffs), lim["actor_diffs"])]
        checks += [(n, gaps[n], lim[n]) for n in
                   ("value_gap", "prior_gap", "q_gap", "visits_tv")]
        return checks, len(self.calls), failed
