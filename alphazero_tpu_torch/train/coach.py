"""Self-play -> train -> arena-gate orchestrator: port of
``alphazero_tpu/train/coach.py``.

Each iteration plays ``games_per_iter`` self-play games in batches, adds
their examples to the replay buffer, fits the net on the buffer, then pits
the new net against the previous best with seat rotation and keeps or
rolls back the new weights (``gate_mode``).  Checkpoints, ``settings.json``,
``metrics.jsonl`` and the replay file have the JAX package's formats and
names, so a run can move between the packages.

Randomness: ``np.random.default_rng(cfg.seed)`` for the replay sampling
(the same draws as the JAX coach), a CPU ``torch.Generator`` seeded from
``cfg.seed`` for the net's initial weights, and one generator on the
device, seeded from ``cfg.seed``, for self-play, training and the gate.

Data parallel (``use_mesh``, active when a process group of W > 1 ranks
is initialized, ``parallel/distributed.py``): W must divide both
``selfplay_batch`` and ``batch_size`` (the JAX coach instead shrinks its
mesh to the largest device count that does).  Each rank plays its block
of every self-play batch on a generator seeded from ``(seed, rank)``, the
examples are gathered to every rank's replay, and the learner takes each
rank's rows of the same global minibatches (the same ``np_rng`` and device
generator on every rank).  Rank 0 plays the gate, on a generator of its
own, and broadcasts the decision; rank 0 writes the checkpoints,
``metrics.jsonl`` and the replay file, then ``sync_hosts``.  The
checkpoint directory must be one that every rank sees.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from ..eval import arena as AR
from ..games.splendor import adapter as A
from ..games.splendor import env as E
from ..models import splendor_net as N
from ..parallel import distributed as D
from ..parallel import mesh as MP
from ..search import mcts as M
from ..utils import checkpoint as CKPT
from ..utils.device import resolve_device
from . import selfplay as SP
from . import trainer as TR
from .replay import Iteration, ReplayBuffer

log = logging.getLogger(__name__)


def completed_iterations(checkpoint_dir: str) -> int:
    """Highest iteration number recorded in ``metrics.jsonl`` (0 when none):
    a restarted run picks up at the next iteration with monotone numbering
    in the same metrics file."""
    path = os.path.join(checkpoint_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return 0
    done = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                done = max(done, int(json.loads(line).get("iter", 0)))
            except (ValueError, KeyError, TypeError, AttributeError):
                # tolerate any malformed line ("iter": null, non-dict JSON,
                # truncated write at crash time)
                continue
    return done


@dataclasses.dataclass
class CoachConfig:
    """The JAX coach's configuration, field for field."""
    num_players: int = 2
    score_win: int = 15                  # rule variant lever (tests/smokes)
    num_iters: int = 50
    games_per_iter: int = 128            # numEps
    selfplay_batch: int = 128
    num_sims: int = 100
    ratio_full: int = 5
    prob_full: float = 0.25
    temp_threshold: int = 10
    cpuct: float = 1.0
    fpu: float = 0.0
    forced_playouts: bool = False
    dirichlet_alpha: float = 0.2
    prior_temp: float = 1.25
    tree_reuse: bool = False             # cross-move tree carryover in
                                         # self-play (cost: PERF.md)
    stage_sims: str = "auto"
    # training
    learn_rate: float = 3e-4
    vl_weight: float = 10.0
    batch_size: int = 32
    epochs: int = 2
    surprise_weight: bool = False
    val_split: float = 0.0               # held-out validation fraction
    dropout: float = 0.3
    nn_version: int = 1
    net_width: int = 128
    history: int = 5                     # numItersHistory
    max_examples_per_iter: int = 400_000
    # ramp the value-loss weight linearly over the first vl_warmup_iters
    # iterations (0 = off)
    vl_warmup_iters: int = 0
    # gating
    update_threshold: float = 0.6
    arena_games: int = 30
    gate_num_sims: int = 0                # 0 -> num_sims
    # "threshold": accept only past the (fair-share scaled) winrate bar,
    # else roll back; "always": every iteration's net becomes the new best,
    # the gate match is still recorded
    gate_mode: str = "threshold"
    # learning-curve probe vs random and greedy baselines (0 = off)
    eval_baseline_games: int = 0
    eval_num_sims: int = 0                # 0 -> gate sims
    # minibatch updates per train chunk (0 = one step at a time)
    train_chunk_steps: int = 64
    # shard self-play + training over the ranks of the process group, when
    # it has more than one (no effect in one process)
    use_mesh: bool = True
    checkpoint_dir: str = "./checkpoints"
    seed: int = 0


class Coach:
    def __init__(self, cfg: CoachConfig, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.env_cfg = E.SplendorConfig(num_players=cfg.num_players,
                                        score_win=cfg.score_win)
        self.net_cfg = A.net_config_for(self.env_cfg, dropout=cfg.dropout,
                                        nn_version=cfg.nn_version,
                                        width=cfg.net_width)
        self.eval_fn = A.make_eval_fn(self.net_cfg)
        self.np_rng = np.random.default_rng(cfg.seed)
        self.mesh = None
        world = D.world_size()
        if cfg.use_mesh and world > 1:
            if cfg.selfplay_batch % world or cfg.batch_size % world:
                raise ValueError(
                    f"world size {world} must divide selfplay_batch "
                    f"{cfg.selfplay_batch} and batch_size {cfg.batch_size}")
            self.mesh = MP.make_mesh()
            log.info("mesh: sharding over %d ranks", world)
        self._seed_generators(cfg.seed)

        self.train_state = TR.init_train_state(
            self.net_cfg, torch.Generator().manual_seed(cfg.seed),
            self.device)
        if self.mesh is not None:
            MP.replicate(self.mesh, self.train_state.net)
        self.train_cfg = TR.TrainConfig(
            learn_rate=cfg.learn_rate, vl_weight=cfg.vl_weight,
            batch_size=cfg.batch_size, epochs=cfg.epochs,
            val_split=cfg.val_split)
        self.eval_step = (TR.make_eval_step(self.env_cfg, self.net_cfg,
                                            self.train_cfg)
                          if cfg.val_split > 0 else None)
        self.train_step = TR.make_train_step(self.env_cfg, self.net_cfg,
                                             self.train_cfg, self.mesh)
        self.train_chunk = (TR.make_train_chunk(
            self.env_cfg, self.net_cfg, self.train_cfg, self.mesh)
            if cfg.train_chunk_steps > 0 else None)

        sp_cfg = SP.SelfPlayConfig(
            batch_size=cfg.selfplay_batch, num_sims=cfg.num_sims,
            ratio_full=cfg.ratio_full, prob_full=cfg.prob_full,
            temp_threshold=cfg.temp_threshold, cpuct=cfg.cpuct, fpu=cfg.fpu,
            forced_playouts=cfg.forced_playouts,
            dirichlet_alpha=cfg.dirichlet_alpha, prior_temp=cfg.prior_temp,
            tree_reuse=cfg.tree_reuse, stage_sims=cfg.stage_sims)
        self.selfplay = SP.SelfPlayEngine(self.env_cfg, self.eval_fn, sp_cfg,
                                          device=self.device, mesh=self.mesh)

        gate_sims = cfg.gate_num_sims or cfg.num_sims
        gate_mcfg = M.MCTSConfig(num_sims=gate_sims, cpuct=cfg.cpuct,
                                 fpu=cfg.fpu)
        self.gate_search = M.build_search(
            gate_mcfg, cfg.num_players, self.eval_fn,
            A.make_search_step_fn(self.env_cfg),
            A.make_valid_fn(self.env_cfg), self.device)
        self._gate_match = AR.FusedMatch(
            self.env_cfg, self.gate_search,
            max(cfg.arena_games // cfg.num_players, 1), device=self.device)

        self.replay = ReplayBuffer(history=cfg.history,
                                   max_per_iter=cfg.max_examples_per_iter)
        self._eval_arena = None        # built lazily on first baseline eval

    def _seed_generators(self, seed: int):
        """``gen`` from ``seed``; in one process self-play and the gate draw
        from it too.  Under a mesh, ``gen`` (training) stays the stream
        every rank shares, self-play draws from ``(seed, rank)`` and the
        gate from ``(seed, W)``, a stream no rank's self-play uses."""
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.sp_gen = self.gate_gen = self.gen
        if self.mesh is not None:
            self.sp_gen = D.rank_generator(seed, D.rank(), self.device)
            self.gate_gen = D.rank_generator(seed, D.world_size(),
                                             self.device)

    # ------------------------------------------------------------------ API
    @property
    def bundle(self):
        """What the searches evaluate with: the live net."""
        return self.train_state.net

    def _save(self, filename, opt=True, meta=None):
        """Rank 0 writes the checkpoint (every process, in one)."""
        if not D.is_primary():
            return
        params, bstats = N.to_flax(self.train_state.net.state_dict())
        CKPT.save_checkpoint(
            self.cfg.checkpoint_dir, filename, params=params,
            batch_stats=bstats,
            opt_state=TR.opt_state_to_flax(self.train_state) if opt else None,
            meta=dataclasses.asdict(self.cfg) if meta is None else meta)

    def _load_weights(self, ckpt):
        """Params and running statistics of a checkpoint into the live net
        (the Adam moments stay as they are)."""
        self.train_state.net.load_state_dict(
            N.from_flax(ckpt["params"], ckpt["batch_stats"]))

    def self_play_iteration(self):
        cfg = self.cfg
        its, stats_acc = [], {"games": 0, "examples": 0, "rollouts": 0}
        games_done = 0
        t0 = time.time()
        while games_done < cfg.games_per_iter:
            it, stats = self.selfplay.run_games(self.bundle, self.sp_gen)
            games_done += stats["games"]
            for s in ("games", "examples", "rollouts"):
                stats_acc[s] += stats[s]
            if it is not None:
                its.append(it)
        dt = time.time() - t0
        stats_acc["seconds"] = dt
        stats_acc["rollouts_per_s"] = stats_acc["rollouts"] / max(dt, 1e-9)
        if stats_acc["examples"] >= cfg.max_examples_per_iter:
            log.warning(
                "saturation of examples (%d >= max_examples_per_iter=%d): "
                "think about decreasing games_per_iter or raising the cap",
                stats_acc["examples"], cfg.max_examples_per_iter)
        if its:
            merged = Iteration(*(np.concatenate([getattr(i, f) for i in its])
                                 for f in ("boards", "pi", "winner", "scdiff",
                                           "valids", "surprise")))
            self.replay.add_iteration(merged)
        return stats_acc

    def train_iteration(self, it: int = 0):
        # value-loss warmup: ramp vl_weight linearly over the first
        # vl_warmup_iters iterations
        w = self.cfg.vl_warmup_iters
        vl_scale = min(1.0, max(it, 1) / w) if w > 0 else 1.0

        def save_intermediary(epoch, state, metrics):
            # rolling mid-train snapshot
            if epoch + 1 < self.train_cfg.epochs:
                self._save("intermediary.pt", opt=False,
                           meta={"epoch": epoch, **metrics})

        self.train_state, metrics = TR.fit(
            self.train_state, self.train_step, self.replay, self.train_cfg,
            self.np_rng, self.gen, surprise_weight=self.cfg.surprise_weight,
            eval_step_fn=self.eval_step, on_epoch_end=save_intermediary,
            train_chunk_fn=self.train_chunk,
            chunk_steps=self.cfg.train_chunk_steps,
            vl_scale=vl_scale, log_every=500)
        metrics["vl_scale"] = vl_scale
        if not np.isfinite(metrics.get("loss", 0.0)):
            # a diverged train step must not reach best.pt through the
            # gate: roll back to the pre-train snapshot and reset Adam,
            # whose moments are non-finite too
            log.error("non-finite train loss %s: rolling back to temp.pt",
                      metrics.get("loss"))
            if os.path.exists(os.path.join(self.cfg.checkpoint_dir,
                                           "temp.pt")):
                target = N.to_flax(self.train_state.net.state_dict())[0]
                self._load_weights(CKPT.load_network(
                    self.cfg.checkpoint_dir, "temp.pt", target))
                self.train_state = TR.reset_opt_state(self.train_state)
        return metrics

    def gate(self, old_bundle) -> tuple[bool, tuple[int, int, int]]:
        """New net vs previous best with full seat rotation: the candidate
        occupies each of the N seats in turn.  ``update_threshold`` keeps
        its 2-player meaning; with N players an equal net wins 1/N of
        decided games, so the bar scales by fair share
        (threshold * (1/N)/0.5)."""
        n = self.cfg.num_players
        nw = ow = dr = 0
        for r in range(n):
            seats = [self.bundle if p == r else old_bundle for p in range(n)]
            wins, d = self._gate_match.play(seats, self.gate_gen).tally(
                [0 if p == r else 1 for p in range(n)])
            nw += wins[0]
            ow += wins[1]
            dr += d
        bar = self.cfg.update_threshold * (1.0 / n) / 0.5
        accept = (nw + ow) > 0 and nw / (nw + ow) >= bar
        return accept, (nw, ow, dr)

    def eval_vs_baselines(self) -> dict:
        """The current net (gate search, temp=0) against the random and
        greedy baselines, rotating through every seat; winrates count draws
        0.5.  With N > 2 an equal agent scores the fair share 1/N, reported
        as ``eval_fair_share``."""
        cfg = self.cfg
        per_seat = max(cfg.eval_baseline_games // cfg.num_players, 1)
        if self._eval_arena is None:
            self._eval_arena = AR.BatchArena(self.env_cfg, per_seat,
                                             device=self.device)
            self._greedy_agent = AR.make_greedy_agent(self.env_cfg)
            self._random_agent = AR.make_random_agent(self._eval_arena.valids)
            eval_sims = (cfg.eval_num_sims or cfg.gate_num_sims
                         or cfg.num_sims)
            eval_mcfg = M.MCTSConfig(num_sims=eval_sims, cpuct=cfg.cpuct,
                                     fpu=cfg.fpu)
            self._eval_search = M.build_search(
                eval_mcfg, cfg.num_players, self.eval_fn,
                A.make_search_step_fn(self.env_cfg),
                A.make_valid_fn(self.env_cfg), self.device)
        net = AR.make_search_agent(self._eval_search, self.bundle)
        out = {}
        n = cfg.num_players
        for name, opp in (("random", self._random_agent),
                          ("greedy", self._greedy_agent)):
            w = l = d = 0
            for seat in range(n):
                agents = [net if p == seat else opp for p in range(n)]
                groups = [0 if p == seat else 1 for p in range(n)]
                wins, dr = self._eval_arena.play(agents, self.gate_gen).tally(
                    groups)
                w += wins[0]
                l += wins[1]
                d += dr
            out[f"wins_vs_{name}"] = w
            out[f"losses_vs_{name}"] = l
            out[f"draws_vs_{name}"] = d
            out[f"winrate_vs_{name}"] = (w + 0.5 * d) / max(w + l + d, 1)
        out["eval_fair_share"] = 1.0 / n
        return out

    def _append_metrics(self, record: dict):
        if not D.is_primary():
            return
        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.cfg.checkpoint_dir, "metrics.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def learn(self, on_iteration=None, start_iter: int = 1):
        """Run iterations ``start_iter .. num_iters`` (``num_iters`` is the
        total budget, so a resumed run continues the same monotone numbering
        in one metrics.jsonl; ``start_iter`` normally comes from
        ``completed_iterations``)."""
        cfg = self.cfg
        if start_iter > cfg.num_iters:
            log.info("run already complete (%d/%d iterations)",
                     start_iter - 1, cfg.num_iters)
            return
        if start_iter > 1:
            # de-correlate the resumed segment from a fresh run's draws
            seq = np.random.SeedSequence([cfg.seed, start_iter])
            self._seed_generators(int(seq.generate_state(1)[0]))
            self.np_rng = np.random.default_rng(seq)
        if D.is_primary():
            CKPT.save_settings(cfg.checkpoint_dir, dataclasses.asdict(cfg))
            CKPT.save_code_snapshot(cfg.checkpoint_dir)
        for it in range(start_iter, cfg.num_iters + 1):
            t_iter = time.time()
            log.info("Iter %d: self-play...", it)
            sp_stats = self.self_play_iteration()
            log.info("Iter %d: %d examples, %.0f rollouts/s", it,
                     sp_stats["examples"], sp_stats["rollouts_per_s"])
            if D.is_primary():
                self.replay.save(os.path.join(cfg.checkpoint_dir,
                                              "checkpoint.examples"))

            # the previous best plays the gate; training updates the live
            # net in place
            old_bundle = copy.deepcopy(self.bundle)
            self._save("temp.pt")
            D.sync_hosts("temp.pt")        # every rank may roll back to it
            metrics = self.train_iteration(it)
            log.info("Iter %d: train %s", it, metrics)

            # rank 0 plays the gate and broadcasts its decision
            accept, (nw, ow, dr) = D.replicate_from_host0(
                self.gate(old_bundle) if D.is_primary() else None)
            gate_passed = accept
            if cfg.gate_mode == "always":
                accept = True
            if accept:
                log.info("Iter %d: new vs prev %d-%d (%d draws) ACCEPTED",
                         it, nw, ow, dr)
                self._save(f"checkpoint_{it}.pt")
                self._save("best.pt")
            else:
                log.info("Iter %d: new vs prev %d-%d (%d draws) REJECTED",
                         it, nw, ow, dr)
                self._load_weights(CKPT.load_checkpoint(cfg.checkpoint_dir,
                                                        "temp.pt"))
            record = {
                "iter": it,
                **{f"selfplay_{k}": v for k, v in sp_stats.items()},
                **{f"train_{k}": v for k, v in metrics.items()},
                "gate_new": nw, "gate_old": ow, "gate_draws": dr,
                # decided-game winrate with its binomial stderr
                "gate_winrate": nw / max(nw + ow, 1),
                "gate_bar": cfg.update_threshold * (1.0 / cfg.num_players)
                            / 0.5,
                "gate_stderr": float(np.sqrt(
                    max(nw * ow, 1)) / max(nw + ow, 1) ** 1.5),
                "accepted": accept,
                "gate_passed_bar": gate_passed,
                "gate_mode": cfg.gate_mode,
                "replay_examples": len(self.replay),
            }
            if cfg.eval_baseline_games > 0 and D.is_primary():
                ev = self.eval_vs_baselines()
                record.update(ev)
                log.info("Iter %d: winrate vs random %.2f, vs greedy %.2f",
                         it, ev["winrate_vs_random"], ev["winrate_vs_greedy"])
            record["iter_seconds"] = time.time() - t_iter
            self._append_metrics(record)
            D.sync_hosts(f"iter {it}")
            if on_iteration:
                on_iteration(it, sp_stats, metrics, (nw, ow, dr), accept)

    # --------------------------------------------------------------- resume
    def load_checkpoint(self, folder, filename, load_examples=True,
                        fallback=False):
        """Weights (strict, or a partial transfer across architectures),
        the replay buffer and, on a strict load, the Adam moments.  Sibling
        checkpoints are tried only with ``fallback``."""
        target, target_bs = N.to_flax(self.train_state.net.state_dict())
        ckpt = CKPT.load_network(folder, filename, target, fallback=fallback,
                                 target_batch_stats=target_bs)
        ex_path = os.path.join(folder, "checkpoint.examples")
        if load_examples and os.path.exists(ex_path):
            self.replay = ReplayBuffer.load(
                ex_path, history=self.cfg.history,
                max_per_iter=self.cfg.max_examples_per_iter)
            log.info("resumed %d replay examples from %s",
                     len(self.replay), ex_path)
        self._load_weights(ckpt)
        if ckpt.get("opt_state") is not None and ckpt["load_mode"] == "strict":
            # resume the Adam moments so a crash-restart does not silently
            # reset the optimizer mid-run
            try:
                self.train_state = TR.load_opt_state(self.train_state,
                                                     ckpt["opt_state"])
                log.info("restored optimizer state from checkpoint")
            except (KeyError, ValueError, TypeError) as e:
                log.warning("optimizer state in checkpoint incompatible "
                            "(%s); starting with fresh moments", e)
                self.train_state = TR.reset_opt_state(self.train_state)
        diff = CKPT.compare_settings(folder, dataclasses.asdict(self.cfg))
        if diff:
            log.info("settings changed vs checkpoint: %s", diff)
        return ckpt.get("meta", {})
