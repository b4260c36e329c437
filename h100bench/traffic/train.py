"""Train traffic: back-to-back ``trainer.fit`` calls (one epoch each, chunks
of ``make_train_chunk``) of the configuration's net and ``TrainConfig``
over a seeded synthetic replay buffer of legal positions.

Parameters (the cell's ``params``): ``buffer_games`` random legal games of
the reference env, snapshotted ``snapshots`` times every
``snapshot_every`` plies (the buffer holds their product of positions,
each with a policy target over its valid moves, a winner and a score
difference); ``chunk_steps``, the steps of a chunk; ``trace_chunks``, the
chunks of the traced slice.  The train state starts from the
checkpoint's weights with fresh Adam moments.

Set-up drives that train state through its first three steps with the
chunk function and the replay's own sampling (one step, then two), and
hands the same state to the window; the check holds those steps to the
reference's (``reference/train.py``) on the same rows and the same
generator draws.  The window's rate is the steps of every whole ``fit``
call over the window's wall time."""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import core, program, trace, work
from h100bench.reference import env as RE
from h100bench.reference import train as RT

FIRST_STEPS = 3


@torch.no_grad()
def synthetic_buffer(ecfg: RE.SplendorConfig, games: int, snapshots: int,
                     every: int, seed: int, device) -> dict:
    """Positions of seeded random legal play (a board whose next move
    would end its game stays where it is), with targets: a policy drawn
    over the valid moves, the mover's score difference to each seat and a
    winner vector that agrees with it.  Numpy arrays by field."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = ecfg.num_players
    s = RE.initial_state(ecfg, games, gen, dev)
    out = []
    for ply in range(snapshots * every):
        v = RE.valid_moves(ecfg, s, 0)
        a = torch.where(v, torch.rand(v.shape, generator=gen, device=dev),
                        -1.0).argmax(-1)
        u = torch.rand(games, 2, generator=gen, device=dev)
        s2, _ = RE.step(ecfg, s, a, 0, u, False)
        s2 = RE.swap_players(ecfg, s2, 1)
        ends = RE.check_end_game(ecfg, s2).abs().sum(-1) > 0
        s = torch.where(ends[:, None, None], s, s2)
        if ply % every == every - 1:
            out.append(s)
    boards = torch.cat(out)
    N = boards.shape[0]
    valids = RE.valid_moves(ecfg, boards, 0)
    w = torch.rand(valids.shape, generator=gen, device=dev) ** 4
    pi = torch.where(valids, w, 0.0)
    pi = pi / pi.sum(-1, keepdim=True)
    sd = torch.randint(-15, 16, (N, n), generator=gen, device=dev)
    sd[:, 0] = 0
    best = torch.cat([torch.zeros(N, 1, device=dev, dtype=sd.dtype),
                      sd[:, 1:]], 1)
    win = torch.where(best == best.max(1, keepdim=True).values, 1.0, -1.0)
    return {"boards": boards.cpu().numpy(),
            "pi": pi.to(torch.float16).cpu().numpy(),
            "winner": win.to(torch.float16).cpu().numpy(),
            "scdiff": sd.to(torch.int8).cpu().numpy(),
            "valids": valids.cpu().numpy(),
            "surprise": np.zeros((N, n), np.float16)}


def flax_name(name: str) -> str:
    """The Flax path of a parameter of the program's state dict
    (``gpool_0.dense.weight`` -> ``DenseAndPartialGPool_0/Dense_0/kernel``
    for a matrix, ``.../scale`` for a BatchNorm weight)."""
    kinds = {"dense": "Dense", "bn": "BatchNorm",
             "gpool": "DenseAndPartialGPool"}
    *mods, leaf = name.split(".")
    head, k = mods[0].rsplit("_", 1)
    path = [f"{kinds[head]}_{k}"] + [{"dense": "Dense_0",
                                      "bn": "BatchNorm_0"}[m]
                                     for m in mods[1:]]
    if leaf == "weight":
        leaf = "kernel" if path[-1].startswith("Dense") else "scale"
    return "/".join(path + [leaf])


def leaf_gaps(got: dict, ref: dict, counted=None) -> float:
    """The largest gap between two sets of per-leaf norms, each as a share
    of the reference's norm of that leaf or of the median leaf, whichever
    is larger; ``counted`` limits the leaves."""
    keys = [k for k in ref if counted is None or k in counted]
    med = float(np.median([ref[k] for k in ref]))
    return max(abs(got[k] - ref[k]) / max(ref[k], med) for k in keys)


class Cell:
    def __init__(self, ctx: core.Context):
        self.ctx, self.cfg, self.p = ctx, ctx.config, ctx.cell["params"]
        self.dev = ctx.device
        self.fits = []               # (steps, loss)

    def setup(self):
        from alphazero_tpu_torch.games.splendor import adapter as A
        from alphazero_tpu_torch.models import splendor_net as N
        from alphazero_tpu_torch.train import replay as RP
        from alphazero_tpu_torch.train import trainer as TR
        c, dev = self.cfg, self.dev
        self.TR = TR
        self.ck = program.checkpoint(self.ctx.root, c)
        self.ecfg = program.env_config(c)
        self.ref_ecfg = program.ref_env_config(c)
        buf = synthetic_buffer(self.ref_ecfg, int(self.p["buffer_games"]),
                               int(self.p["snapshots"]),
                               int(self.p["snapshot_every"]),
                               core.derived_seed(self.ctx.seed, 1 << 30), dev)
        self.replay = RP.ReplayBuffer(history=c["history"],
                                      max_per_iter=c["max_examples_per_iter"])
        self.replay.add_iteration(RP.Iteration(**buf))
        net_cfg = A.net_config_for(self.ecfg, dropout=c["dropout"],
                                   nn_version=c["nn_version"],
                                   width=c["net_width"])
        self.state = TR.init_train_state(net_cfg, device=dev)
        self.state.net.load_state_dict(
            N.from_flax(self.ck["params"], self.ck["batch_stats"]))
        self.tcfg = TR.TrainConfig(learn_rate=c["learn_rate"],
                                   vl_weight=c["vl_weight"],
                                   batch_size=c["batch_size"], epochs=1,
                                   augment=True)
        self.K = int(self.p["chunk_steps"])
        self.chunk = TR.make_train_chunk(self.ecfg, net_cfg, self.tcfg)
        self.gen = torch.Generator(device=dev).manual_seed(
            core.derived_seed(self.ctx.seed, 1))
        self.rng = np.random.default_rng([core.seed_entropy(self.ctx.seed),
                                          2])
        B = c["batch_size"]
        batches = max(len(self.replay) // B, 1)
        self.fit_steps = max(int(round(batches / self.K)), 1) * self.K
        self._first_steps()
        # every shape of the window: a whole chunk of its steps
        self._chunk_call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _params(self) -> dict:
        return {k: p.detach().clone()
                for k, p in self.state.net.named_parameters()}

    def _first_steps(self):
        """Steps 1-3 through the chunk function on rows the replay draws:
        the losses, the first gradient worked out from Adam's state after
        step 1, and the parameters before and after."""
        B, TR = self.cfg["batch_size"], self.TR
        raw = self.replay.sample(FIRST_STEPS * B, self.rng)
        batches = {k: v.reshape((FIRST_STEPS, B) + v.shape[1:])
                   for k, v in raw.items()}
        lrs = [float(np.float32(TR.onecycle_lr(j, self.fit_steps,
                                               self.tcfg.learn_rate)))
               for j in range(FIRST_STEPS)]
        vlw = self.tcfg.vl_weight
        gen_state = self.gen.get_state()
        p0 = self._params()
        self.state, s1 = self.chunk(self.state,
                                    {k: v[:1] for k, v in batches.items()},
                                    lrs[:1], vlw, self.gen, per_step=True)
        beta1 = self.state.opt.param_groups[0]["betas"][0]
        params = dict(self.state.net.named_parameters())
        grad1 = {k: self.state.opt.state[p]["exp_avg"] / (1 - beta1)
                 for k, p in params.items()}
        self.state, s23 = self.chunk(self.state,
                                     {k: v[1:] for k, v in batches.items()},
                                     lrs[1:], vlw, self.gen, per_step=True)
        p3 = self._params()
        losses = torch.cat([s1["loss"], s23["loss"]]).tolist()
        self.first = {
            "batches": batches, "lrs": lrs, "gen_state": gen_state,
            "losses": losses,
            "grad": {flax_name(k): float(g.norm()) for k, g in grad1.items()},
            "change": {flax_name(k): float((p3[k] - p0[k]).norm())
                       for k in p0}}

    def _chunk_call(self):
        B, TR = self.cfg["batch_size"], self.TR
        raw = self.replay.sample(B * self.K, self.rng)
        batches = {k: v.reshape((self.K, B) + v.shape[1:])
                   for k, v in raw.items()}
        lrs = [float(np.float32(TR.onecycle_lr(j, self.fit_steps,
                                               self.tcfg.learn_rate)))
               for j in range(self.K)]
        self.state, m = self.chunk(self.state, batches, lrs,
                                   self.tcfg.vl_weight, self.gen)
        return m

    def window(self, seconds: float) -> dict:
        TR = self.TR
        steps, t0 = 0, time.perf_counter()
        while not self.fits or time.perf_counter() - t0 < seconds:
            before = self.state.step
            self.state, m = TR.fit(self.state, None, self.replay, self.tcfg,
                                   self.rng, self.gen,
                                   train_chunk_fn=self.chunk,
                                   chunk_steps=self.K)
            self.fits.append((self.state.step - before, m["loss"]))
            steps += self.state.step - before
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.window_s = time.perf_counter() - t0
        return {"train_steps_per_s": steps / self.window_s}

    def traced(self):
        n = int(self.p["trace_chunks"])
        with trace.traced(self.dev) as prof:
            for _ in range(n):
                self._chunk_call()
        c, P = self.cfg, self.cfg["num_players"]
        steps = sum(s for s, _ in self.fits)
        return (trace.reduce(*trace.events(prof)),
                {"steps": n * self.K, "window_s": self.window_s,
                 "window_flops": steps * c["batch_size"]
                 * work.train_step_flops(work.rows(P), c["net_width"], 409,
                                         P)})

    def release(self):
        del self.state, self.chunk

    # ----------------------------------------------------------------- check
    def reference_steps(self, tf32: bool = False, rows=None) -> dict:
        """The reference's first three steps on the same rows and draws:
        the losses, the first gradient's and the change's norms per leaf."""
        c, dev, f = self.cfg, self.dev, self.first
        P = RT.flat_params(self.ck["params"], dev)
        p0 = {k: v.clone() for k, v in P.items()}
        opt = RT.Adam({k: torch.zeros_like(v) for k, v in P.items()},
                      {k: torch.zeros_like(v) for k, v in P.items()}, 0)
        gen = torch.Generator(device=dev)
        gen.set_state(f["gen_state"])
        losses, grad = [], None
        for j in range(FIRST_STEPS):
            batch = {k: torch.as_tensor(v[j]).to(dev)
                     for k, v in f["batches"].items()}
            value, g = RT.train_step(self.ref_ecfg, P, opt, batch, f["lrs"][j],
                                     self.tcfg.vl_weight, c["dropout"],
                                     c["net_width"], gen, tf32=tf32,
                                     rows=rows)
            losses.append(value)
            grad = grad or {k: float(t.norm()) for k, t in g.items()}
        return {"losses": losses, "grad": grad,
                "change": {k: float((P[k] - p0[k]).norm()) for k in P}}

    def gaps(self, got: dict, ref: dict) -> dict:
        """The check's numbers between a side's first steps and the
        reference's.  The change counts the leaves whose reference
        gradient is at least a thousandth of the median leaf's."""
        med = float(np.median(list(ref["grad"].values())))
        counted = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}
        loss = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], ref["losses"]))
        return {"loss_gap": loss,
                "grad_gap": leaf_gaps(got["grad"], ref["grad"]),
                "change_gap": leaf_gaps(got["change"], ref["change"], counted)}

    def control(self) -> dict:
        return self.gaps(self.reference_steps(tf32=True),
                         self.reference_steps())

    def half_batch(self) -> dict:
        """The fault of half of the batch left out, the mean taken over the
        rest, in the reference put in the program's place."""
        B = self.cfg["batch_size"]
        return self.gaps(self.reference_steps(rows=slice(0, B // 2)),
                         self.reference_steps())

    def check(self):
        g = self.gaps(self.first, self.reference_steps())
        bad = sum(1 for _, loss in self.fits if not np.isfinite(loss))
        lim = self.ctx.cell["limits"]
        checks = [(n, g[n], lim[n]) for n in
                  ("loss_gap", "grad_gap", "change_gap")]
        checks.append(("nonfinite_fits", float(bad), lim["nonfinite_fits"]))
        return checks, len(self.fits), bad
