"""Self-play traffic with SplendorNet version 3 (Leela Chess Zero's BT4
encoder transformer) as the leaf evaluator: ``traffic/selfplay.py``'s
back-to-back ``run_games`` calls, with the configuration's net in its
``dtype``, its every weight drawn here from the pinned ``weights_seed``
(``draw_state``; no checkpoint) and loaded into the program's net.

The check has two parts.  The searches: every call's actor is replayed as
in ``selfplay.py``, and the judged searches are held to the reference
search (``reference/search.py``) driven by the program's own evaluator, so
that both sides see the same net outputs.  The net: the program's
evaluations that the reference search asked for, of every judged search's
roots and of the leaf batch of every ``net_every``-th simulation, are held
to the float32 reference net (``reference/bt4.py``) on the same boards and
the same drawn weights (``net_value_gap``, ``net_prior_gap``: the largest
gaps of a value and of a prior).  The controls put other sides in the
bf16 program's place on the same boards: the program with a float32 trunk
(far under the limits), the reference rounded to float8 e4m3 after every
Dense of the trunk, and the reference without the Dense biases or without
the norms' and the gating's affine parts (each over a limit); and, to
show what rounding alone gives, the reference rounded to bf16 after every
Dense of the trunk."""

from __future__ import annotations

import math

import torch

from h100bench import core, program, work, work_bt4
from h100bench.reference import bt4 as RB

SP = core.module("traffic", "selfplay")
FP8_MAX = 448.0             # the largest finite float8 e4m3 number
SPREAD = 0.2                # std of the drawn biases, scales, multiplies, adds


def net_config(cfg: dict, dtype: str | None = None):
    """The program's ``NetConfig`` for the configuration (its trunk in
    ``dtype``, else the configuration's)."""
    from alphazero_tpu_torch.games.splendor import adapter as A
    return A.net_config_for(
        program.env_config(cfg), dropout=cfg["dropout"],
        nn_version=cfg["nn_version"], width=cfg["net_width"],
        dtype=dtype or cfg["dtype"], layers=cfg["net_layers"],
        heads=cfg["net_heads"], ffn=cfg["net_ffn"],
        smolgen=tuple(cfg["net_smolgen"]))


def draw_state(shapes: dict, seed: int) -> dict:
    """Every tensor of a version-3 state dict, by name in sorted order,
    drawn on the CPU from ``seed``: a Dense kernel ``(out, in)`` from
    U(-sqrt(6/in), sqrt(6/in)); a Dense or norm bias and the gating's add
    from N(0, SPREAD^2); a norm's scale and the gating's multiply from
    1 + N(0, SPREAD^2).  None sits at the program's initial value, so a
    dropped or misapplied bias, affine or gating shows in the outputs."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        if name.endswith(".weight") and len(shape) == 2:
            lim = math.sqrt(6.0 / shape[1])
            t = torch.rand(shape, generator=g) * (2 * lim) - lim
        elif name.endswith((".weight", ".mul")):
            t = 1.0 + SPREAD * torch.randn(shape, generator=g)
        else:
            t = SPREAD * torch.randn(shape, generator=g)
        state[name] = t
    return state


def build_net(cfg: dict, device, dtype: str | None = None,
              state: dict | None = None):
    """The program's net for the configuration in eval mode on ``device``,
    holding ``state`` (else ``draw_state`` from ``weights_seed``); its
    config; and the state.  Raises ``NoResult`` where the program has no
    such version."""
    from alphazero_tpu_torch.models import splendor_net as N
    if cfg["nn_version"] not in N.NET_VERSIONS:
        raise core.NoResult(f"the program has no nn_version "
                            f"{cfg['nn_version']} (registered: "
                            f"{sorted(N.NET_VERSIONS)})")
    net_cfg = net_config(cfg, dtype)
    net = N.build_net(net_cfg, device)
    if state is None:
        state = draw_state({k: v.shape for k, v in net.state_dict().items()},
                           int(cfg["weights_seed"]))
    net.load_state_dict(state)
    return net.eval(), net_cfg, state


class RoundedTrunk(RB.BT4):
    """The reference with every Dense output of the trunk rounded to
    ``dtype`` (clipped to float8 e4m3's finite range when rounding to
    it)."""

    def __init__(self, state_dict, device, dtype):
        super().__init__(state_dict, device)
        self.dtype = dtype

    def _dense(self, name, x):
        y = super()._dense(name, x)
        if self.dtype == torch.float8_e4m3fn:
            y = y.clamp(-FP8_MAX, FP8_MAX)
        return y.to(self.dtype).to(torch.float32)


def at_init(state: dict, kinds: tuple) -> dict:
    """``state`` with the tensors of the modules whose name starts with one
    of ``kinds`` (``dense_`` biases only) back at the program's initial
    value: a norm's scale and the gating's multiply 1, a bias and the
    gating's add 0."""
    out = {}
    for k, v in state.items():
        module = k.split(".")[-2]
        if module.startswith(kinds) and not (module.startswith("dense_")
                                             and k.endswith(".weight")):
            v = (torch.ones_like(v) if k.endswith((".weight", ".mul"))
                 else torch.zeros_like(v))
        out[k] = v
    return out


class Evaluator:
    """The program's evaluator as the reference search's net, keeping the
    boards, masks and outputs of its first call (the roots) and of every
    ``every``-th simulation's leaf batch after it."""

    def __init__(self, eval_fn, net, every: int):
        self.eval_fn, self.net, self.every = eval_fn, net, every
        self.calls, self.kept = 0, []

    def begin(self):
        """A new search starts: its next call is its roots."""
        self.calls = 0

    def __call__(self, boards, valid):
        probs, v = self.eval_fn(self.net, boards, valid)
        if self.calls == 0 or (self.calls - 1) % self.every == 0:
            self.kept.append((boards.clone(), valid.clone(), probs, v))
        self.calls += 1
        return probs, v


class Cell(SP.Cell):
    def setup(self):
        self.ecfg = program.env_config(self.cfg)
        self.ref_ecfg = program.ref_env_config(self.cfg)
        self.net, self.net_cfg, self.state = build_net(self.cfg, self.dev)
        self.engine = self._engine(int(self.p["plies"]))
        # every shape of the window: both searches and the actor's moves
        warm = self._engine(1)
        warm.run_games(self.net, torch.Generator(device=self.dev).manual_seed(
            core.derived_seed(self.ctx.seed, 1 << 30)), collect=True)

    def traced(self):
        reduced, counts = super().traced()
        rows = work.rows(self.cfg["num_players"])
        counts.update(
            window_flops=work_bt4.forward_flops(self.cfg)
            * self._leaf_evals(self.calls[:self.window_calls]),
            net_token_flops=work_bt4.token_flops(self.cfg),
            net_board_flops=work_bt4.board_flops(self.cfg, rows))
        return reduced, counts

    def release(self):
        # the check's reference searches run on the program's evaluator
        del self.engine

    # ----------------------------------------------------------------- check
    def search_gaps(self, judged_side) -> dict:
        """The largest gaps over the judged searches between
        ``judged_side(rec)`` and the reference search driven by the
        program's evaluator, which keeps what it evaluated in
        ``self.kept``."""
        from alphazero_tpu_torch.games.splendor import adapter as A
        ev = Evaluator(A.make_eval_fn(self.net_cfg), self.net,
                       int(self.p["net_every"]))
        gaps = {}
        for rec in self.judged():
            ev.begin()
            g = program.compare_search(judged_side(rec),
                                       self._ref_search(rec, ev))
            gaps = {n: max(v, gaps.get(n, 0.0)) for n, v in g.items()}
        self.kept = ev.kept
        return gaps

    def net_gaps(self, evaluate=None, state: dict | None = None) -> dict:
        """The largest gaps between the kept outputs of the program (or
        ``evaluate(boards, valid)``'s) and the float32 reference net (or
        the reference ``state`` gives) on the kept boards and the drawn
        weights."""
        ref = RB.BT4(self.state, self.dev)
        if evaluate is None and state is not None:
            evaluate = RB.BT4(state, self.dev)
        value = prior = 0.0
        for boards, valid, probs, v in self.kept:
            if evaluate is not None:
                probs, v = evaluate(boards, valid)
            rp, rv = ref(boards, valid)
            value = max(value, float((v.float() - rv).abs().max()))
            prior = max(prior, float((probs.float() - rp).abs().max()))
        return {"net_value_gap": value, "net_prior_gap": prior}

    def check(self):
        checks, attempted, failed = super().check()
        gaps = self.net_gaps()
        lim = self.ctx.cell["limits"]
        checks += [(n, gaps[n], lim[n]) for n in ("net_value_gap",
                                                  "net_prior_gap")]
        return checks, attempted, failed

    def control(self) -> dict:
        """The net gaps of the controls on the kept boards: the program
        with a float32 trunk (which has to read far under the limits); the
        reference rounded to float8 after every Dense of the trunk, the
        reference with every Dense bias at 0, and the reference with the
        norms and the gating at their initial values (each of which has to
        fail one); and the reference rounded to bf16 after every Dense of
        the trunk (rounding alone, beside the program's gaps)."""
        from alphazero_tpu_torch.games.splendor import adapter as A
        net32, cfg32, _ = build_net(self.cfg, self.dev, "float32", self.state)
        eval32 = A.make_eval_fn(cfg32)
        out = {"float32_trunk": self.net_gaps(
            lambda b, m: eval32(net32, b, m))}
        del net32
        for name, dtype in (("float8_trunk", torch.float8_e4m3fn),
                            ("bfloat16_dense", torch.bfloat16)):
            out[name] = self.net_gaps(RoundedTrunk(self.state, self.dev,
                                                   dtype))
        out["dense_biases_at_0"] = self.net_gaps(
            state=at_init(self.state, ("dense_",)))
        out["norms_gating_at_init"] = self.net_gaps(
            state=at_init(self.state, ("ln_", "gate_")))
        return out
