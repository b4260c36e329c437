"""Training step and fit loop: port of ``alphazero_tpu/train/trainer.py``.

Random minibatches over the replay history, symmetry augmentation on the
device, the four-term loss and Adam under a one-cycle learning rate that
restarts with every ``fit`` call (the moments persist across calls).

``optax.scale_by_adam()`` followed by ``p - lr * u`` is ``torch.optim.Adam``
with betas (0.9, 0.999), eps 1e-8 outside the square root, and the step's
``lr`` set on the param group before each step: the same update, rounded
in another order.  The JAX package fuses K minibatch steps into one
``lax.scan``; here a chunk is K steps in a loop that keeps every metric on
the device until the chunk's end, where they are averaged over the K
steps.  ``fit`` draws from its ``np.random.Generator`` exactly as the JAX
``fit`` does (the validation permutation, then one ``replay.sample`` per
chunk or per step), so both packages train on the same example ids in the
same order under the same learning rates.  Dropout and the symmetry
choices come from a ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..games.splendor import env as E
from ..games.splendor import symmetry as SYM
from ..models import splendor_net as N
from ..parallel import distributed as D
from . import losses as L

_ADAM = dict(betas=(0.9, 0.999), eps=1e-8)
_BATCH_KEYS = ("boards", "pi", "winner", "scdiff", "valids")


@dataclasses.dataclass
class TrainState:
    """The net (its parameters and running statistics), its Adam and the
    number of steps taken."""
    net: torch.nn.Module
    opt: torch.optim.Adam
    step: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learn_rate: float = 3e-4
    vl_weight: float = 10.0
    batch_size: int = 32
    epochs: int = 2
    augment: bool = True
    # fraction of the replay buffer held out for validation-loss tracking
    # (0 = off)
    val_split: float = 0.0
    max_val_examples: int = 4096


def _adam(net) -> torch.optim.Adam:
    return torch.optim.Adam(net.parameters(), lr=0.0, **_ADAM)


def init_train_state(net_cfg: N.NetConfig,
                     generator: torch.Generator | None = None,
                     device="cuda") -> TrainState:
    """A net from Flax's initializers (``generator``: a CPU generator) on
    ``device``, in full float32, with fresh Adam moments."""
    net = N.build_net(net_cfg, device, generator)
    return TrainState(net, _adam(net), 0)


def reset_opt_state(state: TrainState) -> TrainState:
    """Fresh Adam moments for the current params.  Used by the NaN-rollback
    guard: after a non-finite loss the moments themselves are non-finite, so
    restoring params alone would diverge again on the next step."""
    return dataclasses.replace(state, opt=_adam(state.net))


def opt_state_to_flax(state: TrainState) -> dict:
    """Adam's state as ``{"count", "mu", "nu"}``: the step count and the
    first and second moments as Flax-layout numpy trees (zeros before the
    first step, as ``optax.scale_by_adam().init`` gives)."""
    mu, nu, count = {}, {}, 0
    for name, p in state.net.named_parameters():
        st = state.opt.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        if "step" in st:
            count = int(st["step"])
    return {"count": np.asarray(count, np.int32), "mu": N.to_flax(mu)[0],
            "nu": N.to_flax(nu)[0]}


def load_opt_state(state: TrainState, opt_state) -> TrainState:
    """Adam moments from a checkpoint's ``opt_state``: the port's
    ``{"count", "mu", "nu"}`` or the JAX package's ``ScaleByAdamState``
    (read as the 3-tuple ``(count, mu, nu)``).  Raises ``KeyError`` or
    ``ValueError`` when its trees do not fit the net."""
    if isinstance(opt_state, dict):
        count, mu, nu = (opt_state[k] for k in ("count", "mu", "nu"))
    else:
        count, mu, nu = opt_state
    mu_sd, nu_sd = N.from_flax(mu, {}), N.from_flax(nu, {})
    params = dict(state.net.named_parameters())
    if set(mu_sd) != set(params) or set(nu_sd) != set(params):
        raise KeyError(f"optimizer trees name {sorted(set(mu_sd) ^ set(params))}"
                       f" differently from the net")
    state = reset_opt_state(state)
    step = float(np.asarray(count))
    for name, p in params.items():
        if mu_sd[name].shape != p.shape or nu_sd[name].shape != p.shape:
            raise ValueError(f"optimizer moment {name}: shape "
                             f"{tuple(mu_sd[name].shape)}, param "
                             f"{tuple(p.shape)}")
        state.opt.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu_sd[name].to(p.device),
            "exp_avg_sq": nu_sd[name].to(p.device)}
    return state


def _device_batch(batch, device):
    return {k: torch.as_tensor(batch[k]).to(device) for k in _BATCH_KEYS}


def _targets(net_cfg: N.NetConfig, pi, batch):
    return {"pi": pi.to(torch.float32),
            "v": batch["winner"].to(torch.float32),
            "scdiff": L.scdiff_targets(batch["scdiff"], net_cfg.num_scdiffs,
                                       net_cfg.max_score_diff)}


def _all_reduce_grads(params, group, world: int):
    """Every rank's gradients summed and divided by ``world``, in one
    collective: the gradient of the global mean loss, equal on every
    rank."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= world
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _global_metrics(metrics, v, group, world: int):
    """The global batch's metrics from every rank's: the means over equal
    blocks of rows are the means of the ranks' means; ``v_out_std`` is the
    global population std, from the global mean."""
    keys = [k for k in metrics if k != "v_out_std"]
    v = v.detach()
    sums = torch.stack([metrics[k].detach() for k in keys] + [v.sum()])
    dist.all_reduce(sums, group=group)
    n = v.numel() * world
    dev2 = ((v - sums[-1] / n) ** 2).sum()
    dist.all_reduce(dev2, group=group)
    out = dict(zip(keys, sums[:-1] / world))
    out["v_out_std"] = torch.sqrt(dev2 / n)
    return out


def _data_parallel(mesh, axis):
    return None if mesh is None else N.DataParallel(*D.axis_group(mesh,
                                                                  axis))


def _rows(batch, dp, axis: int = 0):
    """Each column, or with ``dp`` this rank's block of its rows along
    ``axis``."""
    if dp is None:
        return {k: batch[k] for k in _BATCH_KEYS}

    def take(x):
        rows = D.rows_of(x.shape[axis], dp.rank, dp.world)
        return x[(slice(None),) * axis + (rows,)]
    return {k: take(batch[k]) for k in _BATCH_KEYS}


def _make_step_body(env_cfg, net_cfg, cfg: TrainConfig, dp):
    """``body(state, b, lr, vlw, generator)`` on a batch ``b`` of tensors
    on the device: this rank's rows when ``dp`` is given."""
    sym_fn = SYM.batched_random_symmetry(env_cfg) if cfg.augment else None
    shard = {} if dp is None else dict(rank=dp.rank, world=dp.world)

    def body(state: TrainState, b, lr, vlw, generator=None):
        boards, pi_t, valids = b["boards"], b["pi"], b["valids"]
        if sym_fn is not None:
            boards, pi_t, valids = sym_fn(generator, boards, pi_t, valids,
                                          **shard)
        targets = _targets(net_cfg, pi_t, b)
        with (contextlib.nullcontext() if dp is None
              else N.data_parallel(state.net, dp)):
            outputs, _ = N.apply_train(state.net, boards.to(torch.float32),
                                       valids, generator)
            loss, metrics = L.total_loss(outputs, targets, vlw)
            state.opt.zero_grad(set_to_none=True)
            loss.backward()
        if dp is not None:
            _all_reduce_grads(list(state.net.parameters()), dp.group,
                              dp.world)
            metrics = _global_metrics(metrics, outputs[1], dp.group, dp.world)
        for group in state.opt.param_groups:
            group["lr"] = float(lr)
        state.opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return body


def make_train_step(env_cfg: E.SplendorConfig, net_cfg: N.NetConfig,
                    cfg: TrainConfig, mesh=None, axis="env"):
    """``step(state, batch, lr, vlw, generator) -> (state, metrics)``: one
    update on ``batch`` (numpy or tensors); ``vlw`` is the value-loss
    weight; the metrics are 0-dim tensors on the device.

    With a ``mesh`` (``parallel/distributed.py``) the step is this rank's
    part of one data-parallel step: every rank passes the same global
    ``batch`` and the same ``generator`` state, takes its rows of the batch
    along ``axis``, and draws the symmetry choices and dropout masks for
    the global batch; BatchNorm normalizes with the global batch's
    statistics, the gradients are all-reduced and divided by the world
    size, and the metrics are the global batch's.  The update equals the
    single-process step on the global batch, up to the order of float
    sums, on every rank alike."""
    dp = _data_parallel(mesh, axis)
    body = _make_step_body(env_cfg, net_cfg, cfg, dp)

    def train_step(state: TrainState, batch, lr, vlw, generator=None):
        dev = next(state.net.parameters()).device
        return body(state, _device_batch(_rows(batch, dp), dev), lr, vlw,
                    generator)

    return train_step


def make_train_chunk(env_cfg: E.SplendorConfig, net_cfg: N.NetConfig,
                     cfg: TrainConfig, mesh=None, axis="env"):
    """``chunk(state, batches, lrs, vlw, generator) -> (state, metrics)``:
    K minibatch updates on ``batches`` stacked to ``(K, B, ...)`` (moved to
    the device in one copy per column) at the K rates ``lrs``; the metrics
    are the mean over the K steps, or with ``per_step=True`` the ``(K,)``
    series.  With a ``mesh``, each step is ``make_train_step``'s
    data-parallel step on the global minibatch ``batches[j]``, and this
    rank moves only its rows of each to the device."""
    dp = _data_parallel(mesh, axis)
    body = _make_step_body(env_cfg, net_cfg, cfg, dp)

    def chunk(state: TrainState, batches, lrs, vlw, generator=None,
              per_step: bool = False):
        dev = next(state.net.parameters()).device
        stacked = _device_batch(_rows(batches, dp, axis=1), dev)
        ms = []
        for j, lr in enumerate(lrs):
            state, m = body(state, {k: v[j] for k, v in stacked.items()},
                            lr, vlw, generator)
            ms.append(m)
        series = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        if per_step:
            return state, series
        return state, {k: v.mean() for k, v in series.items()}

    return chunk


def make_eval_step(env_cfg: E.SplendorConfig, net_cfg: N.NetConfig,
                   cfg: TrainConfig):
    """Deterministic forward + loss on a held-out batch (no dropout, running
    batch-norm statistics, no update): the validation probe."""
    def eval_step(state: TrainState, batch):
        net = state.net
        b = _device_batch(batch, next(net.parameters()).device)
        net.eval()
        with torch.no_grad():
            outputs = net(b["boards"].to(torch.float32), b["valids"])
            _, metrics = L.total_loss(outputs, _targets(net_cfg, b["pi"], b),
                                      cfg.vl_weight)
        return metrics

    return eval_step


def onecycle_lr(step: int, total_steps: int, peak: float,
                pct_start: float = 0.3, div_factor: float = 25.0,
                final_div_factor: float = 1e4) -> float:
    """Host-side OneCycleLR with cosine annealing (torch's OneCycleLR
    defaults)."""
    total_steps = max(total_steps, 2)
    initial = peak / div_factor
    final = initial / final_div_factor
    up = max(int(pct_start * total_steps) - 1, 1)
    if step <= up:
        t = step / up
        return initial + (peak - initial) * 0.5 * (1 - np.cos(np.pi * t))
    t = min((step - up) / max(total_steps - up - 1, 1), 1.0)
    return final + (peak - final) * 0.5 * (1 + np.cos(np.pi * t))


def _floats(metrics) -> dict:
    """Device metrics to Python floats in one transfer."""
    if not metrics:
        return {}
    vals = torch.stack([v.detach().to(torch.float32).reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


def fit(train_state: TrainState, train_step_fn, replay, cfg: TrainConfig,
        rng: np.random.Generator, generator: torch.Generator | None = None,
        surprise_weight: bool = False, log_every: int = 0, eval_step_fn=None,
        on_epoch_end=None, train_chunk_fn=None, chunk_steps: int = 64,
        vl_scale: float = 1.0):
    """Run epochs x batches over the replay buffer.  Returns
    ``(train_state, last metrics)``.

    With ``cfg.val_split`` > 0 and an ``eval_step_fn`` (``make_eval_step``),
    a random slice of the replay buffer is held out of training and its loss
    is reported per epoch as ``val_*`` metrics.  ``on_epoch_end(epoch,
    train_state, metrics)`` hooks intermediary checkpoints.  With a
    ``train_chunk_fn`` each epoch is rounded to whole chunks of
    ``chunk_steps`` steps, and each chunk draws its ``chunk_steps *
    batch_size`` rows in one ``replay.sample`` call."""
    n = len(replay)
    allowed = None
    val_batch = None
    if cfg.val_split > 0 and eval_step_fn is not None and n >= 4:
        perm = rng.permutation(n)
        val_n = min(max(int(n * cfg.val_split), 1), cfg.max_val_examples,
                    n - 1)
        val_ids, allowed = perm[:val_n], perm[val_n:]
        val_batch = replay.gather(np.sort(val_ids))
    pool = n if allowed is None else len(allowed)
    batch_count = max(pool // cfg.batch_size, 1)
    if train_chunk_fn is not None:
        chunks_per_epoch = max(int(round(batch_count / chunk_steps)), 1)
        batch_count = chunks_per_epoch * chunk_steps
    total = cfg.epochs * batch_count
    metrics = {}
    step_i = 0
    # effective value-loss weight of this call (vl_scale: the warmup)
    vlw = cfg.vl_weight * vl_scale
    for epoch in range(cfg.epochs):
        if train_chunk_fn is not None:
            for _ in range(chunks_per_epoch):
                batch_np = replay.sample(cfg.batch_size * chunk_steps, rng,
                                         surprise_weight=surprise_weight,
                                         allowed=allowed)
                batches = {k: v.reshape((chunk_steps, cfg.batch_size)
                                        + v.shape[1:])
                           for k, v in batch_np.items()}
                lrs = [float(np.float32(onecycle_lr(step_i + j, total,
                                                    cfg.learn_rate)))
                       for j in range(chunk_steps)]
                train_state, metrics = train_chunk_fn(train_state, batches,
                                                      lrs, vlw, generator)
                step_i += chunk_steps
                if log_every and step_i % log_every < chunk_steps:
                    m = _floats(metrics)
                    print(f"  train step {step_i}/{total} "
                          f"loss={m['loss']:.4f} pi={m['pi']:.4f} "
                          f"v={m['v']:.4f}")
        else:
            for _ in range(batch_count):
                batch = replay.sample(cfg.batch_size, rng,
                                      surprise_weight=surprise_weight,
                                      allowed=allowed)
                lr = float(np.float32(onecycle_lr(step_i, total,
                                                  cfg.learn_rate)))
                train_state, metrics = train_step_fn(train_state, batch, lr,
                                                     vlw, generator)
                step_i += 1
                if log_every and step_i % log_every == 0:
                    m = _floats(metrics)
                    print(f"  train step {step_i}/{total} "
                          f"loss={m['loss']:.4f} pi={m['pi']:.4f} "
                          f"v={m['v']:.4f}")
        metrics = _floats(metrics)
        if val_batch is not None:
            vm = _floats(eval_step_fn(train_state, val_batch))
            metrics.update({f"val_{k}": v for k, v in vm.items()})
        if on_epoch_end is not None:
            on_epoch_end(epoch, train_state, metrics)
    return train_state, metrics
