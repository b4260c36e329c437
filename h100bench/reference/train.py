"""One train step of the v1 net in plain PyTorch: the symmetry
augmentation, the train-mode forward (BatchNorm on the batch's statistics
with the biased variance, dropout), the four-term loss, its gradients by
autograd, and Adam.

Random draws come from the caller's generator in the order the step
makes them: the tier and reserve choices of the symmetry (``randint``
``[B, 3]`` in [0, 4), then ``[B, P]`` in [0, 3)), then one uniform tensor
per dropout site, in forward order.  Parameters are a dict of tensors
keyed by Flax path (``Dense_0/kernel`` is ``(in, out)``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import env as E
from . import tables as T
from .ckpt import tree_items
from .net import LOW_VALUE, matmul_precision

BN_EPS = 1e-5
MAX_SCORE_DIFF = 15
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8

TIER_PERMS = np.array([[0, 1, 2, 3], [1, 3, 0, 2], [2, 0, 3, 1], [3, 2, 1, 0]])
RSV_PERMS_BY_COUNT = np.array([
    [[0, 1, 2], [0, 1, 2], [0, 1, 2]],
    [[0, 1, 2], [0, 1, 2], [0, 1, 2]],
    [[0, 1, 2], [1, 0, 2], [0, 1, 2]],
    [[0, 1, 2], [1, 2, 0], [2, 0, 1]]])


def flat_params(params: dict, device) -> dict:
    """``{"Dense_0/kernel": tensor, ...}`` float32 on ``device``."""
    return {"/".join(p): torch.tensor(np.array(v, np.float32), device=device)
            for p, v in tree_items(params)}


# ------------------------------------------------------------- symmetry
def symmetry(cfg: E.SplendorConfig, states, pis, valids, tier_choice,
             rsv_raw):
    """Permute each board's visible cards within a tier (and the matching
    buy, reserve and reserve-giveback actions) by one of four permutations,
    and each player's occupied reserve slots (and, for the mover, the
    buy-reserved actions)."""
    dev = states.device
    B, n = states.shape[0], cfg.num_players
    tiers = torch.as_tensor(TIER_PERMS, device=dev)
    rsvs = torch.as_tensor(RSV_PERMS_BY_COUNT, device=dev)
    row_perm = torch.arange(cfg.rows, device=dev).repeat(B, 1)
    act_perm = torch.arange(T.NUM_ACTIONS, device=dev).repeat(B, 1)
    s4, s5 = torch.arange(4, device=dev), torch.arange(5, device=dev)
    for t in range(3):
        perm = tiers[tier_choice[:, t]]
        base = cfg.row_cards + 8 * t
        row_perm[:, base + 2 * s4] = base + 2 * perm
        row_perm[:, base + 2 * s4 + 1] = base + 2 * perm + 1
        act_perm[:, 4 * t + s4] = 4 * t + perm
        act_perm[:, 12 + 4 * t + s4] = 12 + 4 * t + perm
        dst = (T.A_RSVG + 5 * (4 * t + s4)[:, None] + s5[None, :]).reshape(-1)
        src = T.A_RSVG + 5 * (4 * t + perm)[:, :, None] + s5[None, None, :]
        act_perm[:, dst] = src.reshape(B, -1)
    s3 = torch.arange(3, device=dev)
    for p in range(n):
        base = cfg.row_prsv + 6 * p
        rows = states[:, base:base + 6:2, :5].to(torch.int32)
        count = (rows.sum(2) > 0).sum(1)
        perm = rsvs[count, rsv_raw[:, p]]
        row_perm[:, base + 2 * s3] = base + 2 * perm
        row_perm[:, base + 2 * s3 + 1] = base + 2 * perm + 1
        if p == 0:
            act_perm[:, 27 + s3] = 27 + perm
    states = states.gather(1, row_perm[:, :, None].expand(-1, -1, 7))
    return states, pis.gather(1, act_perm), valids.gather(1, act_perm)


# ------------------------------------------------------------- forward
def _lin(P, name, x):
    return x @ P[f"{name}/kernel"] + P[f"{name}/bias"]


def _bn(P, name, x):
    """Train-mode BatchNorm over the feature axis 1."""
    dims = [0] + list(range(2, x.dim()))
    mean, msq = x.mean(dims), (x * x).mean(dims)
    var = (msq - mean * mean).clamp(min=0.0)
    shape = [1, -1] + [1] * (x.dim() - 2)
    mul = torch.rsqrt(var + BN_EPS) * P[f"{name}/scale"]
    return (x - mean.view(shape)) * mul.view(shape) + P[f"{name}/bias"].view(
        shape)


def _drop(x, rate, gen):
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0)


def _gpool(P, name, x, groups, items):
    n = groups * items
    g = x[..., :n].reshape(*x.shape[:-1], groups, items)
    d = F.relu(_bn(P, f"{name}/BatchNorm_0",
                   _lin(P, f"{name}/Dense_0", x[..., n:])))
    return torch.cat([g.amax(-1), g.mean(-1), d], -1)


def forward_train(P, boards, valid, players: int, width: int, rate: float,
                  gen):
    """``(log_pi, v, log_sdiff)`` of the train-mode forward."""
    def drop(y):
        return _drop(y, rate, gen)
    x = boards.transpose(-1, -2)
    x = F.relu(_bn(P, "BatchNorm_0", _lin(P, "Dense_0", x)))
    x = F.relu(_lin(P, "Dense_1", x))
    x = drop(_gpool(P, "DenseAndPartialGPool_0", x, 4, 8))
    x = drop(F.relu(_lin(P, "Dense_2", x)))
    b, half = x.shape[0], width // 2
    first, last = x[:, :5, :half], x[:, 5:, :half]
    x = torch.cat([first.amax(1), first.mean(1), last.reshape(b, -1),
                   x[:, :, half:].reshape(b, -1)], -1)[:, None, :]
    x = drop(F.relu(_lin(P, "Dense_3", x)))
    x = drop(_gpool(P, "DenseAndPartialGPool_1", x, 4, 4))
    x = F.relu(_bn(P, "BatchNorm_1", _lin(P, "Dense_4", x)))
    x = drop(F.relu(_lin(P, "Dense_5", x)))
    x = drop(_gpool(P, "DenseAndPartialGPool_2", x, 4, 4))[:, 0, :]
    pi = _lin(P, "Dense_7", _lin(P, "Dense_6", x))
    pi = torch.where(valid, pi, LOW_VALUE)
    v = torch.tanh(_lin(P, "Dense_9", _lin(P, "Dense_8", x)))
    sd = _lin(P, "Dense_11", _lin(P, "Dense_10", x))
    return (F.log_softmax(pi, -1), v,
            F.log_softmax(sd.reshape(b, players, 2 * MAX_SCORE_DIFF + 1), -1))


def loss(outputs, pi_t, winner, scdiff, vl_weight: float, players: int):
    """Policy cross-entropy + vl_weight x value MSE + 0.02 x (score-diff
    CDF L2 + PDF cross-entropy)."""
    log_pi, v, log_sd = outputs
    B = pi_t.shape[0]
    bins = torch.clamp(scdiff.long() + MAX_SCORE_DIFF, 0, 2 * MAX_SCORE_DIFF)
    sd_t = F.one_hot(bins, 2 * MAX_SCORE_DIFF + 1).float()[:, :players]
    l_pi = -torch.sum(pi_t * log_pi) / B
    l_v = torch.sum((winner - v) ** 2) / (B * winner.shape[-1])
    cdf = torch.cumsum(sd_t, -1) - torch.cumsum(torch.exp(log_sd), -1)
    l_cdf = 0.02 * torch.sum(cdf ** 2) / (B * players)
    l_pdf = 0.02 * (-torch.sum(sd_t * log_sd)) / (B * players)
    return l_pi + vl_weight * l_v + l_cdf + l_pdf


class Adam:
    """Adam (betas 0.9, 0.999; eps 1e-8 outside the square root), started
    from given moments and step count."""

    def __init__(self, mu: dict, nu: dict, count: int):
        self.mu = {k: v.clone() for k, v in mu.items()}
        self.nu = {k: v.clone() for k, v in nu.items()}
        self.count = count

    def step(self, P: dict, grads: dict, lr: float):
        b1, b2 = ADAM_BETAS
        self.count += 1
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k, g in grads.items():
            self.mu[k] = b1 * self.mu[k] + (1 - b1) * g
            self.nu[k] = b2 * self.nu[k] + (1 - b2) * g * g
            denom = self.nu[k].sqrt() / bc2 ** 0.5 + ADAM_EPS
            P[k] = P[k] - lr / bc1 * self.mu[k] / denom


def train_step(cfg: E.SplendorConfig, P: dict, opt: Adam, batch: dict,
               lr: float, vl_weight: float, rate: float, width: int, gen,
               tf32: bool = False, rows=None):
    """One step on ``batch`` (tensors on the device); updates ``P`` and
    ``opt`` in place and returns ``(loss, gradients)``.  ``rows`` keeps only
    those rows of the batch after the draws (a fault the check must
    catch)."""
    B, n = batch["boards"].shape[0], cfg.num_players
    dev = batch["boards"].device
    tier = torch.randint(0, 4, (B, 3), generator=gen, device=dev)
    rsv = torch.randint(0, 3, (B, n), generator=gen, device=dev)
    boards, pi_t, valid = symmetry(cfg, batch["boards"], batch["pi"],
                                   batch["valids"], tier, rsv)
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    with matmul_precision(tf32):
        out = forward_train(leaves, boards.float(), valid, n, width, rate,
                            gen)
        keep = slice(None) if rows is None else rows
        value = loss(tuple(o[keep] for o in out), pi_t[keep].float(),
                     batch["winner"][keep].float(), batch["scdiff"][keep],
                     vl_weight, n)
        grads = dict(zip(leaves, torch.autograd.grad(value,
                                                     list(leaves.values()))))
    opt.step(P, grads, lr)
    return float(value.detach()), grads
