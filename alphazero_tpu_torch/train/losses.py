"""Training losses: port of ``alphazero_tpu/train/losses.py``.

Four terms: masked policy cross-entropy, per-player value MSE, and the
score-difference head trained both as a PDF cross-entropy and a CDF L2
(weights 0.02 each, value loss weighted by ``vl_weight``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def loss_pi(target_pi, log_pi):
    return -torch.sum(target_pi * log_pi) / target_pi.shape[0]


def loss_v(target_v, v):
    return torch.sum((target_v - v) ** 2) / (target_v.shape[0]
                                             * target_v.shape[-1])


def scdiff_targets(scdiff, num_scdiffs, max_diff):
    """scdiff: (B, P) int score differences -> one-hot (B, num_scdiffs,
    2D+1) float32 of the first ``num_scdiffs`` player slots."""
    bins = torch.clamp(scdiff.long() + max_diff, 0, 2 * max_diff)
    onehot = F.one_hot(bins, 2 * max_diff + 1).to(torch.float32)
    return onehot[:, :num_scdiffs, :]


def loss_scdiff_pdf(target, log_sdiff):
    b, nsd = target.shape[0], target.shape[1]
    return 0.02 * (-torch.sum(target * log_sdiff)) / (b * nsd)


def loss_scdiff_cdf(target, log_sdiff):
    b, nsd = target.shape[0], target.shape[1]
    diff = torch.cumsum(target, -1) - torch.cumsum(torch.exp(log_sdiff), -1)
    return 0.02 * torch.sum(diff ** 2) / (b * nsd)


def total_loss(outputs, targets, vl_weight):
    """outputs: (log_pi, v, log_sdiff); targets: dict with pi, v, scdiff
    (one-hot).  Returns (loss, metrics dict of 0-dim tensors); the value
    head's output statistics ride along (``v_out_std`` is the population
    std, as ``jnp.std`` computes it)."""
    log_pi, v, log_sd = outputs
    l_pi = loss_pi(targets["pi"], log_pi)
    l_v = loss_v(targets["v"], v)
    l_cdf = loss_scdiff_cdf(targets["scdiff"], log_sd)
    l_pdf = loss_scdiff_pdf(targets["scdiff"], log_sd)
    total = l_pi + vl_weight * l_v + l_cdf + l_pdf
    return total, {"loss": total, "pi": l_pi, "v": l_v,
                   "scdiff": l_cdf + l_pdf,
                   "v_out_mean": v.mean(), "v_out_std": v.std(correction=0),
                   "v_out_absmean": v.abs().mean()}
