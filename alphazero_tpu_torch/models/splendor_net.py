"""Three-head Splendor network (policy / value / score-diff) in PyTorch.

Port of ``SplendorNet`` (versions 0 and 1) of
``alphazero_tpu/models/splendor_net.py``: a global-pooling MLP trunk, a
masked log-softmax policy, a per-player tanh value and a 31-bin score-diff
distribution per seat.  Layouts follow the JAX module, so ``from_flax``
carries its parameters over one to one:

- a Flax ``Dense`` kernel is ``(in, out)``; ``nn.Linear`` stores ``(out,
  in)``, so the kernel is transposed;
- Flax ``BatchNorm(axis=1)`` on ``(B, 7, w)`` or ``(B, 1, F)`` is
  ``BatchNorm1d`` over dim 1, eps 1e-5, with running statistics in eval
  mode.

The heads always compute in float32, with the ``LOW_VALUE`` mask before the
policy's log-softmax.  Float32 matmuls on the GPU run in full float32:
``apply_inference`` turns TF32 off explicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..utils.device import resolve_device

LOW_VALUE = -1e8


@dataclasses.dataclass(frozen=True)
class NetConfig:
    nb_vect: int                 # rows of the observation (56 for 2 players)
    vect_dim: int = 7
    action_size: int = 409
    num_players: int = 2
    max_score_diff: int = 15
    dropout: float = 0.3
    nn_version: int = 1
    width: int = 128
    dtype: str = "float32"

    @property
    def num_scdiffs(self) -> int:
        return {2: 2, 3: 3, 4: 4}[self.num_players]

    @property
    def scdiff_size(self) -> int:
        return 2 * self.max_score_diff + 1


def _bn(channels: int) -> nn.BatchNorm1d:
    # Flax BatchNorm: eps 1e-5, momentum 0.99 (= torch momentum 0.01)
    return nn.BatchNorm1d(channels, eps=1e-5, momentum=0.01)


class DenseAndPartialGPool(nn.Module):
    """Pool ``nb_groups`` groups of ``nb_items`` features (max and mean),
    pass the rest through Dense + BatchNorm + ReLU."""

    def __init__(self, in_features: int, output_length: int, nb_groups: int,
                 nb_items: int, channels: int):
        super().__init__()
        self.nb_groups, self.nb_items = nb_groups, nb_items
        self.pool_len = nb_groups * nb_items
        self.dense = nn.Linear(in_features - self.pool_len,
                               output_length - 2 * nb_groups)
        self.bn = _bn(channels)

    def forward(self, x):
        g = x[..., :self.pool_len].reshape(*x.shape[:-1], self.nb_groups,
                                           self.nb_items)
        d = F.relu(self.bn(self.dense(x[..., self.pool_len:])))
        return torch.cat([g.amax(-1), g.mean(-1), d], -1)


def _flatten_and_partial_gpool(x, length_to_pool: int,
                               nb_channels_to_pool: int):
    """(B, C, L) -> (B, 1, F): pool the first channels of the first
    features across channels, flatten everything."""
    b = x.shape[0]
    xb, xe = x[:, :, :length_to_pool], x[:, :, length_to_pool:]
    first = xb[:, :nb_channels_to_pool]
    last = xb[:, nb_channels_to_pool:]
    out = torch.cat([first.amax(1), first.mean(1), last.reshape(b, -1),
                     xe.reshape(b, -1)], -1)
    return out[:, None, :]


class SplendorNet(nn.Module):
    """Trunk + PI/V/SDIFF heads (nn_version 0 and 1)."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        if cfg.nn_version not in (0, 1):
            raise ValueError(f"nn_version {cfg.nn_version} is not ported yet "
                             f"(ported: 0, 1)")
        if cfg.dtype != "float32":
            raise ValueError(f"dtype {cfg.dtype!r}: the port's net computes "
                             f"in float32")
        self.cfg = cfg
        w, C = cfg.width, cfg.vect_dim
        flat = 2 * (w // 2) + (C - 5) * (w // 2) + C * (w - w // 2)
        self.dense_0 = nn.Linear(cfg.nb_vect, w)
        self.bn_0 = _bn(C)
        self.dense_1 = nn.Linear(w, w)
        self.gpool_0 = DenseAndPartialGPool(w, w, 4, 8, C)
        self.dense_2 = nn.Linear(w, w)
        self.dense_3 = nn.Linear(flat, w)
        self.gpool_1 = DenseAndPartialGPool(w, w, 4, 4, 1)
        self.dense_4 = nn.Linear(w, w)
        self.bn_1 = _bn(1)
        self.dense_5 = nn.Linear(w, w)
        self.gpool_2 = DenseAndPartialGPool(w, w, 4, 4, 1)
        self.dense_6 = nn.Linear(w, w)
        self.dense_7 = nn.Linear(w, cfg.action_size)
        self.dense_8 = nn.Linear(w, w)
        self.dense_9 = nn.Linear(w, cfg.num_players)
        self.dense_10 = nn.Linear(w, w)
        self.dense_11 = nn.Linear(w, cfg.num_scdiffs * cfg.scdiff_size)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, boards, valid_actions):
        """boards (B, nb_vect, 7) float; valid_actions (B, A) bool.
        Returns (log_pi (B, A), v (B, P), log_sdiff (B, num_scdiffs, 31))."""
        c = self.cfg
        x = boards.transpose(-1, -2).to(torch.float32)       # (B, 7, nb_vect)
        x = F.relu(self.bn_0(self.dense_0(x)))
        x = F.relu(self.dense_1(x))
        x = self.drop(self.gpool_0(x))
        x = self.drop(F.relu(self.dense_2(x)))
        x = _flatten_and_partial_gpool(x, c.width // 2, 5)
        x = self.drop(F.relu(self.dense_3(x)))
        x = self.drop(self.gpool_1(x))
        x = F.relu(self.bn_1(self.dense_4(x)))
        x = self.drop(F.relu(self.dense_5(x)))
        x = self.drop(self.gpool_2(x))

        x = x[:, 0, :].to(torch.float32)                     # f32 heads
        pi = self.dense_7(self.dense_6(x))
        v = self.dense_9(self.dense_8(x))
        sd = self.dense_11(self.dense_10(x))
        pi = torch.where(valid_actions, pi, LOW_VALUE)
        log_pi = F.log_softmax(pi, -1)
        log_sdiff = F.log_softmax(
            sd.reshape(-1, c.num_scdiffs, c.scdiff_size), -1)
        return log_pi, torch.tanh(v), log_sdiff


def build_net(cfg: NetConfig, device="cuda") -> SplendorNet:
    """A ``SplendorNet`` in eval mode on ``device`` (weights from torch's
    default init; load real ones with ``from_flax``)."""
    return SplendorNet(cfg).to(resolve_device(device)).eval()


def apply_inference(net: SplendorNet, boards, valid_actions):
    """Eval-mode forward: returns (pi probs, v, log_sdiff)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    net.eval()
    with torch.inference_mode():
        log_pi, v, log_sd = net(boards, valid_actions)
    return torch.exp(log_pi), v, log_sd


# Flax module path -> port module name.  Top-level Dense_k / BatchNorm_k
# keep their creation order; DenseAndPartialGPool_k holds Dense_0 and
# BatchNorm_0.
_FLAX_DENSE = {f"Dense_{k}": f"dense_{k}" for k in range(12)}
_FLAX_DENSE.update({f"DenseAndPartialGPool_{k}/Dense_0": f"gpool_{k}.dense"
                    for k in range(3)})
_FLAX_BN = {"BatchNorm_0": "bn_0", "BatchNorm_1": "bn_1"}
_FLAX_BN.update({f"DenseAndPartialGPool_{k}/BatchNorm_0": f"gpool_{k}.bn"
                 for k in range(3)})


def _leaf(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return np.array(tree, np.float32)          # a writable copy


def from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """A ``SplendorNet`` state_dict from Flax ``(params, batch_stats)``
    trees of numpy arrays (as ``alphazero_tpu.v1`` checkpoints hold them)."""
    sd: dict[str, torch.Tensor] = {}
    for fpath, name in _FLAX_DENSE.items():
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(_leaf(params, fpath + "/kernel").T))
        sd[f"{name}.bias"] = torch.from_numpy(_leaf(params, fpath + "/bias"))
    for fpath, name in _FLAX_BN.items():
        sd[f"{name}.weight"] = torch.from_numpy(_leaf(params, fpath + "/scale"))
        sd[f"{name}.bias"] = torch.from_numpy(_leaf(params, fpath + "/bias"))
        sd[f"{name}.running_mean"] = torch.from_numpy(
            _leaf(batch_stats, fpath + "/mean"))
        sd[f"{name}.running_var"] = torch.from_numpy(
            _leaf(batch_stats, fpath + "/var"))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return sd
