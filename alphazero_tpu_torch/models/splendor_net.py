"""Three-head Splendor network (policy / value / score-diff) in PyTorch.

Port of ``alphazero_tpu/models/splendor_net.py``: ``SplendorNet``
(versions 0 and 1: a global-pooling MLP trunk) and ``SplendorNetV2``
(version 2: a wider trunk with pre-activation residual MLP blocks after the
flatten), each with a masked log-softmax policy, a per-player tanh value
and a 31-bin score-diff distribution per seat.  Version 3,
``SplendorNetBT4``, is the port's own: Leela Chess Zero's BT4 encoder
transformer over the board's rows (no JAX counterpart).  Layouts follow
the Flax modules, so ``from_flax`` and ``to_flax`` carry parameters over
one to one:

- a Flax ``Dense`` kernel is ``(in, out)``; ``nn.Linear`` stores ``(out,
  in)``, so the kernel is transposed;
- a port module ``dense_k`` / ``bn_k`` / ``gpool_k`` is the Flax module
  ``Dense_k`` / ``BatchNorm_k`` / ``DenseAndPartialGPool_k`` (Flax numbers
  each kind in creation order); a pool's own ``dense`` and ``bn`` are its
  ``Dense_0`` and ``BatchNorm_0``;
- version 3's modules take the same rule: ``ln_k`` / ``gate_k`` /
  ``enc_k`` are ``LayerNorm_k`` / ``Gating_k`` / ``EncoderLayer_k``, and a
  layer's own ``dense_k`` / ``ln_k`` its ``Dense_k`` / ``LayerNorm_k``;
- Flax ``BatchNorm(axis=1)`` on ``(B, 7, w)`` or ``(B, 1, F)`` normalizes
  over dim 1, and ``BatchNorm()`` on ``(B, w)`` over the last dim, as
  ``BatchNorm1d`` does with those inputs.

Train mode is Flax's: BatchNorm normalizes with the batch mean and the
biased batch variance ``mean(x^2) - mean(x)^2`` (clipped at 0) and moves
its running statistics by momentum 0.99 with that same biased variance
(``nn.BatchNorm1d`` would move them with the unbiased one); dropout draws
its mask from an explicit ``torch.Generator``.  The heads always compute in
float32, with the ``LOW_VALUE`` mask before the policy's log-softmax.

``NetConfig.dtype="bfloat16"`` runs the trunk in bf16 as the Flax modules
do with ``dtype=bfloat16``: a Dense casts its input, kernel and bias to
bf16 (the product in bf16, then the bias added in bf16); BatchNorm computes
its statistics and the normalization in float32 and returns bf16; the
pooling, ReLU, dropout and the residual adds run in bf16, a mean as a
float32 mean rounded once.  The trunk's output returns to float32 before
the heads.  Parameters and running statistics stay float32 in either
dtype, so ``from_flax`` / ``to_flax`` and checkpoints are the same.
Version 3 has no JAX counterpart to match and a Dense rule of its own
(``_dense_once``): the product and the bias in one ``F.linear``, the bias
added to the float32 accumulator and the sum rounded to bf16 once, as XLA
and cuBLASLt do when they fuse a bias into a bf16 GEMM (on the card one
GEMM with the bias in its epilogue).  Its other rules are those above: its
LayerNorms compute in float32 and return bf16, and its attention is
``F.scaled_dot_product_attention`` with the smolgen bias as the bf16
additive mask.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..parallel.distributed import all_reduce_sum
from ..utils import profiling
from ..utils.checkpoint import tree_items
from ..utils.device import full_fp32, resolve_device

LOW_VALUE = -1e8
BN_MOMENTUM = 0.99              # Flax's default: running = m*running + (1-m)*batch


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
    # version 3 (BT4) only: encoder layers, attention heads, FFN width and
    # smolgen's (compressed channels per token, hidden, generator) sizes
    layers: int = 15
    heads: int = 32
    ffn: int = 1536
    smolgen: tuple[int, int, int] = (32, 256, 256)

    @property
    def num_scdiffs(self) -> int:
        return {2: 2, 3: 3, 4: 4}[self.num_players]

    @property
    def scdiff_size(self) -> int:
        return 2 * self.max_score_diff + 1


def _mean(x, dim):
    """``x.mean(dim)``; a bf16 mean as JAX's: summed and divided in float32,
    then rounded once."""
    if x.dtype == torch.float32:
        return x.mean(dim)
    return x.float().mean(dim).to(x.dtype)


def _dense(lin: nn.Linear, x):
    """Flax ``Dense`` at the input's dtype: in float32 the module itself;
    in bf16 the kernel and bias cast to bf16, the product rounded to bf16,
    then the bias added in bf16."""
    if x.dtype == torch.float32:
        return lin(x)
    y = torch.matmul(x, lin.weight.to(x.dtype).t())
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


def _dense_once(lin: nn.Linear, x):
    """Version 3's Dense at the input's dtype: ``F.linear`` with the kernel
    and bias cast to it (no-op casts in float32, where this is ``lin(x)``).
    In bf16 the bias is added to the product's float32 accumulator and the
    sum rounded once; a contiguous input with a 1-D bias reaches ``addmm``,
    which on the card is cuBLASLt's GEMM with the bias in its epilogue."""
    b = lin.bias
    return F.linear(x, lin.weight.to(x.dtype),
                    None if b is None else b.to(x.dtype))


def _layer_norm(ln: nn.LayerNorm, x):
    """``ln`` at the input's dtype: a bf16 input's statistics and
    normalization computed in float32 inside PyTorch's layer norm, its scale
    and bias cast to bf16, the result returned as bf16."""
    if x.dtype == torch.float32:
        return ln(x)
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                        ln.bias.to(x.dtype), ln.eps)


class FlaxBatchNorm(nn.BatchNorm1d):
    """``BatchNorm1d`` (eps 1e-5, the feature dim 1) whose train mode is
    Flax's: batch statistics with the biased variance, and the running
    statistics moved by ``BN_MOMENTUM`` with that same variance.  Eval mode
    normalizes with the running statistics, as ``BatchNorm1d`` does.  A bf16
    input is normalized in float32 with Flax's ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias`` and returned as bf16, in either mode."""

    dp = None                  # a DataParallel while data_parallel is open

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x):
        if not self.training and x.dtype == torch.float32:
            return super().forward(x)
        dt, x = x.dtype, x.float()
        shape = [1, -1] + [1] * (x.dim() - 2)
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - self.running_mean.view(shape)) * mul.view(shape)
                    + self.bias.view(shape)).to(dt)
        dims = [0] + list(range(2, x.dim()))
        if self.dp is None:
            mean, msq = x.mean(dims), (x * x).mean(dims)
        else:
            # the statistics of the global batch: per-feature sums over
            # every rank's rows, with the gradient through the reduction
            sums = all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims)]),
                                  self.dp.group)
            mean, msq = (sums / (x.numel() // x.shape[1]
                                 * self.dp.world)).chunk(2)
        var = (msq - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape)).to(dt)


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
        self.bn = FlaxBatchNorm(channels)

    def forward(self, x):
        g = x[..., :self.pool_len].reshape(*x.shape[:-1], self.nb_groups,
                                           self.nb_items)
        d = F.relu(self.bn(_dense(self.dense, x[..., self.pool_len:])))
        return torch.cat([g.amax(-1), _mean(g, -1), d], -1)


def _flatten_and_partial_gpool(x, length_to_pool: int,
                               nb_channels_to_pool: int):
    """(B, C, L) -> (B, 1, F): pool the first channels of the first
    features across channels, flatten everything."""
    b = x.shape[0]
    xb, xe = x[:, :, :length_to_pool], x[:, :, length_to_pool:]
    first = xb[:, :nb_channels_to_pool]
    last = xb[:, nb_channels_to_pool:]
    out = torch.cat([first.amax(1), _mean(first, 1), last.reshape(b, -1),
                     xe.reshape(b, -1)], -1)
    return out[:, None, :]


def _flat_features(w: int, channels: int) -> int:
    return 2 * (w // 2) + (channels - 5) * (w // 2) + channels * (w - w // 2)


class DataParallel(NamedTuple):
    """One rank of a data-parallel train mode: its ``group``, its ``rank``
    in it and the group's size ``world``."""
    group: object
    rank: int
    world: int


@contextlib.contextmanager
def data_parallel(net: nn.Module, dp: DataParallel):
    """While open, ``net``'s train mode on this rank's rows computes as the
    single net on the global batch (the ``dp.world`` ranks' equal blocks of
    rows in rank order): BatchNorm normalizes with the global batch's
    statistics, and dropout draws the global batch's mask from the
    generator and keeps this rank's rows."""
    mods = [net] + [m for m in net.modules() if isinstance(m, FlaxBatchNorm)]
    for m in mods:
        m.dp = dp
    try:
        yield net
    finally:
        for m in mods:
            m.dp = None


class _Net(nn.Module):
    """What both versions share: the config checks, Flax dropout and the
    three heads (``dense_{h}..dense_{h+5}``)."""

    dp = None                  # a DataParallel while data_parallel is open

    def __init__(self, cfg: NetConfig, versions):
        super().__init__()
        if cfg.nn_version not in versions:
            raise ValueError(f"nn_version {cfg.nn_version} is not a version "
                             f"of {type(self).__name__} {sorted(versions)}")
        dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        if cfg.dtype not in dtypes:
            raise ValueError(f"dtype {cfg.dtype!r}: the trunk computes in "
                             f"{' or '.join(dtypes)}")
        self.cfg = cfg
        self.dt = dtypes[cfg.dtype]

    def _add_heads(self, w: int, first: int):
        """``dense_{first}..dense_{first+5}``: (hidden, out) for PI, V and
        SDIFF, in Flax's creation order."""
        c = self.cfg
        self._heads = [f"dense_{first + k}" for k in range(6)]
        outs = (w, c.action_size, w, c.num_players, w,
                c.num_scdiffs * c.scdiff_size)
        for name, fout in zip(self._heads, outs):
            setattr(self, name, nn.Linear(w, fout))

    def _drop(self, x, generator):
        """Flax ``Dropout``: keep with probability ``1 - rate`` and scale by
        its inverse, in train mode only."""
        rate = self.cfg.dropout
        if not self.training or rate == 0.0:
            return x
        keep = 1.0 - rate
        if x.dtype != torch.float32:
            # Flax divides by the keep rate cast to the input's dtype
            keep = float(torch.tensor(keep, dtype=x.dtype))
        if self.dp is None:
            u = torch.rand(x.shape, generator=generator, device=x.device)
        else:
            b, (r, w) = x.shape[0], self.dp[1:]
            u = torch.rand((b * w,) + x.shape[1:], generator=generator,
                           device=x.device)[r * b:(r + 1) * b]
        mask = u < 1.0 - rate
        return torch.where(mask, x / keep, 0.0)

    def _head_outputs(self, x, valid_actions):
        c = self.cfg
        pi_h, pi, v_h, v, sd_h, sd = (getattr(self, n) for n in self._heads)
        pi = torch.where(valid_actions, pi(pi_h(x)), LOW_VALUE)
        log_sdiff = F.log_softmax(
            sd(sd_h(x)).reshape(-1, c.num_scdiffs, c.scdiff_size), -1)
        return F.log_softmax(pi, -1), torch.tanh(v(v_h(x))), log_sdiff


class SplendorNet(_Net):
    """Trunk + PI/V/SDIFF heads (nn_version 0 and 1)."""

    def __init__(self, cfg: NetConfig):
        w, C = cfg.width, cfg.vect_dim
        super().__init__(cfg, (0, 1))
        self.dense_0 = nn.Linear(cfg.nb_vect, w)
        self.bn_0 = FlaxBatchNorm(C)
        self.dense_1 = nn.Linear(w, w)
        self.gpool_0 = DenseAndPartialGPool(w, w, 4, 8, C)
        self.dense_2 = nn.Linear(w, w)
        self.dense_3 = nn.Linear(_flat_features(w, C), w)
        self.gpool_1 = DenseAndPartialGPool(w, w, 4, 4, 1)
        self.dense_4 = nn.Linear(w, w)
        self.bn_1 = FlaxBatchNorm(1)
        self.dense_5 = nn.Linear(w, w)
        self.gpool_2 = DenseAndPartialGPool(w, w, 4, 4, 1)
        self._add_heads(w, 6)

    def forward(self, boards, valid_actions, generator=None):
        """boards (B, nb_vect, 7) float; valid_actions (B, A) bool;
        ``generator`` draws the dropout masks in train mode.  Returns
        (log_pi (B, A), v (B, P), log_sdiff (B, num_scdiffs, 31))."""
        def drop(y):
            return self._drop(y, generator)
        x = boards.transpose(-1, -2).to(self.dt)             # (B, 7, nb_vect)
        x = F.relu(self.bn_0(_dense(self.dense_0, x)))
        x = F.relu(_dense(self.dense_1, x))
        x = drop(self.gpool_0(x))
        x = drop(F.relu(_dense(self.dense_2, x)))
        x = _flatten_and_partial_gpool(x, self.cfg.width // 2, 5)
        x = drop(F.relu(_dense(self.dense_3, x)))
        x = drop(self.gpool_1(x))
        x = F.relu(self.bn_1(_dense(self.dense_4, x)))
        x = drop(F.relu(_dense(self.dense_5, x)))
        x = drop(self.gpool_2(x))
        return self._head_outputs(x[:, 0, :].float(), valid_actions)


class SplendorNetV2(_Net):
    """nn_version 2: width ``max(cfg.width, 256)``, the first pooled block,
    the flatten, then two pre-activation residual MLP blocks."""

    def __init__(self, cfg: NetConfig):
        w, C = max(cfg.width, 256), cfg.vect_dim
        super().__init__(cfg, (2,))
        self.w = w
        self.dense_0 = nn.Linear(cfg.nb_vect, w)
        self.bn_0 = FlaxBatchNorm(C)
        self.dense_1 = nn.Linear(w, w)
        self.gpool_0 = DenseAndPartialGPool(w, w, 4, 8, C)
        self.dense_2 = nn.Linear(_flat_features(w, C), w)
        # residual block r: bn_{1+r}, dense_{3+2r}, dense_{4+2r}
        self.bn_1, self.bn_2 = FlaxBatchNorm(w), FlaxBatchNorm(w)
        for k in range(3, 7):
            setattr(self, f"dense_{k}", nn.Linear(w, w))
        self._add_heads(w, 7)

    def forward(self, boards, valid_actions, generator=None):
        """Same contract as ``SplendorNet.forward``."""
        x = boards.transpose(-1, -2).to(self.dt)             # (B, 7, nb_vect)
        x = F.relu(self.bn_0(_dense(self.dense_0, x)))
        x = F.relu(_dense(self.dense_1, x))
        x = self._drop(self.gpool_0(x), generator)
        x = _flatten_and_partial_gpool(x, self.w // 2, 5)[:, 0, :]
        x = F.relu(_dense(self.dense_2, x))
        for r in range(2):
            h = F.relu(getattr(self, f"bn_{1 + r}")(x))
            h = F.relu(_dense(getattr(self, f"dense_{3 + 2 * r}"), h))
            x = x + self._drop(_dense(getattr(self, f"dense_{4 + 2 * r}"), h),
                               generator)
        return self._head_outputs(x.float(), valid_actions)


LN_EPS = 1e-3                   # every LayerNorm of version 3


class Gating(nn.Module):
    """Lc0's input gating: a learned multiply and add per (token,
    channel)."""

    def __init__(self, tokens: int, channels: int):
        super().__init__()
        self.mul = nn.Parameter(torch.ones(tokens, channels))
        self.add = nn.Parameter(torch.zeros(tokens, channels))

    def reset_parameters(self):
        nn.init.ones_(self.mul)
        nn.init.zeros_(self.add)

    def forward(self, x):
        return x * self.mul.to(x.dtype) + self.add.to(x.dtype)


class EncoderLayer(nn.Module):
    """One BT4 encoder layer: smolgen's attention bias from the layer's
    input, multi-head attention with that bias, then the Mish FFN, each
    added to ``alpha`` times its input and normalized after (post-LN with
    DeepNorm's scaling).  ``dense_0`` is Q, K and V in one (head ``h`` of
    each is its columns ``h*dh..(h+1)*dh``), ``dense_1`` the output,
    ``dense_2`` / ``dense_3`` the FFN, ``dense_4`` smolgen's compression
    (no bias), ``dense_5`` / ``dense_6`` its hidden and generator-input
    layers; ``ln_0`` / ``ln_1`` follow the attention and the FFN, ``ln_2``
    / ``ln_3`` smolgen's two layers.  A residual ``alpha * x + y`` is one
    add in the trunk's dtype."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        d, T = cfg.width, cfg.nb_vect
        comp, hidden, gen = cfg.smolgen
        self.heads, self.gen = cfg.heads, gen
        self.alpha = (2.0 * cfg.layers) ** 0.25
        self.dense_0 = nn.Linear(d, 3 * d)
        self.dense_1 = nn.Linear(d, d)
        self.dense_2 = nn.Linear(d, cfg.ffn)
        self.dense_3 = nn.Linear(cfg.ffn, d)
        self.dense_4 = nn.Linear(d, comp, bias=False)
        self.dense_5 = nn.Linear(T * comp, hidden)
        self.dense_6 = nn.Linear(hidden, cfg.heads * gen)
        self.ln_0 = nn.LayerNorm(d, eps=LN_EPS)
        self.ln_1 = nn.LayerNorm(d, eps=LN_EPS)
        self.ln_2 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.ln_3 = nn.LayerNorm(cfg.heads * gen, eps=LN_EPS)

    def smolgen(self, x, generator: nn.Linear):
        """The attention bias ``[B, H, T, T]`` from the layer's input ``x
        [B, T, d]``, through the generator all layers share."""
        B, T, _ = x.shape
        c = _dense_once(self.dense_4, x).reshape(B, -1)
        h = _layer_norm(self.ln_2, F.silu(_dense_once(self.dense_5, c)))
        g = _layer_norm(self.ln_3, F.silu(_dense_once(self.dense_6, h)))
        return _dense_once(generator, g.reshape(B, self.heads, self.gen)) \
            .reshape(B, self.heads, T, T)

    def forward(self, x, generator: nn.Linear, drop):
        B, T, d = x.shape
        H = self.heads
        qkv = _dense_once(self.dense_0, x).reshape(B, T, 3, H, d // H)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                 # [B, H, T, dh]
        att = F.scaled_dot_product_attention(
            q, k, v, attn_mask=self.smolgen(x, generator))
        att = _dense_once(self.dense_1, att.transpose(1, 2).reshape(B, T, d))
        x = _layer_norm(self.ln_0, torch.add(drop(att), x, alpha=self.alpha))
        f = _dense_once(self.dense_3, F.mish(_dense_once(self.dense_2, x)))
        return _layer_norm(self.ln_1, torch.add(drop(f), x, alpha=self.alpha))


class SplendorNetBT4(_Net):
    """nn_version 3: Leela Chess Zero's BT4 encoder transformer (lczero-
    training, ``tf/tfprocess.py``: ``encoder_layer``, ``smolgen_weights``)
    with each of the board's ``nb_vect`` rows as a token.  A row's 7
    features go through ``dense_0`` (7 -> width) and Mish, then the gating
    ``gate_0``; ``cfg.layers`` encoder layers ``enc_k`` follow, whose
    smolgen biases share one generator ``dense_1`` (gen -> T*T, no bias);
    the three heads ``dense_2..dense_7`` read the mean over tokens.  Two
    departures from Lc0: the heads (Splendor's actions are no row pairs,
    so Lc0's attention policy has nothing to map), and the port's
    ``init_params`` in place of DeepNorm's scaled Xavier init."""

    def __init__(self, cfg: NetConfig):
        super().__init__(cfg, (3,))
        d, T = cfg.width, cfg.nb_vect
        if d % cfg.heads:
            raise ValueError(f"width {d} is not a multiple of heads "
                             f"{cfg.heads}")
        self.dense_0 = nn.Linear(cfg.vect_dim, d)
        self.dense_1 = nn.Linear(cfg.smolgen[2], T * T, bias=False)
        self.gate_0 = Gating(T, d)
        for k in range(cfg.layers):
            setattr(self, f"enc_{k}", EncoderLayer(cfg))
        self._add_heads(d, 2)

    def forward(self, boards, valid_actions, generator=None):
        """Same contract as ``SplendorNet.forward``."""
        def drop(y):
            return self._drop(y, generator)
        x = self.gate_0(F.mish(_dense_once(self.dense_0, boards.to(self.dt))))
        for k in range(self.cfg.layers):
            x = getattr(self, f"enc_{k}")(x, self.dense_1, drop)
        return self._head_outputs(_mean(x, 1).float(), valid_actions)


# nn_version registry: versions 0 and 1 share the reference layer stack (the
# eras differ by action-space size, which lives in cfg.action_size)
NET_VERSIONS = {0: SplendorNet, 1: SplendorNet, 2: SplendorNetV2,
                3: SplendorNetBT4}


def init_params(net: nn.Module, generator: torch.Generator | None = None):
    """Flax's initializers, in place: ``kaiming_uniform`` kernels (variance
    scaling 2.0, fan_in, uniform: U(-sqrt(6/in), sqrt(6/in))), zero biases
    (where a Dense has one), BatchNorm and LayerNorm scale 1 and bias 0,
    running mean 0 and variance 1, gating multiply 1 and add 0.  Returns
    ``net``."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Linear):
                lim = math.sqrt(6.0 / m.in_features)
                w = torch.empty(m.weight.shape, dtype=m.weight.dtype)
                w.uniform_(-lim, lim, generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (FlaxBatchNorm, nn.LayerNorm, Gating)):
                m.reset_parameters()
    return net


def build_net(cfg: NetConfig, device="cuda",
              generator: torch.Generator | None = None) -> nn.Module:
    """The version ``cfg.nn_version`` names, in eval mode on ``device``,
    initialized by ``init_params`` from ``generator`` (a CPU generator;
    seed 0 when None).  Float32 matmuls run in full float32 on the GPU
    (TF32 off) for every net the port builds."""
    dev = resolve_device(device)
    try:
        cls = NET_VERSIONS[cfg.nn_version]
    except KeyError:
        raise ValueError(
            f"unknown nn_version {cfg.nn_version}; "
            f"registered: {sorted(NET_VERSIONS)}") from None
    full_fp32()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_params(cls(cfg), generator).to(dev).eval()


def _forward(net: nn.Module, boards, valid_actions):
    """``net``'s forward as it stands, under ``inference_mode``: (pi probs,
    v, log_sdiff)."""
    with torch.inference_mode():
        log_pi, v, log_sd = net(boards, valid_actions)
    return torch.exp(log_pi), v, log_sd


def apply_inference(net: nn.Module, boards, valid_actions):
    """Eval-mode forward: returns (pi probs, v, log_sdiff)."""
    net.eval()
    return _forward(net, boards, valid_actions)


# ------------------------------------------------------------ graphed inference
# A leaf evaluation of the search is ~40 small kernels, and launching them
# one by one costs the host more than the card spends on them.  On CUDA
# tensors ``infer`` replays them from one CUDA graph per net and input
# shape instead: the same kernels on the same shapes, so the same bits.
GRAPHS_PER_NET = 8              # graphs (and keys seen once) kept per net
_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


class _NetGraphs:
    """One net's captured forwards by key, least recently used first; the
    keys run eagerly once, which the next call at the key captures; and the
    memory pool all of them share."""

    def __init__(self, net: nn.Module):
        # live views of every module's parameters and buffers, so that a
        # tensor put in a parameter's place changes the key
        self.tensors = [d.values() for m in net.modules()
                        for d in (m._parameters, m._buffers) if d]
        self.graphs: OrderedDict = OrderedDict()
        self.seen: OrderedDict = OrderedDict()
        self.pool = None

    def storages(self) -> tuple:
        """Where each parameter and buffer lives: the graphs read them
        there, so an update in place keeps a graph valid and a new tensor
        does not."""
        return tuple([t.data_ptr() for vals in self.tensors for t in vals
                      if t is not None])

    def add(self, key, graph):
        self.graphs[key] = graph
        if len(self.graphs) > GRAPHS_PER_NET:
            self.graphs.popitem(last=False)
        return graph

    def saw(self, key):
        self.seen[key] = None
        self.seen.move_to_end(key)
        if len(self.seen) > GRAPHS_PER_NET:
            self.seen.popitem(last=False)


class _Graph:
    """``_forward`` of an eval-mode net captured for one input shape: a
    float32 board input and a mask input that each call copies into, the
    graph, and its outputs, of which each call returns copies."""

    def __init__(self, net: nn.Module, boards, valid_actions,
                 cache: _NetGraphs):
        dev = boards.device
        if cache.pool is None:
            cache.pool = torch.cuda.graph_pool_handle()
        self.boards = boards.to(torch.float32, copy=True,
                                memory_format=torch.contiguous_format)
        self.valids = valid_actions.clone(
            memory_format=torch.contiguous_format)
        with torch.cuda.device(dev):
            stream = torch.cuda.Stream()
            # warm up on the capture stream, outside the capture
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                _forward(net, self.boards, self.valids)
            torch.cuda.current_stream().wait_stream(stream)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=cache.pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = _forward(net, self.boards, self.valids)

    def __call__(self, boards, valid_actions):
        self.boards.copy_(boards)
        self.valids.copy_(valid_actions)
        self.graph.replay()
        probs, v, _ = self.out
        # copies no later replay overwrites (a search keeps its root value)
        return probs.clone(), v.clone()


def _graphed(net: nn.Module, boards, valid_actions):
    """``infer`` on an eval-mode net: eager at a key's first sight, captured
    at its second unless a profiler records, replayed after that.  A key is
    the boards' shape, dtype and device and where the net's tensors live.
    Counts ``net.eager_calls``, ``net.graph_captures`` and
    ``net.graph_replays`` while a profiler records (a capture never
    happens then)."""
    cache = _GRAPHS.get(net)
    if cache is None:
        cache = _GRAPHS[net] = _NetGraphs(net)
    key = (boards.shape, boards.dtype, boards.device, cache.storages())
    graph = cache.graphs.get(key)
    if graph is not None:
        cache.graphs.move_to_end(key)
    elif key in cache.seen and not profiling.recording():
        del cache.seen[key]
        graph = cache.add(key, _Graph(net, boards, valid_actions, cache))
        profiling.count("net.graph_captures")
    else:
        cache.saw(key)
        profiling.count("net.eager_calls")
        probs, v, _ = _forward(
            net, boards.to(torch.float32,
                           memory_format=torch.contiguous_format),
            valid_actions)
        return probs, v
    profiling.count("net.graph_replays")
    return graph(boards, valid_actions)


def infer(net: nn.Module, boards, valid_actions):
    """``apply_inference``'s (pi probs, v) for ``boards [B, R, 7]`` (int8 or
    float32, cast to float32 first) and ``valid_actions [B, A]``, leaving
    the net in eval mode.  On CPU tensors it is ``apply_inference``; on
    CUDA tensors the forward is replayed from a CUDA graph of the net at
    that shape (``_graphed``), equal to the eager call bit for bit, and
    the outputs are the caller's own.  Counts ``net.boards`` and
    ``net.tokens`` (boards x rows) while a profiler records."""
    profiling.count("net.boards", boards.shape[0])
    profiling.count("net.tokens", boards.shape[0] * boards.shape[1])
    if not boards.is_cuda:
        probs, v, _ = apply_inference(net, boards.to(torch.float32),
                                      valid_actions)
        return probs, v
    if net.training:
        net.eval()
    return _graphed(net, boards, valid_actions)


def running_stats(net: nn.Module) -> dict[str, torch.Tensor]:
    """The running statistics, by state_dict key."""
    return {k: v for k, v in net.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def apply_train(net: nn.Module, boards, valid_actions,
                generator: torch.Generator | None = None):
    """Train-mode forward: batch statistics in BatchNorm, whose running
    statistics move in place, and dropout masks from ``generator``.
    Returns ``((log_pi, v, log_sdiff), new running statistics)``."""
    net.train()
    out = net(boards, valid_actions, generator=generator)
    return out, running_stats(net)


def count_params(net: nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())


# ---------------------------------------------------------------- Flax layout
_KINDS = {"dense": "Dense", "bn": "BatchNorm", "gpool": "DenseAndPartialGPool",
          "ln": "LayerNorm", "gate": "Gating", "enc": "EncoderLayer"}
_KINDS_INV = {v: k for k, v in _KINDS.items()}
# a pool's own modules carry no number
_INNER = {"dense": "Dense_0", "bn": "BatchNorm_0"}
_INNER_INV = {v: k for k, v in _INNER.items()}
# state_dict leaf -> (Flax collection, leaf name); "weight" is a Dense
# "kernel" or a norm's "scale"
_LEAVES = {"bias": ("params", "bias"),
           "mul": ("params", "mul"), "add": ("params", "add"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")}


def _flax_name(name: str) -> str:
    kind, k = name.rsplit("_", 1)
    return f"{_KINDS[kind]}_{k}"


def _port_name(name: str) -> str:
    kind, k = name.rsplit("_", 1)
    return f"{_KINDS_INV[kind]}_{k}"


def _flax_module(module: str) -> tuple[str, ...]:
    """Port module path -> Flax module path ("gpool_1.bn" ->
    ("DenseAndPartialGPool_1", "BatchNorm_0"), "enc_3.ln_1" ->
    ("EncoderLayer_3", "LayerNorm_1"))."""
    head, *inner = module.split(".")
    return (_flax_name(head),) + tuple(_INNER.get(i) or _flax_name(i)
                                       for i in inner)


def _port_module(path: tuple[str, ...]) -> str:
    head = _port_name(path[0])
    pool = head.startswith("gpool_")
    return ".".join([head] + [_INNER_INV[p] if pool else _port_name(p)
                              for p in path[1:]])


def bt4_dims(params) -> dict:
    """``NetConfig``'s version-3 sizes (``width``, ``layers``, ``heads``,
    ``ffn``, ``smolgen``) read from the shapes of a Flax-layout ``params``
    tree, which a checkpoint's meta does not carry."""
    def shape(*path):
        node = params
        for p in path:
            node = node[p]
        return np.shape(node["kernel"])
    layers = sum(1 for k in params if k.startswith("EncoderLayer_"))
    enc = "EncoderLayer_0"
    gen = shape("Dense_1")[0]
    return {"width": shape("Dense_0")[1], "layers": layers,
            "heads": shape(enc, "Dense_6")[1] // gen,
            "ffn": shape(enc, "Dense_2")[1],
            "smolgen": (shape(enc, "Dense_4")[1], shape(enc, "Dense_5")[1],
                        gen)}


def from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """A state_dict from Flax ``(params, batch_stats)`` trees of arrays (as
    ``alphazero_tpu.v1`` checkpoints hold them), for any version."""
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in tree_items(params):
        mod, name = _port_module(path[:-1]), path[-1]
        a = np.array(leaf, np.float32)                  # a writable copy
        if name == "kernel":
            sd[f"{mod}.weight"] = torch.from_numpy(np.ascontiguousarray(a.T))
        elif name == "scale":
            sd[f"{mod}.weight"] = torch.from_numpy(a)
        else:
            sd[f"{mod}.{name}"] = torch.from_numpy(a)
    for path, leaf in tree_items(batch_stats):
        mod, name = _port_module(path[:-1]), path[-1]
        sd[f"{mod}.running_{name}"] = torch.from_numpy(np.array(leaf,
                                                                np.float32))
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
    return sd


def to_flax(state_dict) -> tuple[dict, dict]:
    """Flax ``(params, batch_stats)`` numpy trees from a state_dict (or
    any dict of parameter-shaped tensors, such as Adam moments, whose
    ``batch_stats`` is then empty): the inverse of ``from_flax``."""
    trees = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        mod, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight" and a.ndim == 2:
            coll, name, a = "params", "kernel", np.ascontiguousarray(a.T)
        elif leaf == "weight":
            coll, name = "params", "scale"
        else:
            coll, name = _LEAVES[leaf]
        node = trees[coll]
        for p in _flax_module(mod):
            node = node.setdefault(p, {})
        node[name] = a
    return trees["params"], trees["batch_stats"]
