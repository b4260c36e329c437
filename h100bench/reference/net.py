"""SplendorNet version 1 in plain PyTorch, eval mode: the three-head net
(policy, value, score difference) that evaluates the search's leaves, read
straight from a checkpoint's Flax ``(params, batch_stats)`` numpy trees.

A Flax ``Dense`` kernel is ``(in, out)`` and computes ``x @ kernel +
bias``; here it is applied as ``F.linear`` with the transposed kernel.
BatchNorm in eval mode normalizes with the running statistics (eps 1e-5)
over the feature axis 1.  Float32 matmuls run in full float32 unless the
caller asks for TF32 (the control of the comparison)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

LOW_VALUE = -1e8
BN_EPS = 1e-5


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 matmuls and convolutions in TF32 (``tf32``) or in full
    float32 while open; the previous settings come back after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class NetV1:
    """``__call__(boards [B, R, 7] float32, valid [B, A] bool) -> (probs [B,
    A], values [B, P])``: the softmax of the masked policy logits and the
    tanh value per seat, in the board's own frame."""

    def __init__(self, params: dict, batch_stats: dict, width: int,
                 device, tf32: bool = False):
        self.width, self.tf32 = width, tf32
        dev = torch.device(device)

        def t(a):
            return torch.from_numpy(np.array(a, np.float32)).to(dev)

        def dense(p):
            return (t(np.ascontiguousarray(np.asarray(p["kernel"]).T)),
                    t(p["bias"]))

        def bn(p, s):
            return t(s["mean"]), t(s["var"]), t(p["scale"]), t(p["bias"])

        self.d = {k: dense(v) for k, v in params.items()
                  if k.startswith("Dense_")}
        self.bn = {k: bn(params[k], batch_stats[k]) for k in params
                   if k.startswith("BatchNorm_")}
        self.gp = {k: (dense(v["Dense_0"]),
                       bn(v["BatchNorm_0"], batch_stats[k]["BatchNorm_0"]))
                   for k, v in params.items()
                   if k.startswith("DenseAndPartialGPool_")}

    @staticmethod
    def _lin(wb, x):
        return F.linear(x, *wb)

    @staticmethod
    def _bn(p, x):
        mean, var, scale, bias = p
        return F.batch_norm(x, mean, var, scale, bias, False, 0.0, BN_EPS)

    def _gpool(self, name, x, groups, items):
        wb, bnp = self.gp[name]
        n = groups * items
        g = x[..., :n].reshape(*x.shape[:-1], groups, items)
        d = F.relu(self._bn(bnp, self._lin(wb, x[..., n:])))
        return torch.cat([g.amax(-1), g.mean(-1), d], -1)

    @torch.no_grad()
    def __call__(self, boards, valid):
        with matmul_precision(self.tf32):
            return self._forward(boards, valid)

    def _forward(self, boards, valid):
        d, w = self.d, self.width
        x = boards.transpose(-1, -2)                          # [B, 7, R]
        x = F.relu(self._bn(self.bn["BatchNorm_0"], self._lin(d["Dense_0"],
                                                              x)))
        x = F.relu(self._lin(d["Dense_1"], x))
        x = self._gpool("DenseAndPartialGPool_0", x, 4, 8)
        x = F.relu(self._lin(d["Dense_2"], x))
        # pool the first 5 channels of the first w/2 features, flatten
        b, half = x.shape[0], w // 2
        first, last = x[:, :5, :half], x[:, 5:, :half]
        x = torch.cat([first.amax(1), first.mean(1), last.reshape(b, -1),
                       x[:, :, half:].reshape(b, -1)], -1)[:, None, :]
        x = F.relu(self._lin(d["Dense_3"], x))
        x = self._gpool("DenseAndPartialGPool_1", x, 4, 4)
        x = F.relu(self._bn(self.bn["BatchNorm_1"], self._lin(d["Dense_4"],
                                                              x)))
        x = F.relu(self._lin(d["Dense_5"], x))
        x = self._gpool("DenseAndPartialGPool_2", x, 4, 4)[:, 0, :]
        pi = self._lin(d["Dense_7"], self._lin(d["Dense_6"], x))
        pi = torch.where(valid, pi, LOW_VALUE)
        v = torch.tanh(self._lin(d["Dense_9"], self._lin(d["Dense_8"], x)))
        return torch.exp(F.log_softmax(pi, -1)), v

