"""Leela Chess Zero's BT4 encoder transformer over Splendor boards, in plain
PyTorch and float32, eval mode: the reference that ``SplendorNet`` version 3
is held to.

Source: lczero-training, ``tf/tfprocess.py`` (``encoder_layer``,
``smolgen_weights``), the net ``BT4-1024x15x32h``: embedding width 1024, 15
encoder layers, 32 heads.  For boards ``[B, T, 7]`` (each of the T rows a
token):

    x   = gate_mul * mish(rows W_emb + b_emb) + gate_add             [B, T, d]
    for each layer:
        C   = x W_c                    (d -> c, no bias)             smolgen
        h   = LN(swish(flatten(C) W_1 + b_1))                        c*T -> hidden
        G   = LN(swish(h W_2 + b_2)).reshape(H, gen)                 hidden -> H*gen
        S   = (G W_gen).reshape(H, T, T)   (gen -> T*T, no bias, one W_gen
                                            for all layers)
        att = concat_h(softmax(Q_h K_h^T / sqrt(d/H) + S_h) V_h) W_o + b_o
        x   = LN(alpha x + att)
        x   = LN(alpha x + mish(x W_f1 + b_f1) W_f2 + b_f2)
    y   = mean over tokens of x
    probs  = softmax(masked(y W_p1 + b_p1) W_p2 + b_p2)
    values = tanh((y W_v1 + b_v1) W_v2 + b_v2)

with alpha = (2 * layers) ** 0.25 (DeepNorm's encoder rule), every
LayerNorm's epsilon 1e-3 and swish(x) = x * sigmoid(x).

Departures from Lc0: the policy and value heads read the mean over tokens
(Lc0's attention policy maps square pairs, and Splendor's actions are no
row pairs); there is no moves-left head; the weights are whatever the
state dict holds, untrained (the benchmark draws them from a seed, the
program initializes with its own rule, neither with DeepNorm's scaled
Xavier).

Weights are read from a version-3 ``state_dict`` by key: ``dense_0`` the
embedding, ``gate_0.mul`` / ``.add`` the gating, ``dense_1`` the shared
generator, ``dense_2``..``dense_5`` the policy and value heads (the
score-difference head ``dense_6`` / ``dense_7`` is not computed), and per
layer ``enc_k.``: ``dense_0`` Q, K and V stacked on the output axis (head
``h`` of each its rows ``h*dh..(h+1)*dh``), ``dense_1`` the output,
``dense_2`` / ``dense_3`` the FFN, ``dense_4`` / ``dense_5`` / ``dense_6``
smolgen's compression, hidden and generator-input layers, ``ln_0`` /
``ln_1`` after the attention and the FFN, ``ln_2`` / ``ln_3`` smolgen's.
A ``weight`` is ``nn.Linear``'s ``(out, in)``.  Every size is read from the
shapes.  Float32 matmuls run in full float32 (TF32 off) while it runs.
Nothing here imports the program, JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

LOW_VALUE = -1e8
LN_EPS = 1e-3


@contextlib.contextmanager
def full_fp32():
    """Float32 matmuls and convolutions without TF32 while open; the
    previous settings come back after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def mish(x):
    return x * torch.tanh(F.softplus(x))


def swish(x):
    return x * torch.sigmoid(x)


class BT4:
    """``__call__(boards [B, T, 7] float32, valid [B, A] bool) -> (probs [B,
    A], values [B, P])`` from a version-3 ``state_dict`` on ``device``."""

    def __init__(self, state_dict: dict, device):
        self.w = {k: v.detach().to(device=device, dtype=torch.float32)
                  for k, v in state_dict.items()}
        self.layers = sum(1 for k in self.w
                          if k.startswith("enc_") and k.endswith(
                              ".dense_0.weight"))
        self.gen = self.w["dense_1.weight"].shape[1]
        self.heads = self.w["enc_0.dense_6.weight"].shape[0] // self.gen
        self.alpha = (2.0 * self.layers) ** 0.25

    def _dense(self, name: str, x):
        """A Dense of the trunk."""
        return F.linear(x, self.w[f"{name}.weight"],
                        self.w.get(f"{name}.bias"))

    def _head(self, name: str, x):
        return F.linear(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"])

    def _ln(self, name: str, x):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], LN_EPS)

    def _smolgen(self, p: str, x):
        B, T, _ = x.shape
        c = self._dense(p + "dense_4", x).reshape(B, -1)
        h = self._ln(p + "ln_2", swish(self._dense(p + "dense_5", c)))
        g = self._ln(p + "ln_3", swish(self._dense(p + "dense_6", h)))
        g = g.reshape(B, self.heads, self.gen)
        return self._dense("dense_1", g).reshape(B, self.heads, T, T)

    def _attention(self, p: str, x, bias):
        B, T, d = x.shape
        H = self.heads
        dh = d // H
        qkv = self._dense(p + "dense_0", x)

        def split(i):
            return qkv[..., i * d:(i + 1) * d].reshape(B, T, H, dh) \
                .transpose(1, 2)
        q, k, v = split(0), split(1), split(2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh) + bias
        att = torch.matmul(torch.softmax(logits, -1), v)        # [B, H, T, dh]
        return self._dense(p + "dense_1", att.transpose(1, 2).reshape(B, T, d))

    @torch.no_grad()
    def __call__(self, boards, valid):
        with full_fp32():
            return self._forward(boards, valid)

    def _forward(self, boards, valid):
        w = self.w
        x = mish(self._dense("dense_0", boards))
        x = x * w["gate_0.mul"] + w["gate_0.add"]
        for k in range(self.layers):
            p = f"enc_{k}."
            att = self._attention(p, x, self._smolgen(p, x))
            x = self._ln(p + "ln_0", self.alpha * x + att)
            f = self._dense(p + "dense_3", mish(self._dense(p + "dense_2", x)))
            x = self._ln(p + "ln_1", self.alpha * x + f)
        y = x.mean(1)
        pi = self._head("dense_3", self._head("dense_2", y))
        pi = torch.where(valid, pi, LOW_VALUE)
        v = torch.tanh(self._head("dense_5", self._head("dense_4", y)))
        return torch.softmax(pi, -1), v
