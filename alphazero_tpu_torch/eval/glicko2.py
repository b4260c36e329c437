"""Glicko-2 ratings (Glickman 2013 public specification): the port's copy of
``alphazero_tpu/eval/glicko2.py``.  A ``RatingBook`` file has the same JSON
layout in both packages, so either package reads what the other wrote."""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

TAU = 0.5
EPS = 1e-6
SCALE = 173.7178


@dataclass
class Rating:
    rating: float = 1500.0
    rd: float = 350.0
    vol: float = 0.06

    @property
    def mu(self):
        return (self.rating - 1500.0) / SCALE

    @property
    def phi(self):
        return self.rd / SCALE


def _g(phi):
    return 1.0 / math.sqrt(1.0 + 3.0 * phi * phi / math.pi ** 2)


def _expect(mu, mu_j, phi_j):
    return 1.0 / (1.0 + math.exp(-_g(phi_j) * (mu - mu_j)))


def update(player: Rating, opponents: list[Rating],
           scores: list[float]) -> Rating:
    """One rating period: ``scores[j]`` is 1 win / 0.5 draw / 0 loss vs
    ``opponents[j]``.  Empty period -> RD decays only."""
    mu, phi, vol = player.mu, player.phi, player.vol
    if not opponents:
        phi_star = math.sqrt(phi * phi + vol * vol)
        return Rating(player.rating, phi_star * SCALE, vol)

    v_inv = 0.0
    delta_sum = 0.0
    for opp, s in zip(opponents, scores):
        e = _expect(mu, opp.mu, opp.phi)
        g = _g(opp.phi)
        v_inv += g * g * e * (1 - e)
        delta_sum += g * (s - e)
    v = 1.0 / v_inv
    delta = v * delta_sum

    # volatility iteration (Illinois algorithm)
    a = math.log(vol * vol)

    def f(x):
        ex = math.exp(x)
        num = ex * (delta * delta - phi * phi - v - ex)
        den = 2.0 * (phi * phi + v + ex) ** 2
        return num / den - (x - a) / (TAU * TAU)

    A = a
    if delta * delta > phi * phi + v:
        B = math.log(delta * delta - phi * phi - v)
    else:
        k = 1
        while f(a - k * TAU) < 0:
            k += 1
        B = a - k * TAU
    fa, fb = f(A), f(B)
    while abs(B - A) > EPS:
        C = A + (A - B) * fa / (fb - fa)
        fc = f(C)
        if fc * fb <= 0:
            A, fa = B, fb
        else:
            fa = fa / 2.0
        B, fb = C, fc
    new_vol = math.exp(A / 2.0)

    phi_star = math.sqrt(phi * phi + new_vol * new_vol)
    new_phi = 1.0 / math.sqrt(1.0 / (phi_star * phi_star) + 1.0 / v)
    new_mu = mu + new_phi * new_phi * delta_sum
    return Rating(new_mu * SCALE + 1500.0, new_phi * SCALE, new_vol)


# ----------------------------------------------------------------- storage
@dataclass
class RatingBook:
    """JSON-persisted ratings keyed by agent name (reference pit.py:156-184)."""
    path: str
    ratings: dict = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "RatingBook":
        book = cls(path)
        if os.path.exists(path):
            with open(path) as f:
                raw = json.load(f)
            book.ratings = {k: Rating(**v) for k, v in raw.items()}
        return book

    def get(self, name: str) -> Rating:
        return self.ratings.setdefault(name, Rating())

    def record_match(self, name_a: str, name_b: str, score_a: float):
        ra, rb = self.get(name_a), self.get(name_b)
        new_a = update(ra, [rb], [score_a])
        new_b = update(rb, [ra], [1.0 - score_a])
        self.ratings[name_a], self.ratings[name_b] = new_a, new_b

    def save(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({k: vars(v) for k, v in self.ratings.items()}, f,
                      indent=2)
