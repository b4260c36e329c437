"""Host-side replay buffer: port of ``alphazero_tpu/train/replay.py``.

Columnar numpy storage (boards int8, policies float16) on the host, as in
the JAX package: ``Iteration`` has the same columns, dtypes and meaning,
``sample`` draws the same ids from the same ``np.random.Generator`` calls,
and the on-disk format ``azt-replay-v2`` is byte-compatible in both
directions (per-iteration slabs compressed through the native replay core,
or numpy/zlib without it)."""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field

import numpy as np

from ..utils import native


@dataclass
class Iteration:
    boards: np.ndarray      # (E, R, 7) int8   canonical
    pi: np.ndarray          # (E, A) float16
    winner: np.ndarray      # (E, P) float16
    scdiff: np.ndarray      # (E, P) int8
    valids: np.ndarray      # (E, A) bool
    surprise: np.ndarray    # (E, P) float16 — per-player |root-Q - winner|

    def __len__(self):
        return len(self.boards)


@dataclass
class ReplayBuffer:
    """Rolling history of the last ``history`` self-play iterations
    (reference numItersHistory, Coach.py:133-134)."""
    history: int = 5
    max_per_iter: int = 400_000
    iterations: list = field(default_factory=list)
    _flat_cache: dict = field(default_factory=dict, repr=False)

    def add_iteration(self, it: Iteration):
        if len(it) > self.max_per_iter:
            it = Iteration(*(a[: self.max_per_iter] for a in
                             (it.boards, it.pi, it.winner, it.scdiff,
                              it.valids, it.surprise)))
        self.iterations.append(it)
        while len(self.iterations) > self.history:
            self.iterations.pop(0)
        self._flat_cache.clear()

    def __len__(self):
        return sum(len(it) for it in self.iterations)

    def _flat(self, name):
        # cached: sample() is called hundreds of times between buffer
        # mutations, and re-concatenating the whole history per call would
        # memcpy the full buffer each time
        if name not in self._flat_cache:
            self._flat_cache[name] = np.concatenate(
                [getattr(it, name) for it in self.iterations])
        return self._flat_cache[name]

    def sample(self, batch_size: int, rng: np.random.Generator,
               surprise_weight: bool = False, allowed: np.ndarray = None):
        """Random minibatch across the whole history (reference
        GenericNNetWrapper.py:70).  With surprise weighting, sampling
        probability is surprise-proportional plus a uniform floor (repairing
        the reference's :333-341 intent).  ``allowed`` restricts sampling to
        a subset of flat indices (used to hold out a validation split,
        reference GenericNNetWrapper.py:108-118)."""
        n = len(self)
        seed = int(rng.integers(0, 2 ** 62))
        if surprise_weight:
            s = self._flat("surprise").astype(np.float64)
            if s.ndim > 1:            # per-player vector -> mean over seats
                s = s.mean(axis=1)
            if allowed is not None:
                s = s[allowed]
            p = s / max(s.sum(), 1e-9) + 1.0 / len(s)
            ids = native.sample_weighted(p.astype(np.float32), batch_size, seed)
        else:
            pool = n if allowed is None else len(allowed)
            ids = native.sample_uniform(pool, batch_size, seed)
        if len(ids) < batch_size:
            # pool smaller than the request (tiny buffers / fused K*B draws):
            # top up with replacement so callers always get exactly
            # ``batch_size`` rows
            pool = n if allowed is None else len(allowed)
            extra = rng.integers(0, pool, batch_size - len(ids))
            ids = np.concatenate([ids, extra])
        if allowed is not None:
            ids = allowed[ids]
        return self.gather(ids)

    def gather(self, ids: np.ndarray):
        """Fixed-index batch (validation splits, deterministic probes)."""
        return {name: self._flat(name)[ids]
                for name in ("boards", "pi", "winner", "scdiff", "valids")}

    # ------------------------------------------------------------------ I/O
    # On-disk format v2: per-iteration columnar slabs zlib-compressed through
    # the native core (native/replay_core.cpp; numpy/zlib fallback) — the
    # whole-slab analog of the reference's per-example zlib pickles
    # (Coach.py:100, level 1, ~1.2 kB/example budget per main.py:138).
    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        blob = {"format": "azt-replay-v2", "iterations": []}
        for it in self.iterations:
            rec = {}
            for name, arr in it.__dict__.items():
                arr = np.ascontiguousarray(arr)
                rec[name] = (arr.shape, arr.dtype.str,
                             native.compress(arr.tobytes(), level=1))
            blob["iterations"].append(rec)
        with open(path, "wb") as f:
            pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def load(cls, path: str, history: int = 5, max_per_iter: int = 400_000):
        buf = cls(history=history, max_per_iter=max_per_iter)
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if isinstance(blob, dict) and blob.get("format") == "azt-replay-v2":
            for rec in blob["iterations"]:
                arrays = {}
                for name, (shape, dtype, data) in rec.items():
                    size = int(np.prod(shape)) * np.dtype(dtype).itemsize
                    arrays[name] = np.frombuffer(
                        native.decompress(data, size),
                        dtype=dtype).reshape(shape)
                buf.add_iteration(Iteration(**arrays))
        else:                                   # v1: raw array dicts
            for d in blob:
                buf.add_iteration(Iteration(**d))
        return buf
