"""Reader of the ``alphazero_tpu.v1`` checkpoint files (a pickled dict of
numpy trees), with classes of packages that are not installed (the
optimizer state's ``optax`` named tuples) read as inert stubs.

The benchmark reads each configuration's checkpoint once, checks its
sha256 against the configuration file, and hands the same numpy arrays to
the program and to the reference."""

from __future__ import annotations

import hashlib
import pickle

FORMAT = "alphazero_tpu.v1"
_STUBBED = ("optax", "flax", "jax", "jaxlib", "chex")


class _Stub(tuple):
    """Placeholder for a class of a package that is not installed."""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _STUBBED:
            return type(name, (_Stub,), {"__module__": module})
        return super().find_class(module, name)


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def load(path: str, want_sha256: str) -> dict:
    """The checkpoint dict at ``path``; raises unless its sha256 is
    ``want_sha256`` and it is an ``alphazero_tpu.v1`` file."""
    got = sha256(path)
    if got != want_sha256:
        raise ValueError(f"{path}: sha256 {got}, the configuration pins "
                         f"{want_sha256}")
    with open(path, "rb") as f:
        ckpt = _Unpickler(f).load()
    if not isinstance(ckpt, dict) or ckpt.get("format") != FORMAT:
        raise ValueError(f"{path}: not an {FORMAT} checkpoint")
    return ckpt


def tree_items(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from tree_items(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]
