"""Read ``alphazero_tpu.v1`` checkpoints without JAX.

A v1 checkpoint is a pickle of ``{"params", "batch_stats", "opt_state",
"meta", "format"}`` whose arrays are numpy.  The optimizer state pickles
optax (and possibly flax) classes, which this package does not have: the
unpickler maps every class of those packages to a stub, so the file loads
and the port reads only ``params``, ``batch_stats`` and ``meta``."""

from __future__ import annotations

import os
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


def load_checkpoint(folder: str, filename: str) -> dict:
    """``{"params", "batch_stats", "meta"}`` of a v1 checkpoint file."""
    with open(os.path.join(folder, filename), "rb") as f:
        ckpt = _Unpickler(f).load()
    if ckpt.get("format") != FORMAT:
        raise ValueError(f"{filename}: not an {FORMAT} checkpoint "
                         f"(format={ckpt.get('format')!r})")
    return {k: ckpt[k] for k in ("params", "batch_stats", "meta")}
