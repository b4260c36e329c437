"""Import reference PyTorch checkpoints into the port's network: port of
``alphazero_tpu/compat/torch_import.py``.

The reference saves ``{'state_dict': ..., 'full_model': <pickled nn.Module>,
**training_args}`` (GenericNNetWrapper.py:185-198).  Unpickling the
full_model requires the reference's class definitions; any class that no
longer imports is replaced by a placeholder, so the tensors in
``state_dict`` load cleanly.  They are then mapped onto the port's own
module names (``models/splendor_net.py``).  Both layouts are PyTorch's, so
a mapped tensor is copied as it is: no transpose.
"""

from __future__ import annotations

import io
import pickle

import torch

from ..models import splendor_net as N


class _Stub:
    """Placeholder for unpicklable (reference-only) classes."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        self.__dict__["_state"] = state


def torch_load_tolerant(path: str) -> dict:
    """torch.load that substitutes stubs for missing classes."""

    class TolerantUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (_Stub,), {"__module__": module})

    class _PickleModule:
        Unpickler = TolerantUnpickler

        @staticmethod
        def load(f, **kw):
            kw.pop("encoding", None)
            return TolerantUnpickler(f).load()

        @staticmethod
        def loads(b, **kw):
            return TolerantUnpickler(io.BytesIO(b)).load()

    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_PickleModule)


def _mapping() -> list[tuple[str, str]]:
    """``(reference key, port key)`` for every tensor the reference's
    SplendorNNet (SplendorNNet.py:56-159) holds; a port module ``dense_k``
    / ``bn_k`` / ``gpool_k`` is the Flax ``Dense_k`` / ``BatchNorm_k`` /
    ``DenseAndPartialGPool_k`` of the JAX map."""
    m: list[tuple[str, str]] = []

    def linear(ref, port):
        m.extend((f"{ref}.{leaf}", f"{port}.{leaf}")
                 for leaf in ("weight", "bias"))

    def bn(ref, port):
        m.extend((f"{ref}.{leaf}", f"{port}.{leaf}")
                 for leaf in ("weight", "bias", "running_mean",
                              "running_var"))

    linear("dense2d_1.0", "dense_0")
    bn("dense2d_1.1", "bn_0")
    linear("dense2d_1.3", "dense_1")
    linear("partialgpool_1.dense_part.0", "gpool_0.dense")
    bn("partialgpool_1.dense_part.1", "gpool_0.bn")
    linear("dense2d_3.0", "dense_2")
    linear("dense1d_4.0", "dense_3")
    linear("partialgpool_4.dense_part.0", "gpool_1.dense")
    bn("partialgpool_4.dense_part.1", "gpool_1.bn")
    linear("dense1d_5.0", "dense_4")
    bn("dense1d_5.1", "bn_1")
    linear("dense1d_5.3", "dense_5")
    linear("partialgpool_5.dense_part.0", "gpool_2.dense")
    bn("partialgpool_5.dense_part.1", "gpool_2.bn")
    for k, head in enumerate(("PI", "V", "SDIFF")):
        linear(f"output_layers_{head}.0", f"dense_{6 + 2 * k}")
        linear(f"output_layers_{head}.1", f"dense_{7 + 2 * k}")
    return m


def _fit(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """``src`` in ``tgt``'s shape: as it is when the shapes agree; a
    406-era PI head (actions 0-404 + pass at 405) remapped into the 409
    space, where pass moved to 408 (405-407 = noble select, kept from
    ``tgt``); otherwise the overlap of the two shapes over ``tgt``."""
    if src.shape == tgt.shape:
        return src.clone()
    out = tgt.clone()
    if 406 in src.shape and 409 in tgt.shape:
        axis = next(i for i, (a, b) in enumerate(zip(src.shape, tgt.shape))
                    if (a, b) == (406, 409))
        s, o = src.movedim(axis, 0), out.movedim(axis, 0)   # views of each
        o[:405] = s[:405]
        o[408] = s[405]
        return out
    sl = tuple(slice(0, min(a, b)) for a, b in zip(src.shape, tgt.shape))
    out[sl] = src[sl]
    return out


def load_as_bundle(path: str, net_cfg: N.NetConfig):
    """Load a reference .pt: ``(state_dict, meta)`` for a port net of
    ``net_cfg`` (version 0 or 1).  Every mapped tensor is the reference's,
    fitted by ``_fit`` (the PI head across the action-space growth, other
    size changes by min-size slicing); what the reference does not give
    comes from ``init_params`` at seed 0.
    ``meta`` holds the checkpoint's training arguments."""
    if net_cfg.nn_version == 3:
        raise ValueError("nn_version 3 (the BT4 transformer): the "
                         "reference's SplendorNNet has no such net to "
                         "import from")
    ckpt = torch_load_tolerant(path)
    sd = ckpt["state_dict"]
    target = N.build_net(net_cfg, "cpu").state_dict()
    out = dict(target)
    for ref_key, port_key in _mapping():
        if ref_key not in sd:
            raise KeyError(f"missing torch key {ref_key}")
        src = sd[ref_key].detach().to("cpu", torch.float32)
        out[port_key] = _fit(src, target[port_key])
    meta = {k: v for k, v in ckpt.items()
            if k not in ("state_dict", "full_model")}
    return out, meta
