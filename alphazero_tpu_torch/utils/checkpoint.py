"""Checkpoint I/O in the JAX package's format, without JAX.

Port of ``alphazero_tpu/utils/checkpoint.py``.  A checkpoint is a pickle of
``{"params", "batch_stats", "opt_state", "meta", "format":
"alphazero_tpu.v1"}`` whose ``params`` and ``batch_stats`` are Flax-layout
trees of numpy arrays (``models.splendor_net.to_flax`` / ``from_flax``
convert), so a file either package writes loads strictly in the other.
The port writes its ``opt_state`` as ``{"count", "mu", "nu"}`` with
Flax-layout moment trees.  A JAX file's ``opt_state`` pickles optax (and
possibly flax) classes, which this package does not have: the unpickler
maps every class of those packages to a tuple stub, so optax's
``ScaleByAdamState`` reads as the 3-tuple ``(count, mu, nu)``.

Partial transfers slice each leaf in the Flax layout, so growing or
shrinking an architecture keeps the same entries as in the JAX package.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

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


def tree_items(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict in sorted key order (the
    order ``jax.tree_util`` flattens a dict in)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from tree_items(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _tree_map(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def _to_numpy(tree):
    if tree is None:
        return None
    return _tree_map(lambda _, x: np.asarray(x), tree)


def save_checkpoint(folder: str, filename: str, *, params, batch_stats,
                    opt_state=None, meta: dict | None = None):
    """Write Flax-layout ``params``/``batch_stats`` (and ``opt_state``)
    atomically; returns the path."""
    os.makedirs(folder, exist_ok=True)
    payload = {
        "params": _to_numpy(params),
        "batch_stats": _to_numpy(batch_stats),
        "opt_state": _to_numpy(opt_state),
        "meta": meta or {},
        "format": FORMAT,
    }
    path = os.path.join(folder, filename)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def load_checkpoint(folder: str, filename: str) -> dict:
    """The whole checkpoint dict; raises unless it is an ``alphazero_tpu.v1``
    file."""
    with open(os.path.join(folder, filename), "rb") as f:
        ckpt = _Unpickler(f).load()
    if not isinstance(ckpt, dict) or ckpt.get("format") != FORMAT:
        raise ValueError(f"{filename}: not an {FORMAT} checkpoint")
    return ckpt


def load_net(path: str, env_cfg, device):
    """``(net, meta)`` of the checkpoint file at ``path``: a
    ``SplendorNet`` for ``env_cfg`` on ``device`` holding its weights; the
    net's version and width come from the meta (v1, width 128 without
    them), version 3's sizes from its parameters' shapes."""
    from ..games.splendor import adapter as A
    from ..models import splendor_net as N
    ckpt = load_checkpoint(os.path.dirname(path) or ".",
                           os.path.basename(path))
    meta = ckpt.get("meta", {})
    version = int(meta.get("nn_version", 1))
    dims = ({"width": int(meta.get("net_width", 128))} if version != 3
            else N.bt4_dims(ckpt["params"]))
    net = N.build_net(A.net_config_for(env_cfg, nn_version=version, **dims),
                      device)
    net.load_state_dict(N.from_flax(ckpt["params"], ckpt["batch_stats"]))
    return net, meta


def _shapes_match(loaded_params, target_params) -> bool:
    try:
        la = [v for _, v in tree_items(loaded_params)]
        ta = [v for _, v in tree_items(target_params)]
        return (len(la) == len(ta)
                and all(np.shape(a) == np.shape(b) for a, b in zip(la, ta)))
    except Exception:
        return False


def load_network(folder: str, filename: str, target_params=None,
                 fallback: bool = True, target_batch_stats=None) -> dict:
    """Robust checkpoint load chain: strict load when every leaf shape
    matches the Flax-layout ``target_params`` -> shape-sliced partial
    transfer across architectures -> with ``fallback``, sibling checkpoints
    (temp.pt / best.pt / newest checkpoint_N.pt) when the requested file is
    missing or unreadable.  Pass ``fallback=False`` for user-requested
    resumes, where silently loading a different network would hide a
    typoed path.

    Returns the checkpoint dict with ``params`` already reconciled against
    ``target_params`` (when given; on a partial transfer the running
    statistics follow the same slicing against ``target_batch_stats``, when
    given) and a ``load_mode`` key in
    {"strict", "partial"} plus ``load_source`` (the file actually used)."""
    import logging
    log = logging.getLogger(__name__)

    candidates = [filename]
    if fallback:
        for alt in ("temp.pt", "best.pt"):
            if alt != filename:
                candidates.append(alt)
        try:
            iters = sorted(
                (f for f in os.listdir(folder)
                 if f.startswith("checkpoint_") and f.endswith(".pt")),
                key=lambda f: -int("".join(filter(str.isdigit, f)) or 0))
            candidates.extend(f for f in iters if f not in candidates)
        except OSError:
            pass

    last_err = None
    for cand in candidates:
        path = os.path.join(folder, cand)
        if not os.path.exists(path):
            continue
        try:
            ckpt = load_checkpoint(folder, cand)
        except Exception as e:          # corrupt/truncated file: keep walking
            log.warning("checkpoint %s unreadable (%s); trying next", path, e)
            last_err = e
            continue
        if cand != filename:
            log.warning("requested checkpoint %s unavailable; loaded %s",
                        filename, cand)
        if target_params is None or _shapes_match(ckpt["params"],
                                                  target_params):
            ckpt["load_mode"] = "strict"
        else:
            log.warning("architecture mismatch: shape-sliced partial weight "
                        "transfer")
            ckpt["params"] = transfer_partial(ckpt["params"], target_params)
            if target_batch_stats is not None:
                ckpt["batch_stats"] = transfer_partial(ckpt["batch_stats"],
                                                       target_batch_stats)
            ckpt["load_mode"] = "partial"
        ckpt["load_source"] = cand
        return ckpt
    raise FileNotFoundError(
        f"no loadable checkpoint in {folder!r} "
        f"(tried {candidates!r})") from last_err


def transfer_partial(loaded_params, target_params):
    """Min-shape sliced copy per leaf, matched by Flax path: grow/shrink
    architectures while keeping overlapping weights."""
    l_paths = dict(tree_items(loaded_params))

    def merge(path, tgt):
        if path not in l_paths:
            return tgt
        src = np.asarray(l_paths[path])
        tgt_np = np.asarray(tgt)
        if src.shape == tgt_np.shape:
            return src.astype(tgt_np.dtype)
        if src.ndim != tgt_np.ndim:
            return tgt
        out = tgt_np.copy()
        slices = tuple(slice(0, min(a, b)) for a, b in zip(src.shape, out.shape))
        out[slices] = src[slices]
        return out

    return _tree_map(merge, target_params)


def save_settings(folder: str, settings: dict):
    """``settings.json`` always holds the CURRENT settings; when a resume
    changes them, the superseded version is preserved as ``settings_vN.json``
    (monotone N) so a multi-segment run stays auditable.  Identical re-saves
    (the common crash-restart case) write nothing new."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "settings.json")
    new_text = json.dumps(settings, indent=2, default=str)
    if os.path.exists(path):
        with open(path) as f:
            old_text = f.read()
        if old_text == new_text:
            return
        n = 1
        while os.path.exists(os.path.join(folder, f"settings_v{n}.json")):
            n += 1
        os.replace(path, os.path.join(folder, f"settings_v{n}.json"))
    with open(path, "w") as f:
        f.write(new_text)


def compare_settings(folder: str, settings: dict,
                     ignore=("checkpoint_dir", "num_iters", "load_from")) -> dict:
    path = os.path.join(folder, "settings.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        prev = json.load(f)
    diff = {}
    for k in set(prev) | set(settings):
        if k in ignore:
            continue
        a, b = prev.get(k), settings.get(k)
        if json.dumps(a, default=str) != json.dumps(b, default=str):
            diff[k] = (a, b)
    return diff


def save_code_snapshot(folder: str):
    """Record what code produced a run: the git revision and working-tree
    diff of the checkout that holds this package, or, outside a git
    checkout, an archive of ``alphazero_tpu_torch``.  Git looks no higher
    than the checkout's own root."""
    import subprocess
    import tarfile
    os.makedirs(folder, exist_ok=True)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ,
           "GIT_CEILING_DIRECTORIES": os.path.dirname(pkg_root)}
    try:
        rev = subprocess.run(["git", "-C", pkg_root, "rev-parse", "HEAD"],
                             capture_output=True, text=True, check=True,
                             timeout=10, env=env).stdout.strip()
        diff = subprocess.run(["git", "-C", pkg_root, "diff", "HEAD"],
                              capture_output=True, text=True, check=True,
                              timeout=30, env=env).stdout
        with open(os.path.join(folder, "code_snapshot.txt"), "w") as f:
            f.write(f"revision: {rev}\n")
            if diff:
                f.write("--- uncommitted diff ---\n")
                f.write(diff)
        return
    except Exception:
        pass
    pkg = os.path.join(pkg_root, "alphazero_tpu_torch")
    with tarfile.open(os.path.join(folder, "code_snapshot.tar.gz"),
                      "w:gz") as tar:
        tar.add(pkg, arcname="alphazero_tpu_torch",
                filter=lambda ti: None if ("__pycache__" in ti.name
                                           or "_build" in ti.name) else ti)
