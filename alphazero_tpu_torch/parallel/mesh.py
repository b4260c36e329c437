"""Data-parallel sharding for self-play and learning: port of
``alphazero_tpu/parallel/mesh.py`` on ``torch.distributed``.

A mesh is a ``DeviceMesh`` over the process group's ranks, one device per
rank, with the logical axis

    'env'  - self-play environments / replay batch (data parallel)

Self-play boards, their search trees and training minibatches shard over
'env' (rank r holds the r-th contiguous block of rows); parameters are
replicated.  Where GSPMD inserts the gradient psum for the JAX package,
the port's train step all-reduces the gradients itself
(``train/trainer.py``).  Several hosts extend the same mesh through the
process group (``parallel/distributed.py``) without code changes here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..games.splendor import env as E
from ..models import splendor_net as N
from ..train import trainer as TR
from . import distributed as D


def make_mesh(n_devices: int | None = None, axis: str = "env"):
    """A 1-D mesh over every rank of the process group (``n_devices``, when
    given, must be the world size: one device per rank)."""
    if n_devices is not None and n_devices != D.world_size():
        raise ValueError(f"a mesh of {n_devices} devices needs a process "
                         f"group of {n_devices} ranks, not {D.world_size()}")
    return D.make_pod_mesh(axis)


def shard_batch(mesh, batch, axis: str = "env"):
    """This rank's contiguous rows of each array of a global ``batch``."""
    return D.global_to_host_local(batch, mesh, axis)


def replicate(mesh, net: torch.nn.Module, axis: str = "env"):
    """Rank 0's parameters and buffers on every rank of the mesh axis,
    written into ``net`` in place; returns ``net``."""
    group, _, size = D.axis_group(mesh, axis)
    if size > 1:
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in net.state_dict().values():
                dist.broadcast(t, src=src, group=group)
    return net


def make_sharded_train_step(env_cfg: E.SplendorConfig, net_cfg: N.NetConfig,
                            train_cfg: TR.TrainConfig, mesh,
                            axis: str = "env"):
    """The full training step over the mesh: every rank passes the global
    batch and keeps its rows, replicated params, gradients all-reduced
    (``trainer.make_train_step`` with the mesh)."""
    return TR.make_train_step(env_cfg, net_cfg, train_cfg, mesh, axis)


def make_sharded_selfplay_step(env_cfg: E.SplendorConfig, mesh,
                               axis: str = "env"):
    """One env-sharded vectorized step on this rank's rows (``shard_batch``
    of the global boards, actions and chance uniforms); returns this rank's
    rows of ``(states', next_player)``."""
    def step_batch(states, actions, uniforms):
        return E.step(env_cfg, states, actions, 0, uniforms, False)
    return step_batch


def make_sharded_valid_fn(env_cfg: E.SplendorConfig, mesh,
                          axis: str = "env"):
    """The valid moves of this rank's rows."""
    return lambda states: E.valid_moves(env_cfg, states, 0)
