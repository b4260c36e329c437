"""Multi-process scaling on ``torch.distributed``: port of
``alphazero_tpu/parallel/distributed.py``.

The JAX package scales by SPMD over one device mesh that
``jax.distributed`` extends across hosts.  The port uses PyTorch's idiom:
one process per device, wired into one process group (NCCL on ``cuda``,
gloo on ``cpu``; the backend follows the device the caller chose, and a
failed NCCL init raises), and a ``DeviceMesh`` over the group's ranks:

- self-play boards and training minibatches shard over the ``env`` axis:
  rank r holds the r-th contiguous block of rows, as JAX's ``P("env")``
  places contiguous blocks in device order.  "Global" means all ranks'
  rows in rank order;
- the learner is data-parallel (``train/trainer.py`` with a mesh): each
  rank takes its rows of the global minibatch, BatchNorm and the metrics
  reduce over the global batch, the gradients are all-reduced and divided
  by the world size, and Adam steps on identical gradients everywhere, so
  the parameters stay bit-identical across ranks;
- checkpoints and ``metrics.jsonl`` are written by rank 0, then
  ``sync_hosts``.

Without a process group every helper is the single-process identity, so
the same code runs in one process or many.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

log = logging.getLogger(__name__)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               local_rank: int | None = None) -> bool:
    """Wire this process into a process group.

    Arguments default to torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` (in place of JAX's
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``).  ``coordinator_address`` is ``host:port`` or an
    init-method URL (``tcp://...``, ``file://...``).  The backend is NCCL
    on ``cuda``, where this process binds ``cuda:{local_rank}``, and gloo
    on ``cpu``.  With none of them set it stays single-process.  Returns
    True when the group has more than one process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            f"distributed init needs an address, a world size and a rank; "
            f"got {coordinator_address!r}, {num_processes!r}, {process_id!r}")
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        if local_rank is None:
            local_rank = int(env.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local_rank)
        kw["device_id"] = torch.device("cuda", local_rank)
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)
    log.info("distributed: process %d/%d on %s (%s)", dist.get_rank(),
             dist.get_world_size(), dev if local_rank is None
             else f"cuda:{local_rank}", dist.get_backend())
    return dist.get_world_size() > 1


def initialized() -> bool:
    return dist.is_initialized()


def shutdown():
    """Leave the process group, when there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return rank() == 0


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_pod_mesh(axis: str = "env"):
    """Flat 1-D ``DeviceMesh`` over every rank of the process group, in
    rank order (one device per rank)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_mesh_device_type(), (world_size(),),
                            mesh_dim_names=(axis,))


def make_2d_mesh(host_axis: str = "host", env_axis: str = "env"):
    """(host, env) mesh: axis 0 spans the hosts, axis 1 the ranks of one
    host (``LOCAL_WORLD_SIZE``, all ranks when unset)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    return init_device_mesh(_mesh_device_type(), (n // n_local, n_local),
                            mesh_dim_names=(host_axis, env_axis))


def axis_group(mesh, axis="env"):
    """``(group, rank, size)`` of the mesh axis that rows shard over: one
    named axis, or a tuple of every axis of the mesh (the flattened mesh,
    whose order is the global rank order)."""
    if isinstance(axis, str):
        return mesh.get_group(axis), mesh.get_local_rank(axis), \
            mesh[axis].size()
    if tuple(axis) != tuple(mesh.mesh_dim_names):
        raise ValueError(f"axes {axis} must be all of the mesh's "
                         f"{mesh.mesh_dim_names}, in order")
    return dist.group.WORLD, dist.get_rank(), dist.get_world_size()


def rows_of(n: int, rank_: int, size: int) -> slice:
    """Rank ``rank_``'s contiguous block of ``n`` rows; ``size`` must divide
    ``n``."""
    if n % size:
        raise ValueError(f"{n} rows do not split evenly over {size} ranks")
    k = n // size
    return slice(rank_ * k, (rank_ + 1) * k)


def comm_device(group=None) -> torch.device:
    """Where a collective's tensors live: the current GPU under NCCL, the
    CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def host_local_to_global(mesh, local_batch, axis="env"):
    """Per-rank numpy batches -> the global batch (all ranks' rows in rank
    order) as numpy, on every rank.  Every rank passes its own shard, of
    equal sizes."""
    group, _, size = axis_group(mesh, axis)
    dev = comm_device(group)

    def gather(x):
        t = torch.as_tensor(np.ascontiguousarray(x)).to(dev)
        out = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(out, t, group=group)
        return torch.cat(out).cpu().numpy()
    return _tree_map(gather, local_batch)


def global_to_host_local(tree, mesh=None, axis="env"):
    """This rank's contiguous rows of each global array (the inverse of
    ``host_local_to_global``)."""
    if mesh is None:
        r, size = rank(), world_size()
    else:
        _, r, size = axis_group(mesh, axis)
    return _tree_map(lambda x: x[rows_of(x.shape[0], r, size)], tree)


def gather_objects(obj, mesh=None, axis="env") -> list:
    """Every rank's ``obj`` (any picklable value), in rank order, on every
    rank."""
    if not dist.is_initialized():
        return [obj]
    group = None if mesh is None else axis_group(mesh, axis)[0]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def replicate_from_host0(tree):
    """Broadcast rank 0's value (a tree of arrays, a checkpoint, any
    picklable value) to every rank; single-process: identity."""
    if world_size() == 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def sync_hosts(name: str = "sync"):
    """Barrier across processes (no-op single-process)."""
    if world_size() > 1:
        log.debug("sync_hosts %s", name)
        dist.barrier()


def rank_generator(seed: int, rank_: int, device="cuda") -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, rank_)``: each rank's
    own stream for the boards it plays."""
    s = int(np.random.SeedSequence([seed, rank_]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks in ``forward``; the gradient of every
    rank's input is the sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce (sum) of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)
