"""Data parallelism over a process's devices and the process group
(counterpart of ntm_tracker_tpu/parallel/mesh.py).

The model is ~1M parameters while the work grows with batch x 1300
sequential cell steps, so the scale story is pure data parallelism: the
batch axis is split, the sequence axis stays whole (its steps are
sequential). JAX annotates shardings and lets the partitioner insert the
gradient psum; here each local device runs the loss on its chunk of the
rows (the kernels see local shapes), the chunks' gradients are summed on
the process's first device, and one all_reduce(SUM) over the process
group adds the ranks' sums. The port's idiom is one process per GPU
(`torchrun`): train-offsets trains over a one-device mesh and the group.
A mesh of several local devices is what cache-features --shard and
FleetTracker(mesh=) split their work over; parallel_train_step's split
over them is reached by no command (it serves a process that drives
several devices, as the JAX package's one process does over its chips).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ntm_tracker_tpu_torch.config import resolve_device
from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's local devices (the batch is split over them) and
    the process group (None without one: a single process)."""

    devices: Tuple[torch.device, ...]
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.devices)


def local_devices(device=None) -> List[torch.device]:
    """Every visible card when `device` is cuda without an index (the
    default), else [device]."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(devices: Optional[Sequence] = None, batch_size: Optional[int] = None) -> Mesh:
    """A data-parallel mesh over `devices`: by default this rank's device
    when a process group is live (parallel/distributed.rank_device), else
    every visible card. With batch_size, trimmed to the largest device
    count that divides it (batch 1 on many devices runs on one)."""
    from ntm_tracker_tpu_torch.parallel.distributed import rank_device

    if devices is None:
        devices = [rank_device()] if dist.is_initialized() else local_devices()
    devices = [torch.device(d) for d in devices]
    if batch_size is not None:
        n = len(devices)
        while n > 1 and batch_size % n != 0:
            n -= 1
        devices = devices[:n]
    return Mesh(tuple(devices), dist.group.WORLD if dist.is_initialized() else None)


def batch_sharding(mesh: Mesh) -> Callable[[Any], List[torch.Tensor]]:
    """A placement: a tensor's leading (batch) axis split into one equal
    chunk per local device, each chunk on its device."""

    def place(x) -> List[torch.Tensor]:
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.size:
            raise ValueError(f"a leading axis of {x.shape[0]} does not split over the {mesh.size}-device mesh")
        return [c.to(d) for c, d in zip(torch.chunk(x, mesh.size), mesh.devices)]

    return place


def replicated_sharding(mesh: Mesh) -> Callable[[Any], List[torch.Tensor]]:
    """A placement: the same tensor on each local device (the JAX
    package's replicated sharding; no command calls it)."""

    def place(x) -> List[torch.Tensor]:
        x = torch.as_tensor(x)
        return [x.to(d) for d in mesh.devices]

    return place


def shard_batch(mesh: Mesh, batch: Any) -> List[Any]:
    """Every leaf of the batch split on its leading axis: one batch tree
    per local device, in mesh order."""
    placed = [batch_sharding(mesh)(x) for x in tree_leaves(batch)]
    out = []
    for i in range(mesh.size):
        parts = iter(p[i] for p in placed)
        out.append(tree_map(lambda _: next(parts), batch))
    return out


def _broadcast_from_rank0(tree: Any, group) -> Any:
    """The tree as rank 0 holds it, on every rank (one broadcast)."""
    leaves = tree_leaves(tree)
    flat = torch.cat([t.reshape(-1) for t in leaves])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    parts = iter(torch.split(flat, [t.numel() for t in leaves]))
    return tree_map(lambda t: next(parts).view_as(t).clone(), tree)


def parallel_train_step(exp, mesh: Mesh, keep_grads: bool = False) -> Callable:
    """train_step(params, opt_state, local_batch) -> (params, opt_state,
    {"loss"[, "grads"]}): one step of the experiment over the global batch.

    Each local device runs exp's loss on its chunk of the local batch (a
    copy of exp on that device, its frozen VGG replicated there); autograd
    sums the chunks' gradients on exp's device. When the mesh has a
    process group (at any world size, so one NCCL rank runs it too), one
    all_reduce(SUM) adds the ranks' gradients and losses. Then the clip and
    TF RMSProp apply once, the same update on every rank. The reduction is
    a SUM: the losses sum over rows, so the global batch's gradient is the
    sum of the ranks' (a mean would give 1/world of it, which the clip at
    max_gradient_norm hides whenever it engages). The first call
    broadcasts params and optimizer state from rank 0. keep_grads adds the
    reduced gradients before the clip under "grads"."""
    from ntm_tracker_tpu_torch.train.experiments import gradient_step

    home = exp.device
    replicas = [dataclasses.replace(exp, device=d, vgg_params=None if exp.vgg_params is None else tree_map(
        lambda t, d=d: t.to(d), exp.vgg_params)) for d in mesh.devices]

    def loss_fn(params, batch):
        total = None
        for rep, chunk in zip(replicas, shard_batch(mesh, batch)):
            loss, _ = rep.loss_fn(tree_map(lambda p: p.to(rep.device), params), chunk)
            total = loss.to(home) if total is None else total + loss.to(home)
        return total, {}

    def all_reduce(grads: list, loss: torch.Tensor):
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        parts = torch.split(flat, [g.numel() for g in grads] + [1])
        return [p.view_as(g) for p, g in zip(parts, grads)], parts[-1].reshape(())

    step = gradient_step(loss_fn, exp.optimizer(), reduce=None if mesh.group is None else all_reduce,
                         keep_grads=keep_grads)
    started = []

    def train_step(params, opt_state, batch):
        if mesh.group is not None and not started:
            params, opt_state = _broadcast_from_rank0((params, opt_state), mesh.group)
            started.append(True)
        return step(params, opt_state, batch)

    return train_step
