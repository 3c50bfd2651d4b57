"""Multi-process data parallelism over torch.distributed (counterpart of
ntm_tracker_tpu/parallel/distributed.py).

The JAX package runs one process per host over all of its chips; the
port runs one process per GPU (`torchrun`), each process a rank of one
process group. Every rank must:

  1. join the group (initialize_distributed)                      -> here
  2. build its mesh: its own device and the group                 -> mesh.py
  3. keep its LOCAL slice of the global batch on its device; the
     global batch is implicit in the gradient sum over the group  -> mesh.py
  4. read a disjoint shard of the dataset                         -> here

Nothing falls back: NCCL that fails to start raises (it does not turn
into gloo), and a rank that dies fails the others' next collective.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """The device of this process's rank: `device` when it names an index
    or the CPU, else cuda:LOCAL_RANK (torchrun sets it), else cuda:(rank
    % the visible card count), the rank defaulting to the live group's.
    Raises when cuda is meant and absent."""
    from ntm_tracker_tpu_torch.config import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join the process group: torch.distributed.init_process_group over
    tcp://<coordinator_address> with this world size and rank.

    Call before anything touches the card. Engages only when a
    coordinator is given (--dist_coordinator) or NTM_DIST_AUTO=1 opts into
    torchrun's MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE; cluster-like
    environment variables alone are not trusted. Idempotent. Returns True
    when the group has more than one rank.

    backend=None takes nccl when the rank's device (rank_device(device):
    cuda unless the caller names the CPU) is a card, gloo on the CPU.
    backend="gloo" on a card is for two ranks on one device (NCCL refuses
    that); gloo carries CUDA tensors for all_reduce and broadcast."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = coordinator_address is not None
    if not explicit and os.environ.get("NTM_DIST_AUTO", "") != "1":
        return False  # single process: nothing to do
    if explicit:
        init_method = f"tcp://{coordinator_address}"
        world = 1 if num_processes is None else num_processes
        rank = 0 if process_id is None else process_id
    else:
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        rank = int(os.environ["RANK"]) if process_id is None else process_id
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} out of range for {world} processes")
    dev = rank_device(device, rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            # the communicator starts here, so NCCL that cannot start
            # raises now rather than at the first step
            kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kwargs)
    return dist.get_world_size() > 1


def process_shard_sequences(
    items: Sequence, process_id: Optional[int] = None,
    process_count: Optional[int] = None, allow_empty: bool = False,
) -> list:
    """Deterministic per-rank dataset shard: round-robin over disjoint
    subsets, TRUNCATED to the same length on every rank. Defaults to the
    live group (rank 0 of 1 without one).

    Equal lengths are load-bearing: every train and eval step is a
    collective, so a rank whose shard yielded one more batch would block
    forever in a collective the others never enter. len(items) % n
    trailing items are dropped (at most n-1)."""
    live = dist.is_initialized()
    pid = (dist.get_rank() if live else 0) if process_id is None else process_id
    n = (dist.get_world_size() if live else 1) if process_count is None else process_count
    if not 0 <= pid < n:
        raise ValueError(f"process_id {pid} out of range for {n} processes")
    if 0 < len(items) < n:
        if not allow_empty:
            raise ValueError(
                f"{len(items)} sequences cannot be sharded over {n} "
                f"processes: len(items)//n == 0, so EVERY host would get an "
                f"empty shard and the epoch would be a silent no-op (add "
                f"data or shrink the fleet; allow_empty=True opts into "
                f"empty shards for optional sets like validation)"
            )
        print(f"WARNING: {len(items)} sequences over {n} processes -> "
              "every host gets an EMPTY shard", file=sys.stderr)
    per = len(items) // n
    return list(items)[pid::n][:per]


def global_batch_from_local(mesh, local_batch: Any) -> list:
    """This rank's LOCAL batch [B_local, ...], split over its local devices
    (mesh.shard_batch). The name is the JAX package's, whose global array
    spans every process; here each rank keeps only its local rows on its
    devices, and the global batch is implicit in parallel_train_step's
    gradient sum over the group (the loss is a sum over rows, so the sum
    of the ranks' gradients is the global batch's gradient). No command
    calls it: train-offsets hands its local batch to parallel_train_step,
    which splits it; it stays for readers of the JAX package's API."""
    from ntm_tracker_tpu_torch.parallel.mesh import shard_batch

    return shard_batch(mesh, local_batch)
