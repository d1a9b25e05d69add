"""Multi-process initialization and per-process data feeding (port of
``highlyaccurate_tpu/train/distributed.py:16-75``).

The JAX package runs one SPMD program over a 1-D ``data`` mesh.  The port
takes PyTorch's own idiom: one process per card, started by ``torchrun``
(or by hand with the same environment), joined by ``torch.distributed``
over NCCL for ``cuda`` and gloo for ``cpu``.  Every process holds the whole
model; each takes its rows of every global batch, and the train step
averages the gradients over the processes before Adam (``train/step.py``).
With one process nothing here does anything: no group is made and no
collective runs.

    torchrun --nproc_per_node 4 -m highlyaccurate_tpu_torch.cli.train_kitti \\
        --test 0 --batch_size 32 ...
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def world_size() -> int:
    """Processes of the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device=None) -> torch.device:
    """This process's device: ``cpu`` when asked for, else the card of its
    local rank (``LOCAL_RANK``, 0 by default), made the current one."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(dev)
    return dev


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """Join the process group (a no-op for a single process or an existing
    group).

    Without arguments the torchrun environment gives them (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); else
    ``coordinator_address`` is "host:port" of rank 0.  The backend is NCCL
    unless ``device`` is ``cpu`` (gloo).  A failed initialization raises.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    cpu = device is not None and torch.device(device).type == "cpu"
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init,
                            world_size=num_processes, rank=process_id)


def global_batch_from_host_shards(mesh, host_batch: dict) -> dict:
    """This process's shard of the global batch on its device.

    Each process loads ``global_batch_size / world`` samples (its rows,
    ``local_batch_slice``); where JAX stitches the hosts' shards into one
    global array sharded along ``data``, here every array stays this
    process's shard, placed on the mesh's first local device, and the
    mesh's steps treat it as rows ``rank * n ... (rank + 1) * n - 1`` of
    the global batch.  Entries that are not numpy arrays pass through."""
    from highlyaccurate_tpu_torch.train.step import to_device
    dev = mesh.devices[0]
    return {k: to_device(v, dev) if isinstance(v, np.ndarray) else v
            for k, v in host_batch.items()}


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (a no-op for one
    process).  Needed between a checkpoint save (rank 0 writes) and a
    read of the same path on any other process."""
    del name  # torch.distributed barriers are unnamed
    if world_size() > 1:
        dist.barrier()


def local_batch_slice(global_batch_size: int) -> int:
    """Per-process batch size for the current process."""
    n = world_size()
    assert global_batch_size % n == 0, \
        f"global batch {global_batch_size} not divisible by {n} processes"
    return global_batch_size // n
