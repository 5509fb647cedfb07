"""Multi-process scale-out entry points (counterpart of
``scann_tpu/parallel/multihost.py``), on ``torch.distributed``.

Every process runs the same program, joins one process group and builds
the same global mesh (:func:`global_mesh`); each process places and
searches only its own shards, and the sharded searchers' per-shard partials
cross the processes in their merge (:func:`~scann_tpu_torch.parallel.mesh.
gather_columns`, ``all_gather``) — database rows never move. Nothing tells
a process of a cluster: the caller gives the coordinator's address, the
process count and this process's index.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.parallel.mesh import Mesh
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


def _dist():
    import torch.distributed as dist

    return dist


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: Union[str, torch.device] = DEFAULT_DEVICE
                         ) -> int:
    """Join (or create) the default process group; returns this process's
    index. A second call returns the index of the group already joined.

    ``coordinator_address`` is ``host:port`` of process 0 (a TCP
    rendezvous); with none, ``torch.distributed``'s environment variables
    are read. The backend follows ``device``: NCCL for the card (the
    default), gloo for the CPU."""
    dist = _dist()
    if dist.is_initialized():
        return dist.get_rank()
    device = require_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    try:
        dist.init_process_group(
            backend, init_method=init,
            world_size=-1 if num_processes is None else int(num_processes),
            rank=-1 if process_id is None else int(process_id))
    except (RuntimeError, ValueError) as e:
        raise ScannError.internal(
            f"torch.distributed init failed: {e}") from e
    return dist.get_rank()


def _world() -> tuple:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(axis_names=("db",), devices_per_axis=None,
                local_devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over every process's devices (call after
    :func:`initialize_multihost`), in process order.

    ``local_devices``: this process's devices, which may repeat one
    (default: its visible CUDA devices). Every process must bring the same
    number."""
    if local_devices is None:
        require_device("cuda")
        local_devices = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in local_devices]
    world, rank = _world()
    names = [str(d) for d in local]
    if world > 1:
        gathered = [None] * world
        _dist().all_gather_object(gathered, names)
    else:
        gathered = [names]
    if len({len(g) for g in gathered}) != 1:
        raise ScannError.invalid_argument(
            f"every process must bring the same number of devices, got "
            f"{[len(g) for g in gathered]}")
    devs, pids = [], []
    for p, g in enumerate(gathered):
        devs += local if p == rank else [torch.device(s) for s in g]
        pids += [p] * len(g)
    n = len(devs)
    shape = devices_per_axis
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(shape)) != n:
        raise ScannError.invalid_argument(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names,
                process_ids=np.asarray(pids).reshape(shape),
                process_index=rank, distributed=_dist().is_initialized())


def process_local_rows(n_total: int) -> tuple:
    """[lo, hi) row range this process should load for a db-sharded index —
    a process only materializes its own database shard (beyond-RAM
    datasets)."""
    p, i = _world()
    per = -(-n_total // p)
    lo = min(i * per, n_total)
    return lo, min(lo + per, n_total)
