"""Device meshes and row sharding (counterpart of
``scann_tpu/parallel/mesh.py``).

A :class:`Mesh` is a numpy object array of ``torch.device`` with named axes,
as JAX's ``Mesh`` is of JAX devices. A row-sharded array is a list of
per-shard tensors, each on its shard's device (:class:`ShardedRows`); a
replicated one is one tensor per distinct device (:func:`replicate`). The
per-shard work of the sharded searchers is plain PyTorch on one shard's
tensors; what JAX's ``shard_map`` collectives do becomes
:func:`gather_columns` (``all_gather`` of per-shard partials) and
:func:`sum_shards` (``psum``), on ``torch.distributed`` for a mesh over
processes (:mod:`scann_tpu_torch.parallel.multihost`).

A mesh may name one device several times: ``make_mesh(devices=[cpu] * 8)``
is the counterpart of the JAX package's 8 virtual CPU devices, and
``make_mesh(devices=[cuda:0] * 4)`` serves 4 shards on one card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.types import require_device


class Mesh:
    """Devices in a grid with named axes.

    ``devices`` is an object array of ``torch.device`` whose shape is the
    mesh's; ``shape[axis]`` is an axis's length and ``devices.size`` the
    device count, as on a JAX mesh. A mesh over several processes
    (:func:`~scann_tpu_torch.parallel.multihost.global_mesh`) also holds each
    position's process in ``process_ids``; a process then owns, places and
    computes only the positions of ``process_index``, and the mesh's
    collectives run on ``torch.distributed`` (``distributed``; at a world
    size of 1 too)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_ids: Optional[np.ndarray] = None,
                 process_index: int = 0, distributed: bool = False):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ScannError.invalid_argument(
                f"mesh of shape {self.devices.shape} needs "
                f"{self.devices.ndim} axis names, got {self.axis_names}")
        if process_ids is None:
            process_ids = np.zeros(self.devices.shape, np.int64)
        self.process_ids = np.asarray(process_ids, np.int64).reshape(
            self.devices.shape)
        self.process_index = int(process_index)
        self.distributed = bool(distributed)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def multiprocess(self) -> bool:
        """True when the mesh spans more than one process."""
        return bool((self.process_ids != self.process_index).any())

    def _axis_line(self, arr: np.ndarray, axis: str) -> list:
        """Entries of ``arr`` along ``axis``, index 0 on the other axes."""
        a = self.axis_names.index(axis)
        idx = [0] * arr.ndim
        out = []
        for i in range(arr.shape[a]):
            idx[a] = i
            out.append(arr[tuple(idx)])
        return out

    def axis_devices(self, axis: str = "db") -> List[torch.device]:
        """Device of each position along ``axis`` (the shards' homes)."""
        return self._axis_line(self.devices, axis)

    def axis_local(self, axis: str = "db") -> List[bool]:
        """Whether this process owns each position along ``axis``."""
        return [int(p) == self.process_index
                for p in self._axis_line(self.process_ids, axis)]

    def home(self, axis: str = "db") -> torch.device:
        """The first local device along ``axis``: where partials merge."""
        for dev, mine in zip(self.axis_devices(axis), self.axis_local(axis)):
            if mine:
                return dev
        raise ScannError.failed_precondition(
            "this process owns no position of the mesh")

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices.ravel()]})")


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("db",),
              shape: Optional[Tuple[int, ...]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a device mesh.

    Args:
        n_devices: devices to use (default: all of them).
        axis_names: mesh axis names, e.g. ("db",) for database sharding or
            ("q", "db") for query-batch x database 2-D meshes.
        shape: explicit mesh shape; defaults to putting all devices on the
            last axis.
        devices: an explicit device list, which may name a device more than
            once (``[torch.device("cpu")] * 8`` stands in for the JAX
            package's 8 virtual CPU devices, ``[cuda:0] * 4`` puts 4 shards
            on one card). Default: the visible CUDA devices; with none
            visible this raises, as every entry point of the port does.
    """
    if devices is None:
        require_device("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ScannError.invalid_argument(
            f"requested {n} devices, only {len(devs)} available")
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(shape)) != n:
        raise ScannError.invalid_argument(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(shape), axis_names)


class ShardedRows(list):
    """A row-sharded array: per-shard tensors in mesh order along the
    sharded axis, ``None`` for the shards another process holds.
    ``row0[i]`` is shard i's first global row and ``valid[i]`` its real
    (unpadded) row count; every shard has ``blk`` rows."""

    def __init__(self, shards, row0: Sequence[int], valid: Sequence[int],
                 blk: int):
        super().__init__(shards)
        self.row0 = [int(r) for r in row0]
        self.valid = [int(v) for v in valid]
        self.blk = int(blk)


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr))


def shard_rows(mesh: Mesh, arr, axis: str = "db",
               process_local: bool = False) -> Tuple[ShardedRows, int]:
    """(shards, n): ``arr``'s leading dim split into ``mesh.shape[axis]``
    equal blocks (rows padded with zeros to a multiple of it), each moved to
    its position's device. Pass host (numpy) arrays for large data: each
    block is padded and moved on its own, so no device ever holds the whole
    array.

    In a mesh over several processes each process places only its own
    shards. ``process_local=True`` says ``arr`` holds only this process's
    rows, the range :func:`~scann_tpu_torch.parallel.multihost.
    process_local_rows` gives it (the counterpart of JAX's
    ``make_array_from_process_local_data``): its rows split over its own
    shards and ``n`` is the sum over the processes."""
    size = mesh.shape[axis]
    devs = mesh.axis_devices(axis)
    local = mesh.axis_local(axis)
    if not process_local:
        n = int(arr.shape[0])
        blk = max(-(-n // size), 1)
        row0 = [i * blk for i in range(size)]
        lo_of = row0
    else:
        from scann_tpu_torch.parallel.multihost import process_local_rows

        n_here = torch.tensor([int(arr.shape[0])], dtype=torch.int64)
        n = int(sum_shards(mesh, [n_here.to(mesh.home(axis))], axis)[0])
        lo, _ = process_local_rows(n)
        n_local = sum(local)
        per = -(-n // max(_process_count(mesh), 1))
        blk = max(-(-per // n_local), 1)
        row0, lo_of, j = [], [], 0
        for i in range(size):
            row0.append(lo + j * blk if local[i] else -1)
            lo_of.append(j * blk if local[i] else -1)
            j += int(local[i])
    n_rows = int(arr.shape[0])
    shards, valid = [], []
    for i in range(size):
        if not local[i]:
            shards.append(None)
            valid.append(0)
            continue
        lo = lo_of[i]
        hi = min(lo + blk, n_rows)
        part = _as_tensor(arr[lo:hi] if hi > lo else arr[:0])
        if part.shape[0] < blk:
            pad = part.new_zeros((blk - part.shape[0],) + tuple(part.shape[1:]))
            part = torch.cat([part, pad])
        shards.append(part.to(devs[i]))
        valid.append(max(hi - lo, 0))
    return ShardedRows(shards, row0, valid, blk), n


def replicate(mesh: Mesh, arr) -> Dict[torch.device, torch.Tensor]:
    """``arr`` on every local device of the mesh: one tensor a distinct
    device (shards on the same device share it)."""
    t = _as_tensor(arr)
    out: Dict[torch.device, torch.Tensor] = {}
    for dev, pid in zip(mesh.devices.ravel(), mesh.process_ids.ravel()):
        if int(pid) == mesh.process_index and dev not in out:
            out[dev] = t.to(dev)
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _process_count(mesh: Mesh) -> int:
    return len(np.unique(mesh.process_ids))


def gather_columns(mesh: Mesh, parts: Sequence[Optional[torch.Tensor]],
                   axis: str = "db") -> torch.Tensor:
    """[..., sum of widths] concatenation, in mesh order, of the per-shard
    partials (``None`` for another process's shards) on the mesh's home
    device: JAX's tiled ``all_gather`` over ``axis``. On a distributed mesh
    each process contributes its own shards' columns
    (``torch.distributed.all_gather``, equal widths on every process), in
    process order, which is mesh order."""
    home = mesh.home(axis)
    mine = torch.cat([p.to(home) for p in parts if p is not None], dim=-1)
    if not mesh.distributed:
        return mine
    import torch.distributed as dist

    mine = mine.contiguous()
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return torch.cat(out, dim=-1)


def sum_shards(mesh: Mesh, parts: Sequence[Optional[torch.Tensor]],
               axis: str = "db") -> torch.Tensor:
    """Sum of the per-shard tensors on the mesh's home device: JAX's
    ``psum`` over ``axis`` (``all_reduce`` on a distributed mesh)."""
    home = mesh.home(axis)
    total = None
    for p in parts:
        if p is not None:
            total = p.to(home) if total is None else total + p.to(home)
    if mesh.distributed:
        import torch.distributed as dist

        total = total.contiguous()
        dist.all_reduce(total)
    return total
