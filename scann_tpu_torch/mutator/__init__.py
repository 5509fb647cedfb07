"""Dynamic index mutations (counterpart of ``scann_tpu/mutator/__init__.py``).

Mutable state lives on the host, in the C++ core of ``native_host`` or a
pure-Python core with the same semantics; searches run on snapshots held
on the device:

  - ``MutationBuffer``: a bounded concurrent mutation queue.
  - ``MutableDataset``: concurrent add / update / remove over an
    append-only slab with a deleted bitset; ``snapshot()`` hands
    (rows, deleted) to the device upload.
  - ``IncrementalUpdater``: an atomic index swap and a rebuild threshold.
  - ``DynamicSearcher``: the serving wrapper. A main index built from the
    last snapshot, plus an exact search over the rows added or updated
    since; removed rows are masked out of both, and a rebuild folds the
    delta in once it passes the threshold.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
import inspect
import threading
import warnings
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.native_host import load_native
from scann_tpu_torch.ops.distances import (
    DistanceMeasure,
    gathered_distances,
    many_to_many,
)
from scann_tpu_torch.ops.topk import top_k_smallest
from scann_tpu_torch.types import DEFAULT_DEVICE, MASKED_DISTANCE, require_device

_FP = ctypes.POINTER(ctypes.c_float)


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(_FP)


class MutationKind(enum.IntEnum):
    ADD = 0
    REMOVE = 1
    UPDATE = 2


@dataclasses.dataclass
class Mutation:
    """One mutation: its kind, the row index, the row's new data (adds
    and updates) and the buffer's timestamp."""

    kind: MutationKind
    index: int
    data: Optional[np.ndarray] = None
    timestamp: int = 0

    @classmethod
    def add(cls, index: int, data, timestamp: int = 0) -> "Mutation":
        return cls(MutationKind.ADD, index, np.asarray(data, np.float32),
                   timestamp)

    @classmethod
    def remove(cls, index: int, timestamp: int = 0) -> "Mutation":
        return cls(MutationKind.REMOVE, index, None, timestamp)

    @classmethod
    def update(cls, index: int, data, timestamp: int = 0) -> "Mutation":
        return cls(MutationKind.UPDATE, index, np.asarray(data, np.float32),
                   timestamp)


class MutationBuffer:
    """Bounded concurrent mutation queue; in the C++ core when it loads."""

    def __init__(self, max_buffer_size: int = 1024, dim: int = 0):
        self.max_buffer_size = int(max_buffer_size)
        self._dim = int(dim)
        self._lib = load_native()
        if self._lib is not None:
            self._h = self._lib.mbuf_create(self.max_buffer_size)
        else:
            self._h = None
            self._q: List[Mutation] = []
            self._lock = threading.Lock()
            self._ts = 0

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.mbuf_destroy(self._h)
            self._h = None

    def push(self, m: Mutation) -> bool:
        """Queue ``m``; False when the buffer is full."""
        if self._lib is not None:
            data_ptr = None
            dim = 0
            if m.data is not None:
                arr = np.ascontiguousarray(m.data, dtype=np.float32)
                data_ptr = _fptr(arr)
                dim = arr.size
                # flush() sizes its rows from self._dim: learn it from the
                # payloads, so a dim=0 buffer still returns its vectors
                if dim > self._dim:
                    self._dim = int(dim)
            return self._lib.mbuf_push(self._h, int(m.kind), m.index,
                                       data_ptr, dim) == 0
        with self._lock:
            if len(self._q) >= self.max_buffer_size:
                return False
            m.timestamp = self._ts
            self._ts += 1
            self._q.append(m)
            return True

    def add(self, index: int, data) -> bool:
        return self.push(Mutation.add(index, data))

    def remove(self, index: int) -> bool:
        return self.push(Mutation.remove(index))

    def update(self, index: int, data) -> bool:
        return self.push(Mutation.update(index, data))

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.mbuf_len(self._h))
        with self._lock:
            return len(self._q)

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    def should_flush(self) -> bool:
        return len(self) >= self.max_buffer_size

    def flush(self, dim: Optional[int] = None) -> List[Mutation]:
        """Drain every queued mutation, in order."""
        if self._lib is not None:
            dim = dim if dim is not None else self._dim
            out = []
            kind = ctypes.c_int32()
            idx = ctypes.c_uint64()
            ts = ctypes.c_uint64()
            buf = np.zeros(max(dim, 1), dtype=np.float32)
            ptr = _fptr(buf)
            while True:
                buf[:] = 0.0  # an entry may carry fewer floats than dim
                if self._lib.mbuf_pop(self._h, ctypes.byref(kind),
                                      ctypes.byref(idx), ctypes.byref(ts),
                                      ptr, dim) != 0:
                    break
                k = MutationKind(kind.value)
                data = buf[:dim].copy() if k != MutationKind.REMOVE else None
                out.append(Mutation(k, idx.value, data, ts.value))
            return out
        with self._lock:
            out, self._q = self._q, []
            return out


class _PyDatasetCore:
    """Pure-Python core with the C++ core's semantics."""

    def __init__(self, dim: int, capacity: int = 64):
        self.dim = dim
        self._lock = threading.RLock()
        self._data = np.zeros((capacity, dim), dtype=np.float32)
        self._deleted = np.zeros(capacity, dtype=np.uint8)
        self._rows = 0
        self._live = 0

    def _reserve(self, rows: int) -> None:
        cap = len(self._data)
        if rows <= cap:
            return
        while cap < rows:
            cap *= 2
        data = np.zeros((cap, self.dim), dtype=np.float32)
        deleted = np.zeros(cap, dtype=np.uint8)
        data[:self._rows] = self._data[:self._rows]
        deleted[:self._rows] = self._deleted[:self._rows]
        self._data, self._deleted = data, deleted

    def add(self, v: np.ndarray) -> int:
        with self._lock:
            self._reserve(self._rows + 1)
            self._data[self._rows] = v
            self._deleted[self._rows] = 0
            self._rows += 1
            self._live += 1
            return self._rows - 1

    def add_many(self, rows: np.ndarray) -> int:
        """Append ``rows`` [n, dim] in order; the first one's index."""
        with self._lock:
            first, n = self._rows, len(rows)
            self._reserve(first + n)
            self._data[first:first + n] = rows
            self._deleted[first:first + n] = 0
            self._rows += n
            self._live += n
            return first

    def remove(self, i: int) -> bool:
        with self._lock:
            if 0 <= i < self._rows and not self._deleted[i]:
                self._deleted[i] = 1
                self._live -= 1
                return True
            return False

    def update(self, i: int, v: np.ndarray) -> bool:
        with self._lock:
            if 0 <= i < self._rows and not self._deleted[i]:
                self._data[i] = v
                return True
            return False

    def get(self, i: int) -> Optional[np.ndarray]:
        with self._lock:
            if 0 <= i < self._rows and not self._deleted[i]:
                return self._data[i].copy()
            return None

    def exists(self, i: int) -> bool:
        with self._lock:
            return 0 <= i < self._rows and not self._deleted[i]

    def size(self) -> int:
        with self._lock:
            return self._live

    def rows(self) -> int:
        with self._lock:
            return self._rows

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            return (self._data[:self._rows].copy(),
                    self._deleted[:self._rows].copy())

    def compact(self) -> int:
        with self._lock:
            keep = self._deleted[:self._rows] == 0
            kept = self._data[:self._rows][keep]
            self._data[:len(kept)] = kept
            self._deleted[:self._rows] = 0
            self._rows = len(kept)
            self._live = len(kept)
            return self._rows


class _NativeDatasetCore:
    """ctypes wrapper over the C++ core's dataset."""

    def __init__(self, lib, dim: int, capacity: int = 64):
        self._lib = lib
        self.dim = dim
        self._h = lib.mds_create(dim, capacity)
        if not self._h:
            raise MemoryError("the host core could not allocate its slab")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mds_destroy(self._h)
            self._h = None

    def add(self, v: np.ndarray) -> int:
        arr = np.ascontiguousarray(v, dtype=np.float32)
        return int(self._lib.mds_add(self._h, _fptr(arr)))

    def add_many(self, rows: np.ndarray) -> int:
        """Append ``rows`` [n, dim] in order, in one call; the first one's
        index."""
        arr = np.ascontiguousarray(rows, dtype=np.float32)
        first = int(self._lib.mds_add_many(self._h, _fptr(arr), len(arr)))
        if first < 0:
            raise MemoryError(f"the host core could not grow by {len(arr)} "
                              f"rows")
        return first

    def remove(self, i: int) -> bool:
        return self._lib.mds_remove(self._h, i) == 0

    def update(self, i: int, v: np.ndarray) -> bool:
        arr = np.ascontiguousarray(v, dtype=np.float32)
        return self._lib.mds_update(self._h, i, _fptr(arr)) == 0

    def get(self, i: int) -> Optional[np.ndarray]:
        out = np.zeros(self.dim, dtype=np.float32)
        if self._lib.mds_get(self._h, i, _fptr(out)) == 0:
            return out
        return None

    def exists(self, i: int) -> bool:
        return bool(self._lib.mds_exists(self._h, i))

    def size(self) -> int:
        return int(self._lib.mds_size(self._h))

    def rows(self) -> int:
        return int(self._lib.mds_rows(self._h))

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        r = self.rows()
        data = np.zeros((max(r, 1), self.dim), dtype=np.float32)
        deleted = np.zeros(max(r, 1), dtype=np.uint8)
        got = self._lib.mds_snapshot(
            self._h, _fptr(data),
            deleted.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), r)
        return data[:got], deleted[:got]

    def compact(self) -> int:
        return int(self._lib.mds_compact(self._h))


class MutableDataset:
    """Concurrent mutable dataset. ``native`` says which core holds it:
    True for the C++ core, False for the pure-Python one (``use_native``
    off, or the C++ core could not be built)."""

    def __init__(self, dimensionality: int, use_native: bool = True):
        self.dim = int(dimensionality)
        lib = load_native() if use_native else None
        if lib is not None:
            self._core = _NativeDatasetCore(lib, self.dim)
            self.native = True
        else:
            self._core = _PyDatasetCore(self.dim)
            self.native = False
        self._mutations = MutationBuffer(1 << 20, dim=self.dim)
        # True once the bounded buffer rejected a push: the delta log is no
        # longer a complete record and incremental consumers must resync
        # from snapshot() (flush_mutations resets the flag)
        self.mutation_log_overflowed = False

    @classmethod
    def from_dataset(cls, dataset: DenseDataset,
                     use_native: bool = True) -> "MutableDataset":
        """The dataset's rows as rows 0..N-1, unlogged. One bulk append:
        the same state as adding the rows one at a time."""
        m = cls(dataset.dimensionality, use_native)
        m._core.add_many(dataset.numpy())
        return m

    def _log(self, m: Mutation) -> None:
        """Record a mutation in the bounded delta log; on overflow, flag
        (and warn once) rather than drop it silently: the core holds the
        change, only incremental replay loses completeness."""
        if not self._mutations.push(m) and not self.mutation_log_overflowed:
            self.mutation_log_overflowed = True
            warnings.warn(
                "MutableDataset mutation log overflowed; incremental "
                "consumers must resync from snapshot() (the dataset "
                "itself is unaffected)", RuntimeWarning, stacklevel=3)

    def add(self, data) -> int:
        v = np.asarray(data, dtype=np.float32)
        if v.shape != (self.dim,):
            raise ScannError.invalid_argument(
                f"point shape {v.shape} != ({self.dim},)")
        idx = self._core.add(v)
        self._log(Mutation.add(idx, v))
        return idx

    def remove(self, index: int) -> None:
        if not self._core.remove(index):
            raise ScannError.not_found(
                f"index {index} not found or already removed")
        self._log(Mutation.remove(index))

    def update(self, index: int, data) -> None:
        v = np.asarray(data, dtype=np.float32)
        if v.shape != (self.dim,):
            raise ScannError.invalid_argument(
                f"point shape {v.shape} != ({self.dim},)")
        if not self._core.update(index, v):
            raise ScannError.not_found(f"index {index} not found")
        self._log(Mutation.update(index, v))

    def get(self, index: int) -> Optional[np.ndarray]:
        return self._core.get(index)

    get_fast = get

    def get_batch(self, indices) -> List[Optional[np.ndarray]]:
        return [self._core.get(int(i)) for i in indices]

    def exists(self, index: int) -> bool:
        return self._core.exists(index)

    @property
    def size(self) -> int:
        """Live rows."""
        return self._core.size()

    @property
    def total_rows(self) -> int:
        """Rows ever added since the last compact, removed ones included."""
        return self._core.rows()

    @property
    def dimensionality(self) -> int:
        return self.dim

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows [R, D] float32, deleted [R] uint8), a copy for the device
        upload."""
        return self._core.snapshot()

    def flush_mutations(self) -> List[Mutation]:
        out = self._mutations.flush(self.dim)
        self.mutation_log_overflowed = False
        return out

    def compact(self) -> int:
        # drain through flush_mutations so a prior log overflow clears:
        # compaction starts a fresh delta epoch
        self.flush_mutations()
        return self._core.compact()

    def to_dense_dataset(self) -> DenseDataset:
        data, deleted = self.snapshot()
        return DenseDataset(data[deleted == 0])


class IncrementalUpdater:
    """Atomic index swap and a rebuild threshold."""

    def __init__(self, index, rebuild_threshold: int = 1000):
        self._index = index
        self._lock = threading.Lock()
        self.rebuild_threshold = int(rebuild_threshold)
        self._pending: List[Mutation] = []

    def load_index(self):
        with self._lock:
            return self._index

    def store_index(self, new_index) -> None:
        with self._lock:
            self._index = new_index

    def queue_mutation(self, m: Mutation) -> None:
        with self._lock:
            self._pending.append(m)

    def needs_rebuild(self) -> bool:
        with self._lock:
            return len(self._pending) >= self.rebuild_threshold

    def get_pending_mutations(self) -> List[Mutation]:
        with self._lock:
            return list(self._pending)

    def reset_rebuild_counter(self) -> None:
        with self._lock:
            self._pending.clear()


# bytes of one [B, chunk, D] float32 difference block of the delta scoring
DELTA_CHUNK_BYTES = 256 << 20


def _delta_distances(measure: DistanceMeasure, queries: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """[B, E] exact distances from the queries to the delta rows. L2 and
    squared L2 take the difference form: the product-plus-norms form
    cancels for near-duplicate rows, the delta's common case (an update
    followed by a search for it). Rows go in chunks that keep one
    [B, chunk, D] block under ``DELTA_CHUNK_BYTES``."""
    if measure not in (DistanceMeasure.SQUARED_L2, DistanceMeasure.L2):
        return many_to_many(measure, queries, rows)
    b, d = queries.shape
    step = max(1, DELTA_CHUNK_BYTES // max(1, 4 * b * d))
    out = torch.empty(b, rows.shape[0], dtype=torch.float32,
                      device=queries.device)
    for lo in range(0, rows.shape[0], step):
        diff = queries[:, None, :] - rows[None, lo:lo + step, :]
        out[:, lo:lo + step] = (diff * diff).sum(-1)
    return out.sqrt() if measure == DistanceMeasure.L2 else out


def dynamic_merge(queries: torch.Tensor, snap_db: torch.Tensor,
                  cand_ids: torch.Tensor, extra_rows: torch.Tensor,
                  extra_ids: torch.Tensor, extra_valid: torch.Tensor,
                  eps: float, *, k: int, measure: DistanceMeasure
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dynamic search's merge, on the device that holds the tensors:
    exact distances to the main index's candidates (their rows gathered
    from the resident snapshot ``snap_db`` [R, D]; ``cand_ids`` [B, F],
    -1 where invalid), exact distances to the delta slab ``extra_rows``
    [E, D] (ids ``extra_ids`` [E], ``extra_valid`` [E] bool), a candidate
    that is also in the slab keeps only the slab's current copy, then the
    k smallest. Returns (distances [B, k], ids [B, k]); (inf, -1) where a
    slot is masked or above ``eps``."""
    n_snap = snap_db.shape[0]
    # rows updated since the build are in the slab and masked here as
    # duplicates, so the snapshot's stale copy never survives
    cand_rows = snap_db[cand_ids.clamp(0, max(n_snap - 1, 0))]
    cd = gathered_distances(measure, queries, cand_rows)
    # ids are >= -1, so -2 stands for an invalid slab row (no host sync)
    dup = torch.isin(cand_ids, torch.where(extra_valid, extra_ids, -2))
    cd = torch.where((cand_ids >= 0) & ~dup, cd, float(MASKED_DISTANCE))
    ed = _delta_distances(measure, queries, extra_rows)
    ed = torch.where(extra_valid[None, :], ed, float(MASKED_DISTANCE))
    all_d = torch.cat([cd, ed], dim=1)
    all_i = torch.cat([cand_ids, extra_ids[None, :].expand(
        queries.shape[0], -1)], dim=1)
    vals, pos = top_k_smallest(all_d, k)
    idx = torch.gather(all_i, 1, pos)
    # one exact stage: the tighter of the pre / post epsilons applies
    missing = (vals >= MASKED_DISTANCE / 2) | (vals > eps)
    return (torch.where(missing, float("inf"), vals),
            torch.where(missing, -1, idx))


class DynamicSearcher:
    """Serving wrapper: a main index over the last snapshot plus an exact
    delta.

    ``searcher_factory(DenseDataset) -> Searcher`` builds the main index.
    Rows added since the last rebuild, and rows updated since, are searched
    exactly (the delta slab, cached on ``device`` between mutations);
    removes mask rows out of both. The snapshot's rows stay on ``device``
    between rebuilds. A rebuild folds the delta in; it runs once the
    mutations since the last one reach ``rebuild_threshold``. Distances
    are in ``distance_measure``, or else the main index's own
    (``distance_measure`` or ``_measure``), or else squared L2.
    """

    def __init__(self, dataset: DenseDataset,
                 searcher_factory: Callable[[DenseDataset], object],
                 rebuild_threshold: int = 1000,
                 distance_measure: Optional[DistanceMeasure] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.device = require_device(device)
        self._factory = searcher_factory
        self._mutable = MutableDataset.from_dataset(dataset)
        self.rebuild_threshold = int(rebuild_threshold)
        self._distance_measure = distance_measure
        self._lock = threading.Lock()
        self._rebuild()

    def _rebuild(self):
        data, deleted = self._mutable.snapshot()
        self._snapshot_rows = len(data)
        self._snapshot_ds = DenseDataset(data)
        self._main = self._factory(self._snapshot_ds)
        self._main_takes_mask = "allow_mask" in inspect.signature(
            self._main.search_batched_arrays).parameters
        self._mutable.flush_mutations()
        # rows updated since the build: the main index ranks them by their
        # stale snapshot vector, so they are rescored from the delta slab
        self._updated_since_build = set()
        # candidates to drop: rows deleted at the build (the factory indexed
        # their stale vectors) and snapshot rows removed since
        self._cand_invalid = deleted.astype(bool)
        self._extra_cache = None

    def add(self, data) -> int:
        with self._lock:
            idx = self._mutable.add(data)
            self._extra_cache = None
            self._maybe_rebuild()
            return idx

    def remove(self, index: int) -> None:
        with self._lock:
            self._mutable.remove(index)
            if index < self._snapshot_rows:
                self._cand_invalid[index] = True
            self._extra_cache = None
            self._maybe_rebuild()

    def update(self, index: int, data) -> None:
        with self._lock:
            self._mutable.update(index, data)
            if index < self._snapshot_rows:
                self._updated_since_build.add(int(index))
            self._extra_cache = None
            self._maybe_rebuild()

    def _extra_slab(self, d: int):
        """The delta slab on the device (rows added since the build, then
        rows updated since, ascending), cached between mutations:
        (rows [E, D], ids [E], valid [E] on the device, ids and valid on
        the host). A row removed since comes back invalid."""
        if self._extra_cache is None:
            extra_ids = np.concatenate([
                np.arange(self._snapshot_rows, self._mutable.total_rows,
                          dtype=np.int64),
                np.fromiter(sorted(self._updated_since_build), np.int64,
                            len(self._updated_since_build)),
            ])
            extra_valid = np.zeros(len(extra_ids), bool)
            extra_rows = np.zeros((len(extra_ids), d), np.float32)
            for j, row in enumerate(self._mutable.get_batch(extra_ids)):
                if row is not None:
                    extra_valid[j] = True
                    extra_rows[j] = row
            dev = self.device
            self._extra_cache = (
                torch.from_numpy(extra_rows).to(dev),
                torch.from_numpy(extra_ids).to(dev),
                torch.from_numpy(extra_valid).to(dev),
                extra_ids, extra_valid)
        return self._extra_cache

    def _maybe_rebuild(self):
        if len(self._mutable._mutations) >= self.rebuild_threshold:
            self._rebuild()

    @property
    def size(self) -> int:
        return self._mutable.size

    def force_rebuild(self) -> None:
        with self._lock:
            self._rebuild()

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params=None, allow_mask=None):
        """Main-index candidates, then the exact merge on the device.

        The main index is searched with ``params`` less its epsilons (they
        would act on stale snapshot distances and could starve the
        adaptive fetch); the epsilons apply to the merge's exact current
        distances, the tighter of the two. ``allow_mask`` ([total rows]
        bool) filters the main candidates (and goes to a main index that
        takes a mask) and the delta slab by row id. Returns (ids [B, k]
        int64, distances [B, k] float32), (-1, inf) where missing.
        """
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        b, d = queries.shape
        eps = (params.effective_epsilon() if params is not None
               else float("inf"))
        main_params = None
        if params is not None:
            main_params = dataclasses.replace(
                params, pre_reordering_epsilon=None,
                post_reordering_epsilon=None)
        with self._lock:
            snap_rows = self._snapshot_rows
            total_rows = self._mutable.total_rows
            measure = self._measure_of_main()
            mask_all = None
            if allow_mask is not None:
                mask_all = np.zeros(total_rows, bool)
                m = np.asarray(allow_mask, bool)[:total_rows]
                mask_all[:len(m)] = m
            # 1. main-index candidates, over-fetched to survive masking.
            # Adaptive: while some query has fewer than min(k, live
            # snapshot rows) valid candidates, double the fetch, so k
            # results come back whenever k live rows exist
            fetch = min(max(2 * k, k + 8), snap_rows) if snap_rows else 0
            live = ~self._cand_invalid if snap_rows else np.zeros(0, bool)
            if mask_all is not None and snap_rows:
                live = live & mask_all[:snap_rows]
            need = min(k, int(live.sum()))

            def fetch_candidates(f):
                kw = {}
                if mask_all is not None and self._main_takes_mask:
                    kw["allow_mask"] = mask_all[:snap_rows]
                ci, _ = self._main.search_batched_arrays(
                    queries, f, main_params, **kw)
                ci = np.asarray(ci, np.int64)
                in_range = (ci >= 0) & (ci < snap_rows)
                safe = np.clip(ci, 0, max(snap_rows - 1, 0))
                valid = in_range & ~self._cand_invalid[safe]
                if mask_all is not None:
                    valid &= mask_all[:snap_rows][safe]
                return ci, valid

            if fetch > 0:
                cand_i, cand_valid = fetch_candidates(fetch)
                while (need > 0 and fetch < snap_rows
                       and cand_valid.sum(axis=1).min() < need):
                    fetch = min(fetch * 2, snap_rows)
                    # real (non-padding) candidates, deleted or not: the
                    # loop stops when the main index hits its candidate
                    # ceiling, also for searchers that pad with -1 slots
                    prev_real = int((cand_i >= 0).sum(axis=1).max())
                    cand_i, cand_valid = fetch_candidates(fetch)
                    if int((cand_i >= 0).sum(axis=1).max()) <= prev_real:
                        # doubling the fetch cannot widen a capped window
                        # (tree-x-AH's p * leaf ceiling): name the lever
                        if cand_valid.sum(axis=1).min() < need:
                            warnings.warn(
                                "DynamicSearcher: the main index caps "
                                f"candidates at {cand_i.shape[1]} < the "
                                f"{need} live results some query needs "
                                "under heavy deletes; raise the searcher's"
                                " candidate ceiling (e.g. "
                                "num_leaves_to_search) or force_rebuild()",
                                RuntimeWarning, stacklevel=2)
                        break
            else:
                cand_i = np.zeros((b, 0), np.int64)
                cand_valid = np.zeros_like(cand_i, bool)
            if cand_i.shape[1] == 0:
                cand_i = np.full((b, 1), -1, np.int64)
                cand_valid = np.zeros((b, 1), bool)

            # 2. the delta slab: rows added or updated since the build,
            # shared by the queries, cached between mutations; an allowlist
            # re-derives only its validity vector
            (extra_rows, extra_ids, extra_valid,
             ids_np, valid_np) = self._extra_slab(d)
            if mask_all is not None and len(ids_np):
                extra_valid = torch.from_numpy(
                    valid_np & mask_all[np.clip(ids_np, 0, total_rows - 1)]
                ).to(self.device)

            dev = self.device
            snap_db = (self._snapshot_ds.device(dev)[0] if snap_rows
                       else torch.zeros((1, d), dtype=torch.float32,
                                        device=dev))
            k_eff = min(k, cand_i.shape[1] + len(ids_np))
            vals, idx = dynamic_merge(
                torch.from_numpy(queries).to(dev), snap_db,
                torch.from_numpy(np.where(cand_valid, cand_i, -1)).to(dev),
                extra_rows, extra_ids, extra_valid, eps, k=k_eff,
                measure=measure)
            out_i = np.full((b, k), -1, np.int64)
            out_d = np.full((b, k), np.inf, np.float32)
            out_i[:, :k_eff] = idx.cpu().numpy()
            out_d[:, :k_eff] = vals.cpu().numpy()
            return out_i, out_d

    def _measure_of_main(self) -> DistanceMeasure:
        """``distance_measure`` if given, else the main index's
        ``distance_measure`` or ``_measure`` attribute, else squared L2 (as
        the JAX package: tree-x-AH and the hasher keep their measure only
        in their config, so over them this is squared L2 unless passed)."""
        if self._distance_measure is not None:
            return self._distance_measure
        m = getattr(self._main, "distance_measure", None) \
            or getattr(self._main, "_measure", None)
        return m if m is not None else DistanceMeasure.SQUARED_L2
