"""Sharded exact search and k-means (counterpart of
``scann_tpu/parallel/sharded.py``).

Search: each shard scores its database block and keeps a local top-k; the
[B, k] partials gather on the mesh's home device (``all_gather`` across
processes) and one top-k merges them. Database rows never move — only
candidate lists do.

k-means: each shard assigns its rows and sums them per cluster; the
(sum, count, inertia) partials add up over the shards (``psum``), the
data-parallel pattern where gradients are replaced by cluster sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.models.searcher import SearchParameters, Searcher
from scann_tpu_torch.ops.distances import (
    DistanceMeasure,
    many_to_many,
    squared_norms,
)
from scann_tpu_torch.ops.topk import merge_top_k, top_k_smallest
from scann_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedRows,
    gather_columns,
    make_mesh,
    shard_rows,
    sum_shards,
)
from scann_tpu_torch.trees.kmeans import assign_clusters
from scann_tpu_torch.types import MASKED_DISTANCE


def _shard_rows_mask(shards: ShardedRows, i: int, n_valid: int,
                     device: torch.device) -> torch.Tensor:
    """[blk] bool: shard i's rows that are real and below ``n_valid``."""
    col = torch.arange(shards.blk, device=device)
    return (col < shards.valid[i]) & (col + shards.row0[i] < int(n_valid))


def sharded_search_kernel(mesh: Mesh, measure: DistanceMeasure, k: int,
                          db_axis: str = "db", q_axis: Optional[str] = None):
    """The sharded exact search:
    ``fn(db_shards, norms_shards, n_valid, queries) -> (dists [B, k],
    global indices [B, k])`` on the mesh's home device.

    ``db_shards`` / ``norms_shards`` come from :func:`shard_rows` over
    ``db_axis``; queries replicate, or split into ``mesh.shape[q_axis]``
    blocks on a 2-D mesh (block i scored on the devices of row i)."""
    n_shards = mesh.shape[db_axis]

    def fn(db_shards: ShardedRows, norms_shards, n_valid,
           queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        blk = db_shards.blk
        if k > n_shards * min(k, blk):
            raise ScannError.invalid_argument(
                f"k={k} exceeds the {n_shards * min(k, blk)} gathered "
                f"candidates ({n_shards} shards x {blk} rows); clamp k to "
                "the padded database size")
        k_local = min(k, blk)
        if q_axis is None:
            q_blocks, dev_rows = [queries], [mesh.axis_devices(db_axis)]
        else:
            nq = mesh.shape[q_axis]
            if queries.shape[0] % nq:
                raise ScannError.invalid_argument(
                    f"{queries.shape[0]} queries do not split into {nq} "
                    f"blocks of the {q_axis!r} axis")
            q_blocks = list(torch.chunk(queries, nq))
            qa, da = (mesh.axis_names.index(q_axis),
                      mesh.axis_names.index(db_axis))
            devs = np.moveaxis(mesh.devices, (qa, da), (0, 1))
            dev_rows = [list(devs[i, :].ravel()[:n_shards])
                        for i in range(nq)]
        outs_d, outs_i = [], []
        for q_blk, devs in zip(q_blocks, dev_rows):
            vals_l, idx_l = [], []
            for i, (db, nrm) in enumerate(zip(db_shards, norms_shards)):
                if db is None:
                    vals_l.append(None)
                    idx_l.append(None)
                    continue
                dev = devs[i]
                db, nrm = db.to(dev), nrm.to(dev)
                dists = many_to_many(measure, q_blk.to(dev), db, nrm)
                ok = _shard_rows_mask(db_shards, i, n_valid, dev)
                dists = torch.where(ok[None, :], dists,
                                    float(MASKED_DISTANCE))
                vals, idx = top_k_smallest(dists, k_local)
                vals_l.append(vals)
                idx_l.append(idx + db_shards.row0[i])
            all_vals = gather_columns(mesh, vals_l, db_axis)
            all_idx = gather_columns(mesh, idx_l, db_axis)
            out_vals, out_idx = merge_top_k(all_vals, all_idx, k)
            missing = out_vals >= MASKED_DISTANCE / 2
            outs_d.append(torch.where(missing, float("inf"), out_vals))
            outs_i.append(torch.where(missing, -1, out_idx))
        home = mesh.home(db_axis)
        return (torch.cat([d.to(home) for d in outs_d]),
                torch.cat([i.to(home) for i in outs_i]))

    return fn


def sharded_kmeans_step(mesh: Mesh, k: int, db_axis: str = "db"):
    """One Lloyd's iteration over sharded data:
    ``fn(data_shards, centers [K, D], n_valid) -> (new_centers [K, D],
    counts [K], inertia)`` on the mesh's home device.

    ``n_valid`` is the REAL global row count: :func:`shard_rows` pads the
    rows to a multiple of the mesh size, and padding rows join no cluster
    and add no inertia. The per-cluster sums add float32 rows (the JAX
    sharded step's one-hot product is exact float32 too); a cluster no row
    joined keeps its centre."""

    def fn(data_shards: ShardedRows, centers: torch.Tensor, n_valid):
        sums_l, counts_l, inertia_l = [], [], []
        for i, x in enumerate(data_shards):
            if x is None:
                continue
            cent = centers.to(x.device).float()
            assign, min_d = assign_clusters(x.float(), cent)
            valid = _shard_rows_mask(data_shards, i, n_valid, x.device)
            a = assign[valid]
            sums = torch.zeros(k, cent.shape[1], dtype=torch.float32,
                               device=x.device)
            sums.index_add_(0, a, x[valid].float())
            sums_l.append(sums)
            counts_l.append(torch.bincount(a, minlength=k).float())
            inertia_l.append(min_d[valid].sum().reshape(1))
        sums = sum_shards(mesh, sums_l, db_axis)
        counts = sum_shards(mesh, counts_l, db_axis)
        inertia = sum_shards(mesh, inertia_l, db_axis)[0]
        centers = centers.to(sums.device).float()
        new_centers = torch.where(
            (counts > 0)[:, None], sums / counts.clamp_min(1.0)[:, None],
            centers)
        return new_centers, counts, inertia

    return fn


class ShardedBruteForceSearcher(Searcher):
    """Exact search with the database sharded over a mesh: the [N, D] rows
    live shard-wise on the mesh's devices, queries replicate, the per-shard
    top-k partials merge."""

    def __init__(self, dataset: DenseDataset,
                 distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
                 mesh: Optional[Mesh] = None):
        self._dataset = dataset
        self._measure = distance_measure
        self.mesh = mesh or make_mesh(axis_names=("db",))
        # host rows straight into the shards: no device ever holds them all
        self._db, self._n = shard_rows(self.mesh, dataset.numpy())
        self._norms = [None if x is None else squared_norms(x)
                       for x in self._db]
        self._kernels = {}

    @property
    def distance_measure(self) -> DistanceMeasure:
        return self._measure

    @property
    def dataset(self) -> DenseDataset:
        return self._dataset

    def dataset_size(self) -> int:
        return self._dataset.size

    def dimensionality(self) -> int:
        return self._dataset.dimensionality

    def _docids(self):
        return self._dataset.docids

    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) on the mesh's home
        device; the tighter of the two epsilons applies to the exact
        distances, as in the single-device brute force."""
        k = min(int(k), self.dataset_size())
        if k <= 0:
            raise ScannError.invalid_argument("k must be positive")
        if k not in self._kernels:
            self._kernels[k] = sharded_search_kernel(self.mesh, self._measure,
                                                     k)
        dists, idx = self._kernels[k](self._db, self._norms, self._n,
                                      queries.float())
        eps = params.effective_epsilon() if params is not None else np.inf
        if np.isfinite(eps):
            over = dists > eps
            dists = torch.where(over, float("inf"), dists)
            idx = torch.where(over, -1, idx)
        return idx, dists

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        queries = self._validate_queries(queries)
        idx, dists = self.search_batched_tensors(
            torch.from_numpy(queries).to(self.mesh.home()), k, params)
        return (idx.cpu().numpy().astype(np.int32),
                dists.cpu().numpy().astype(np.float32))
