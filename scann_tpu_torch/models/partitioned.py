"""Partitioned (tree-based) exact searcher (counterpart of
``scann_tpu/models/partitioned.py``).

One batch of queries on the device:

    centroid distances -> top-p partitions -> their padded leaf lists
    -> the candidate rows -> exact distances in the measure -> masked top-k

Padded leaves keep every shape static; a -1 leaf slot scores
MASKED_DISTANCE and surfaces as (-1, inf) when fewer than k real candidates
exist. Under spilling a point can sit in several of the selected leaves,
so the selection over-fetches by the largest multiplicity and keeps each
id once (``top_k_unique``). Squared norms come from a table over the
database (the JAX package recomputes them from the gathered rows only
because TPU gathers cost more than the arithmetic).

The gathered rows are [B, p * L, D] float32: 3.6 GB for a batch of 1024
at p=10, L=888, D=100. The queries run in chunks whose gathered rows stay
within ``QUERY_CHUNK_BYTES`` (1 GiB, the exact brute-force searcher's
limit); queries are independent, so the chunking never changes a result.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.models.brute_force import QUERY_CHUNK_BYTES
from scann_tpu_torch.models.searcher import (
    SearchParameters,
    Searcher,
    pad_results_to_k,
)
from scann_tpu_torch.ops.distances import (
    DistanceMeasure,
    gathered_distances,
    squared_norms,
)
from scann_tpu_torch.ops.topk import top_k_smallest, top_k_unique
from scann_tpu_torch.partitioning.tree_partitioner import (
    TreePartitioner,
    TreePartitionerConfig,
    select_partitions,
)
from scann_tpu_torch.types import (
    DEFAULT_DEVICE,
    MASKED_DISTANCE,
    require_device,
)


def gather_chunk(n_cand: int, d: int) -> int:
    """Queries per chunk whose gathered [chunk, n_cand, D] float32 rows
    stay within ``QUERY_CHUNK_BYTES``."""
    return max(1, QUERY_CHUNK_BYTES // (4 * max(n_cand, 1) * max(d, 1)))


def select_candidates(centers: torch.Tensor, leaves: torch.Tensor,
                      queries: torch.Tensor, *, measure: DistanceMeasure,
                      p: int) -> torch.Tensor:
    """[B, p * L] candidate ids (-1 in padding slots): the padded leaves of
    each query's top-p partitions, nearest first."""
    parts = select_partitions(centers, queries, measure=measure, p=p)[1]
    return leaves[parts].reshape(queries.shape[0], -1)


def candidate_distances(db: torch.Tensor, norms: torch.Tensor,
                        queries: torch.Tensor, cand: torch.Tensor, *,
                        measure: DistanceMeasure) -> torch.Tensor:
    """[B, C] exact distances of each query to its candidates,
    MASKED_DISTANCE in padding slots."""
    valid = cand >= 0
    safe = cand.clamp_min(0)
    rows = db[safe]                                        # [B, C, D]
    dists = gathered_distances(measure, queries, rows, norms[safe])
    return torch.where(valid, dists, float(MASKED_DISTANCE))


def select_results(dists: torch.Tensor, cand: torch.Tensor, k: int, *,
                   multiplicity: int, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances [B, k], ids [B, k]) of the k nearest candidates, each id
    once; masked slots and distances past ``eps`` come back as (inf, -1)."""
    if multiplicity > 1:
        vals, idx = top_k_unique(dists, cand, k, multiplicity)
    else:
        vals, pos = top_k_smallest(dists, k)
        idx = torch.gather(cand, 1, pos)
    missing = (vals >= MASKED_DISTANCE / 2) | (vals > eps)
    return (torch.where(missing, float("inf"), vals),
            torch.where(missing, -1, idx))


def partitioned_search(db: torch.Tensor, norms: torch.Tensor,
                       centers: torch.Tensor, leaves: torch.Tensor,
                       queries: torch.Tensor, eps: float = float("inf"), *,
                       measure: DistanceMeasure, p: int, k: int,
                       multiplicity: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances [B, k], ids [B, k]; -1 / inf where missing) of the exact
    search over each query's top-p partitions, in query chunks of
    :func:`gather_chunk` rows. The counterpart of the JAX package's
    ``partitioned_search_kernel``; ``k`` must not exceed p * L."""
    cand = select_candidates(centers, leaves, queries, measure=measure, p=p)
    step = gather_chunk(cand.shape[1], db.shape[1])
    out_d, out_i = [], []
    for lo in range(0, queries.shape[0], step):
        qc, cc = queries[lo:lo + step], cand[lo:lo + step]
        dists = candidate_distances(db, norms, qc, cc, measure=measure)
        vals, idx = select_results(dists, cc, k, multiplicity=multiplicity,
                                   eps=eps)
        out_d.append(vals)
        out_i.append(idx)
    if not out_d:
        empty = queries.new_empty(0, k)
        return empty, empty.long()
    return torch.cat(out_d), torch.cat(out_i)


class PartitionedSearcher(Searcher):
    """Exact search over the top-p k-means partitions, on ``device`` (the
    current CUDA device unless the caller names another). Builds its
    partitioner from ``config`` (measure set to ``distance_measure``)
    unless a built ``partitioner`` is given."""

    def __init__(
        self,
        dataset: DenseDataset,
        partitioner: Optional[TreePartitioner] = None,
        config: Optional[TreePartitionerConfig] = None,
        num_partitions_to_search: int = 10,
        distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ):
        self.device = require_device(device)
        self._dataset = dataset
        self._measure = distance_measure
        self._p_default = num_partitions_to_search
        if partitioner is not None:
            self.partitioner = partitioner
        else:
            cfg = config or TreePartitionerConfig()
            cfg.distance_measure = distance_measure
            self.partitioner = TreePartitioner(cfg, device=self.device).build(
                dataset.device_tensor(self.device), host=dataset.numpy())
        self._norms_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

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

    def device_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows [N, D] float32, their squared norms [N]) on the device; the
        norms are computed once per uploaded tensor."""
        db = self._dataset.device_tensor(self.device)
        if self._norms_cache is None or self._norms_cache[0] is not db:
            self._norms_cache = (db, squared_norms(db))
        return db, self._norms_cache[1]

    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) for [B, D] float32
        queries on the searcher's device, -1 / inf where a result is
        missing (also the slots past p * L when k exceeds it); no host copy
        of the results."""
        if self.dataset_size() == 0:
            raise ScannError.failed_precondition("dataset is empty")
        p = self._p_default
        if params is not None and params.num_leaves_to_search is not None:
            p = params.num_leaves_to_search
        p = min(int(p), self.partitioner.num_partitions)
        if p <= 0:
            raise ScannError.invalid_argument(
                "num_leaves_to_search must be positive")
        k = int(k)
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")
        leaves = self.partitioner.tokenization.padded_leaves()
        eps = params.effective_epsilon() if params is not None else np.inf
        db, norms = self.device_state()
        queries = queries.to(db.device).float()
        if queries.dim() == 1:
            queries = queries[None, :]
        # p * L can cap the reachable candidates below k: the [B, k]
        # contract is kept with (-1, inf) padding
        dists, idx = partitioned_search(
            db, norms, self.partitioner.centers_device(), leaves, queries,
            eps, measure=self._measure, p=p, k=min(k, p * leaves.shape[1]),
            multiplicity=self.partitioner.tokenization.max_multiplicity)
        return pad_results_to_k(idx, dists, k)

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        queries = self._validate_queries(queries)
        idx, dists = self.search_batched_tensors(
            torch.from_numpy(queries), k, params)
        return (idx.cpu().numpy().astype(np.int32),
                dists.cpu().numpy().astype(np.float32))
