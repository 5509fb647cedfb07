"""Exact search over sparse sets (counterpart of
``scann_tpu/models/sparse_brute_force.py``): JACCARD, DICE,
NON_ZERO_INTERSECT, OVERLAP and WEIGHTED_JACCARD over a ``SparseDataset``.

The JAX searcher densifies the dataset into an [N, D] incidence (or
|values|) matrix for the TPU's matrix unit, and scores WEIGHTED_JACCARD
through an L1 identity in a scan over column chunks. Here the dataset
stays in its nonzeros, as a CSR matrix on the card, and each query chunk
costs work in proportion to the stored nonzeros:

    set measures      I = M @ q            (M: the [N, D] 0/1 incidence)
    WEIGHTED_JACCARD  Σ min(|x|, |q|) = R @ min(|q|[cols], |x|)
                      (R: the [N, nnz] row-of-each-nonzero matrix)

both one CSR-times-dense product (``torch.sparse.mm``) over the query
chunk's columns. The distances then follow the JAX formulas in the same
float32 operation order, so the set measures come out bit-equal; Σ min is
summed directly (the JAX identity cancels in float32), so weighted
distances sit closer to float64 than the JAX package's.

The stored form keeps the JAX densification's semantics: a point's index
counts as a member even when its value is 0 (the incidence comes from the
indices); a repeated index counts once, and for WEIGHTED_JACCARD keeps its
last value in the point's stored order, as numpy's assignment does.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import SparseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.models.brute_force import QUERY_CHUNK_BYTES
from scann_tpu_torch.models.searcher import SearchParameters, Searcher
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.ops.topk import top_k_smallest
from scann_tpu_torch.types import (
    DEFAULT_DEVICE,
    MASKED_DISTANCE,
    require_device,
)

_SET_MEASURES = (DistanceMeasure.JACCARD, DistanceMeasure.DICE,
                 DistanceMeasure.NON_ZERO_INTERSECT, DistanceMeasure.OVERLAP)
# the JAX package's cap on the densified incidence, kept for its errors
MAX_DIMENSIONALITY = 65536


def stored_nonzeros(dataset: SparseDataset
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr [N + 1] int64, columns [nnz] int64, |values| [nnz] float32)
    of the dataset with each point's repeated indices merged: a column
    appears once a row, with the absolute value of its last occurrence in
    the point's (stably sorted) stored order."""
    n = len(dataset)
    points = [dataset.get(i) for i in range(n)]
    lens = np.array([len(p.indices) for p in points], dtype=np.int64)
    cols = (np.concatenate([p.indices for p in points]).astype(np.int64)
            if lens.sum() else np.zeros(0, np.int64))
    vals = (np.abs(np.concatenate(
        [np.asarray(p.values, np.float32) for p in points]))
        if lens.sum() else np.zeros(0, np.float32))
    rows = np.repeat(np.arange(n), lens)
    # indices are sorted within a point, so repeats are neighbours: keep the
    # last of each run
    last = np.ones(len(cols), dtype=bool)
    last[:-1] = (rows[:-1] != rows[1:]) | (cols[:-1] != cols[1:])
    counts = np.bincount(rows[last], minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, cols[last], vals[last]


def _csr(indptr: np.ndarray, cols: np.ndarray, values: torch.Tensor,
         shape, device: torch.device) -> torch.Tensor:
    """A CSR tensor on ``device`` (int32 indices where they fit)."""
    idx = torch.int32 if max(len(cols), shape[1]) < 2 ** 31 else torch.int64
    with warnings.catch_warnings():
        # torch warns that its CSR support is in beta and that invariant
        # checks are off; the arrays come from stored_nonzeros
        warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
        warnings.filterwarnings("ignore", message="Sparse invariant checks")
        return torch.sparse_csr_tensor(
            torch.from_numpy(indptr).to(device, idx),
            torch.from_numpy(cols).to(device, idx), values.to(device),
            size=shape, check_invariants=False)


def set_distances(inter: torch.Tensor, sizes: torch.Tensor,
                  q_sizes: torch.Tensor,
                  measure: DistanceMeasure) -> torch.Tensor:
    """[B, N] set distances from the intersections ``inter`` [B, N], the
    points' set sizes [N] and the queries' [B], in the JAX package's
    float32 operation order."""
    a = sizes[None, :]
    b = q_sizes[:, None]
    if measure == DistanceMeasure.JACCARD:
        union = a + b - inter
        return torch.where(union > 0, 1.0 - inter / union.clamp_min(1.0),
                           0.0)
    if measure == DistanceMeasure.DICE:
        total = a + b
        return torch.where(total > 0,
                           1.0 - 2.0 * inter / total.clamp_min(1.0), 0.0)
    if measure == DistanceMeasure.NON_ZERO_INTERSECT:
        return -inter
    # OVERLAP: the coefficient is 0 when either set is empty -> distance 1
    m = torch.minimum(a, b)
    return torch.where(m > 0, 1.0 - inter / m.clamp_min(1.0), 1.0)


def weighted_jaccard_distances(min_sum: torch.Tensor, row_sums: torch.Tensor,
                               q_sums: torch.Tensor) -> torch.Tensor:
    """[B, N] 1 - Σmin / Σmax from Σ min(|x|, |q|) [B, N] and the |value|
    sums of the points [N] and the queries [B]; 0 where both are empty."""
    max_sum = q_sums[:, None] + row_sums[None, :] - min_sum
    return torch.where(max_sum > 0,
                       1.0 - min_sum / max_sum.clamp_min(1e-30), 0.0)


class SparseBruteForceSearcher(Searcher):
    """Exact set-similarity search over a ``SparseDataset``, its nonzeros
    held on ``device`` (the current CUDA device unless the caller names
    another)."""

    def __init__(self, dataset: SparseDataset,
                 distance_measure: DistanceMeasure = DistanceMeasure.JACCARD,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        if distance_measure not in (
                *_SET_MEASURES, DistanceMeasure.WEIGHTED_JACCARD):
            raise ScannError.invalid_argument(
                f"sparse searcher supports set measures, got "
                f"{distance_measure}")
        if dataset.dimensionality > MAX_DIMENSIONALITY:
            raise ScannError.invalid_argument(
                f"sparse search is capped at {MAX_DIMENSIONALITY} dims")
        self._dataset = dataset
        self._measure = distance_measure
        self.device = require_device(device)
        self._weighted = distance_measure == DistanceMeasure.WEIGHTED_JACCARD
        n, d = len(dataset), dataset.dimensionality
        indptr, cols, absvals = stored_nonzeros(dataset)
        self._nnz = len(cols)
        if self._weighted:
            self._cols = torch.from_numpy(cols).to(self.device)
            self._absvals = torch.from_numpy(absvals).to(self.device)
            self._rows = _csr(indptr, np.arange(self._nnz), torch.ones(
                self._nnz), (n, self._nnz), self.device)
            sums = np.bincount(np.repeat(np.arange(n), np.diff(indptr)),
                               weights=absvals.astype(np.float64),
                               minlength=n)
            self._sizes = torch.from_numpy(sums.astype(np.float32)).to(
                self.device)
        else:
            self._incidence = _csr(indptr, cols, torch.ones(self._nnz),
                                   (n, d), self.device)
            self._sizes = torch.from_numpy(
                np.diff(indptr).astype(np.float32)).to(self.device)

    @property
    def distance_measure(self) -> DistanceMeasure:
        return self._measure

    def dataset_size(self) -> int:
        return len(self._dataset)

    def dimensionality(self) -> int:
        return self._dataset.dimensionality

    def query_chunk(self) -> int:
        """Queries a chunk: the product's output, the distances and the
        selection's keys (about 32 bytes a point), and for WEIGHTED_JACCARD
        the gathered query entries (4 bytes a nonzero), within
        ``QUERY_CHUNK_BYTES``."""
        per_query = 32 * max(self.dataset_size(), 1)
        if self._weighted:
            per_query += 4 * self._nnz
        return max(1, QUERY_CHUNK_BYTES // per_query)

    def search_sparse(self, indices, k: int, values=None):
        """One query given by its index set (and optional values; absent
        values default to 1.0). The values are not binarized: for the set
        measures they weight the intersection and the query's size, as in
        the JAX package."""
        q = np.zeros((1, self.dimensionality()), dtype=np.float32)
        idx_arr = np.asarray(indices, dtype=np.int64)
        q[0, idx_arr] = 1.0 if values is None else np.asarray(values,
                                                              np.float32)
        idx, dist = self._search_incidence(torch.from_numpy(q), k)
        return self._to_results(idx.cpu().numpy(), dist.cpu().numpy())[0]

    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) on the searcher's
        device for dense query rows [B, D]: binarized (non-zero = member)
        for the set measures, real values for WEIGHTED_JACCARD."""
        q = queries.to(self.device).float()
        if q.dim() == 1:
            q = q[None, :]
        if q.dim() != 2 or q.shape[1] != self.dimensionality():
            raise ScannError.invalid_argument(
                f"queries must be [B, {self.dimensionality()}], got "
                f"{list(q.shape)}")
        if not self._weighted:
            q = (q != 0).float()
        return self._search_incidence(q, k)

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        idx, dist = self.search_batched_tensors(
            torch.from_numpy(np.asarray(queries, dtype=np.float32)), k)
        return (idx.cpu().numpy().astype(np.int32),
                dist.cpu().numpy().astype(np.float32))

    def _search_incidence(self, q: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The k nearest of each row of ``q`` [B, D], already binarized or
        weighted, in query chunks of :meth:`query_chunk`."""
        if self.dataset_size() == 0:
            raise ScannError.failed_precondition("dataset is empty")
        k = min(int(k), self.dataset_size())
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")
        q = q.to(self.device)
        if self._weighted:
            q = q.abs()
        out_i, out_d = [], []
        step = self.query_chunk()
        for lo in range(0, q.shape[0], step):
            vals, idx = top_k_smallest(self._distances(q[lo:lo + step]), k)
            missing = vals >= MASKED_DISTANCE / 2
            out_d.append(torch.where(missing, float("inf"), vals))
            out_i.append(torch.where(missing, -1, idx))
        if not out_i:
            return (torch.empty(0, k, dtype=torch.int64, device=self.device),
                    torch.empty(0, k, device=self.device))
        return torch.cat(out_i), torch.cat(out_d)

    def _distances(self, q: torch.Tensor) -> torch.Tensor:
        """[c, N] distances of one query chunk ``q`` [c, D] on the device,
        binarized or |values|: one CSR product over its transpose, then
        the measure's formula."""
        q_sums = q.double().sum(dim=1).float()
        qt = q.T.contiguous()                                     # [D, c]
        if self._weighted:
            gathered = qt[self._cols]                             # [nnz, c]
            torch.minimum(gathered, self._absvals[:, None], out=gathered)
            min_sum = torch.sparse.mm(self._rows, gathered).T
            dists = weighted_jaccard_distances(min_sum, self._sizes, q_sums)
        else:
            inter = torch.sparse.mm(self._incidence, qt).T
            dists = set_distances(inter, self._sizes, q_sums, self._measure)
        return dists.contiguous()
