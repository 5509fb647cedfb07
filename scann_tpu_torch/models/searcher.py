"""Common searcher interface (counterpart of
``scann_tpu/models/searcher.py``): search parameters, the epsilon ladder,
query validation, result padding and the per-query object API (``search``,
``search_batched``) over each searcher's batched array search."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError


@dataclasses.dataclass
class SearchParameters:
    """Per-query search knobs."""

    num_neighbors: Optional[int] = None
    pre_reordering_num_neighbors: Optional[int] = None
    pre_reordering_epsilon: Optional[float] = None
    post_reordering_epsilon: Optional[float] = None
    num_leaves_to_search: Optional[int] = None
    # accepted and not read, as in the JAX package: crowding is
    # ``Searcher.search_with_crowding`` with a ``CrowdingConstraint``
    crowding_enabled: Optional[bool] = None

    def with_num_neighbors(self, k: int) -> "SearchParameters":
        self.num_neighbors = k
        return self

    def with_pre_reordering_neighbors(self, k: int) -> "SearchParameters":
        self.pre_reordering_num_neighbors = k
        return self

    def with_leaves_to_search(self, n: int) -> "SearchParameters":
        self.num_leaves_to_search = n
        return self

    def with_epsilon(self, epsilon: float) -> "SearchParameters":
        self.pre_reordering_epsilon = epsilon
        return self

    def effective_epsilon(self) -> float:
        """Distance threshold of a single-stage search: with no separate
        re-ranking pass the search is both the "pre" and the "post" stage,
        so the tighter of the two thresholds applies (inf when unset)."""
        eps = float("inf")
        if self.pre_reordering_epsilon is not None:
            eps = min(eps, float(self.pre_reordering_epsilon))
        if self.post_reordering_epsilon is not None:
            eps = min(eps, float(self.post_reordering_epsilon))
        return eps


def epsilons(params: Optional[SearchParameters]):
    """(pre, post) per-query distance thresholds, inf when unset."""
    pre = post = np.inf
    if params is not None:
        if params.pre_reordering_epsilon is not None:
            pre = float(params.pre_reordering_epsilon)
        if params.post_reordering_epsilon is not None:
            post = float(params.post_reordering_epsilon)
    return pre, post


def pad_results_to_k(idx: torch.Tensor, dists: torch.Tensor, k: int):
    """Pad [B, w] result tensors out to the [B, k] contract with (-1, inf)
    slots when a searcher's candidate ceiling makes w < k (one survivor per
    r-block in the block sweep)."""
    w = idx.shape[1]
    if w >= k:
        return idx, dists
    b = idx.shape[0]
    pi = torch.full((b, k), -1, dtype=idx.dtype, device=idx.device)
    pd = torch.full((b, k), float("inf"), dtype=dists.dtype,
                    device=dists.device)
    pi[:, :w] = idx
    pd[:, :w] = dists
    return pi, pd


@dataclasses.dataclass
class NNResult:
    """One neighbour."""

    index: int
    distance: float
    docid: Optional[object] = None


class SearchResult:
    """One query's neighbours, ascending by distance."""

    def __init__(self, neighbors: Optional[List[NNResult]] = None):
        self.neighbors: List[NNResult] = neighbors or []

    def __len__(self) -> int:
        return len(self.neighbors)

    def __iter__(self):
        return iter(self.neighbors)

    def indices(self) -> List[int]:
        return [nb.index for nb in self.neighbors]

    def distances(self) -> List[float]:
        return [nb.distance for nb in self.neighbors]


class Searcher:
    """Base searcher: subclasses implement ``search_batched_arrays``."""

    def dataset_size(self) -> int:
        raise NotImplementedError

    def dimensionality(self) -> int:
        raise NotImplementedError

    def _docids(self):
        """Document ids by index (a ``DocIdCollection``), or None: the
        dataset had none, and results carry ``docid=None``."""
        return None

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None):
        """(indices [B, k] int32, distances [B, k] float32), ascending by
        distance; index -1 for a missing result."""
        raise NotImplementedError

    def _validate_queries(self, queries: np.ndarray) -> np.ndarray:
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.ndim != 2:
            raise ScannError.invalid_argument(
                f"queries must be [B, D], got {queries.shape}")
        if queries.shape[1] != self.dimensionality():
            raise ScannError.invalid_argument(
                f"query dimensionality {queries.shape[1]} != dataset "
                f"{self.dimensionality()}")
        if self.dataset_size() == 0:
            raise ScannError.failed_precondition("dataset is empty")
        return queries

    def _to_results(self, indices: np.ndarray,
                    dists: np.ndarray) -> List[SearchResult]:
        """[B, k] arrays -> one :class:`SearchResult` per row, missing
        (index -1) slots dropped."""
        docids = self._docids()
        out = []
        for row_idx, row_dist in zip(indices, dists):
            neighbors = []
            for i, d in zip(row_idx, row_dist):
                i = int(i)
                if i < 0:
                    continue
                docid = docids.get(i) if docids is not None else None
                neighbors.append(NNResult(i, float(d), docid))
            out.append(SearchResult(neighbors))
        return out

    def search(self, query, k: Optional[int] = None,
               params: Optional[SearchParameters] = None) -> SearchResult:
        """One query [D]; k defaults to ``params.num_neighbors`` or 10."""
        params = params or SearchParameters()
        k = k if k is not None else (params.num_neighbors or 10)
        q = self._validate_queries(np.asarray(query))
        idx, dist = self.search_batched_arrays(q, k, params)
        return self._to_results(idx, dist)[0]

    def search_with_params(self, query,
                           params: SearchParameters) -> SearchResult:
        """One query, k from ``params.num_neighbors``."""
        return self.search(query, params.num_neighbors, params)

    def search_batched(self, queries, k: Optional[int] = None,
                       params: Optional[SearchParameters] = None
                       ) -> List[SearchResult]:
        """Queries [B, D], one :class:`SearchResult` each."""
        params = params or SearchParameters()
        k = k if k is not None else (params.num_neighbors or 10)
        q = self._validate_queries(np.asarray(queries))
        idx, dist = self.search_batched_arrays(q, k, params)
        return self._to_results(idx, dist)

    def search_batched_with_params(
            self, queries, params_list: Sequence[SearchParameters]
    ) -> List[SearchResult]:
        """One parameter set per query: one batch when all are equal, one
        search per query otherwise."""
        queries = np.asarray(queries, dtype=np.float32)
        if len(params_list) != queries.shape[0]:
            raise ScannError.invalid_argument(
                "params_list length != batch size")
        if all(p == params_list[0] for p in params_list):
            return self.search_batched(queries, params_list[0].num_neighbors,
                                       params_list[0])
        return [self.search(q, p.num_neighbors, p)
                for q, p in zip(queries, params_list)]

    def supports_allow_mask(self) -> bool:
        """Whether ``search_batched_arrays`` takes an ``allow_mask``."""
        import inspect

        try:
            return "allow_mask" in inspect.signature(
                self.search_batched_arrays).parameters
        except (TypeError, ValueError):
            return False

    def search_with_filter(self, query, k: int, restrict_filter,
                           params: Optional[SearchParameters] = None
                           ) -> SearchResult:
        """One query, restricted to the rows ``restrict_filter`` allows."""
        return self.search_batched_with_filter(
            np.asarray(query)[None, :], k, restrict_filter, params)[0]

    def search_batched_with_filter(self, queries, k: int, restrict_filter,
                                   params: Optional[SearchParameters] = None
                                   ) -> List[SearchResult]:
        """Queries [B, D], restricted to the rows ``restrict_filter``
        allows. A searcher that takes an ``allow_mask`` gets the filter's
        mask and applies it on the device; the others over-fetch
        min(max(4k, k + 32), N) and filter on the host."""
        q = self._validate_queries(np.asarray(queries))
        n = self.dataset_size()
        mask = restrict_filter.to_mask(n)
        if self.supports_allow_mask():
            idx, dist = self.search_batched_arrays(q, k, params,
                                                   allow_mask=mask)
            return self._to_results(idx, dist)
        fetch = min(max(4 * k, k + 32), n)
        idx, dist = self.search_batched_arrays(q, fetch, params)
        # the columns actually returned: a searcher's candidate ceiling may
        # cap them below the fetch. Each row keeps its first k allowed
        # candidates in their order (a stable sort puts them in front).
        keep = (idx >= 0) & mask[np.clip(idx, 0, max(n - 1, 0))]
        cols = np.argsort(~keep, axis=1, kind="stable")[:, :k]
        kept = np.take_along_axis(keep, cols, axis=1)
        out_i = np.full((len(q), k), -1, dtype=np.int64)
        out_d = np.full((len(q), k), np.inf, dtype=np.float32)
        w = cols.shape[1]
        out_i[:, :w] = np.where(kept, np.take_along_axis(idx, cols, axis=1),
                                -1)
        out_d[:, :w] = np.where(kept, np.take_along_axis(dist, cols, axis=1),
                                np.inf)
        return self._to_results(out_i, out_d)

    def search_with_crowding(self, queries, k: int, crowding,
                             params: Optional[SearchParameters] = None,
                             over_fetch: int = 4) -> List[SearchResult]:
        """Queries [B, D] under a ``CrowdingConstraint``: over-fetch
        k * over_fetch candidates, then the per-group cap
        (``crowding.apply_batch``)."""
        q = self._validate_queries(np.asarray(queries))
        fetch = min(k * over_fetch, self.dataset_size())
        idx, dist = self.search_batched_arrays(q, fetch, params)
        out_i, out_d = crowding.apply_batch(idx.astype(np.int64), dist, k)
        return self._to_results(out_i, out_d)
