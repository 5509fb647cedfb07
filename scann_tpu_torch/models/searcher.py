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
    # crowding is not ported yet: a search with it set raises rather than
    # return uncrowded results (ROADMAP.md queue 1, item 8d)
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

    def check_ported(self) -> None:
        """Raise for a setting the port cannot serve yet."""
        if self.crowding_enabled:
            raise NotImplementedError(
                "crowding is not ported yet (ROADMAP.md queue 1, item 8d: "
                "restricts and crowding)")

    def effective_epsilon(self) -> float:
        """Distance threshold of a single-stage search: with no separate
        re-ranking pass the search is both the "pre" and the "post" stage,
        so the tighter of the two thresholds applies (inf when unset)."""
        self.check_ported()
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
        params.check_ported()
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
        """Document ids by index. None: the port has no docid collection
        until ``data/docid.py`` is ported (ROADMAP.md queue 1, item 8), so
        results carry ``docid=None``."""
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
