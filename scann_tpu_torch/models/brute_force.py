"""Exact brute-force searcher (counterpart of
``scann_tpu/models/brute_force.py``).

Two paths, dispatched by the JAX package's gate:

  - the fused path: one launch of the exact small-database kernel
    (``ops/fused_bf.py``, distances and the k smallest together) when k <=
    16, the measure is SQUARED_L2, there is no allow mask and the JAX
    package's batch-aware estimate of database + [B, N] distances + column
    iota + queries + outputs fits its 14 MB budget;
  - the composed path otherwise: the [B, N] distance matrix
    (``ops/distances.many_to_many``, any dense measure), the allow mask,
    the tie-free top-k.

Both apply the epsilon rule (a result at or past MASKED_DISTANCE / 2 or
past epsilon is missing: (inf, -1)). The composed path runs in query
chunks whose [chunk, N] float32 matrix stays within ``QUERY_CHUNK_BYTES``:
at 1.18M rows one batch of 1024 queries would otherwise hold 4.85 GB for
the distances alone, and the selection's temporaries more. Queries are
independent, so the chunking never changes a result.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.models.searcher import SearchParameters, Searcher
from scann_tpu_torch.ops.distances import (
    DistanceMeasure,
    many_to_many,
    mask_padded_rows,
    squared_norms,
)
from scann_tpu_torch.ops.fused_bf import fused_bf_search, resident_limit_bytes
from scann_tpu_torch.ops.topk import top_k_smallest
from scann_tpu_torch.types import (
    DEFAULT_DEVICE,
    MASKED_DISTANCE,
    align_up,
    require_device,
)

# bytes of the [chunk, N] float32 distance matrix one query chunk may hold
QUERY_CHUNK_BYTES = 1 << 30
# row alignment of the JAX gate's estimate (float32 sublanes on the TPU)
_GATE_ALIGN = 8


def query_chunk(n_cols: int) -> int:
    """Queries per chunk for a distance matrix of ``n_cols`` columns."""
    return max(1, QUERY_CHUNK_BYTES // (4 * max(n_cols, 1)))


def exact_top_k(score: Callable[[torch.Tensor], torch.Tensor],
                queries: torch.Tensor, n_cols: int, n_valid: int, k: int,
                eps: float, allow: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids [B, k] int64, distances [B, k] float32) of the k smallest
    entries per query of ``score(chunk)`` [chunk, n_cols], over query
    chunks of :func:`query_chunk` rows. Columns >= ``n_valid`` and columns
    not in ``allow`` [n_cols] bool never surface; results at or past
    MASKED_DISTANCE / 2 or past ``eps`` are (-1, inf)."""
    out_i = [torch.empty(0, k, dtype=torch.int64, device=queries.device)]
    out_d = [torch.empty(0, k, device=queries.device)]
    step = query_chunk(n_cols)
    for lo in range(0, queries.shape[0], step):
        dists = score(queries[lo:lo + step])
        if n_cols > n_valid:
            dists = mask_padded_rows(dists, n_valid, MASKED_DISTANCE)
        if allow is not None:
            dists = torch.where(allow[None, :], dists, float(MASKED_DISTANCE))
        vals, idx = top_k_smallest(dists, k)
        del dists
        missing = (vals >= MASKED_DISTANCE / 2) | (vals > eps)
        out_d.append(torch.where(missing, float("inf"), vals))
        out_i.append(torch.where(missing, -1, idx))
    return torch.cat(out_i), torch.cat(out_d)


class BruteForceSearcher(Searcher):
    """Exact search over a dense dataset on ``device`` (the current CUDA
    device unless the caller names another)."""

    def __init__(self, dataset: DenseDataset,
                 distance_measure: DistanceMeasure =
                 DistanceMeasure.SQUARED_L2,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        if not isinstance(dataset, DenseDataset):
            raise ScannError.invalid_argument(
                "BruteForceSearcher needs a DenseDataset")
        self._dataset = dataset
        self._measure = distance_measure
        self.device = torch.device(device)
        self._norms_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    # -- metadata -------------------------------------------------------------
    @property
    def dataset(self) -> DenseDataset:
        return self._dataset

    @property
    def distance_measure(self) -> DistanceMeasure:
        return self._measure

    def dataset_size(self) -> int:
        return self._dataset.size

    def dimensionality(self) -> int:
        return self._dataset.dimensionality

    def _docids(self):
        return self._dataset.docids

    def _device_state(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(rows [N, D] float32, their squared norms [N], N) on the
        device; the norms are computed once per uploaded tensor."""
        db = self._dataset.device_tensor(require_device(self.device))
        if self._norms_cache is None or self._norms_cache[0] is not db:
            self._norms_cache = (db, squared_norms(db))
        return db, self._norms_cache[1], self._dataset.size

    def _use_fused(self, k: int, allow_mask, b: int) -> bool:
        """The JAX package's gate: the single-kernel path when k <= 16,
        SQUARED_L2, no mask, and its estimate of database + [B, N] distances
        + column iota + queries + padded outputs (float32 rows padded to 8)
        fits :func:`~scann_tpu_torch.ops.fused_bf.resident_limit_bytes`."""
        n_pad = align_up(max(self._dataset.size, 1), _GATE_ALIGN)
        b_pad = align_up(max(b, 1), _GATE_ALIGN)
        d = self._dataset.dimensionality
        est = 4 * (n_pad * d + 2 * b_pad * n_pad + b_pad * d
                   + 4 * b_pad * 128)
        return (allow_mask is None and k <= 16
                and self._measure == DistanceMeasure.SQUARED_L2
                and est <= resident_limit_bytes())

    # -- search ---------------------------------------------------------------
    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None,
                               allow_mask=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) for [B, D] float32
        queries on the searcher's device, -1 / inf where a result is
        missing; no host copy of the results. ``allow_mask`` ([N] bool)
        restricts the results to the allowed ids."""
        n = self.dataset_size()
        if n == 0:
            raise ScannError.failed_precondition("dataset is empty")
        k = min(int(k), n)
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")
        db, norms, n = self._device_state()
        eps = params.effective_epsilon() if params is not None else np.inf
        queries = queries.to(db.device).float()
        if self._use_fused(k, allow_mask, queries.shape[0]):
            vals, idx = fused_bf_search(queries, db, norms, n, k)
            if eps < np.inf:
                over = vals > eps
                idx, vals = (torch.where(over, -1, idx),
                             torch.where(over, float("inf"), vals))
            return idx.long(), vals
        allow = None
        if allow_mask is not None:
            allow = torch.from_numpy(np.asarray(allow_mask, dtype=bool)[:n])
            allow = allow.to(db.device)
        return exact_top_k(
            lambda qc: many_to_many(self._measure, qc, db, norms), queries,
            n, n, k, eps, allow)

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask: Optional[np.ndarray] = None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        queries = self._validate_queries(queries)
        idx, dists = self.search_batched_tensors(
            torch.from_numpy(queries), k, params, allow_mask)
        return (idx.cpu().numpy().astype(np.int32),
                dists.cpu().numpy().astype(np.float32))

    def distances_to_all(self, queries: np.ndarray) -> np.ndarray:
        """[B, N] exact distances as numpy, computed in query chunks."""
        queries = self._validate_queries(queries)
        db, norms, n = self._device_state()
        q = torch.from_numpy(queries).to(db.device)
        step = query_chunk(n)
        return np.concatenate(
            [many_to_many(self._measure, q[lo:lo + step], db, norms)
             .cpu().numpy() for lo in range(0, len(q), step)])

    def radius_search(self, query, radius: float,
                      max_results: Optional[int] = None):
        """All points within ``radius`` of one query, ascending by distance
        (ties in index order)."""
        q = self._validate_queries(np.asarray(query))
        dists = self.distances_to_all(q)[0]
        within = np.nonzero(dists <= radius)[0]
        order = within[np.argsort(dists[within], kind="stable")]
        if max_results is not None:
            order = order[:max_results]
        return self._to_results(order[None, :], dists[order][None, :])[0]
