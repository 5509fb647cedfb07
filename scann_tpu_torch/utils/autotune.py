"""Recall-targeted search-parameter tuning (counterpart of
``scann_tpu/utils/autotune.py``).

The reference leaves ``partitions_to_search`` and the re-rank depth to hand
tuning. ``autotune`` sweeps them in one call: each grid point is one
batched search of the whole query sample on the device, exact ground truth
comes from the port's ``BruteForceSearcher`` under the searcher's own
measure, and the result is the cheapest point that meets the recall
target.

Cost model (the JAX package's, ``scann_tpu/utils/autotune.py:16-23``):
searching p partitions scores p * l_cap leaf candidates and the re-rank
gathers pre_k rows a query, so ``cost = p * leaf_weight + pre_k`` ranks the
points without timing each one. Recall is not monotone in p at fixed pre_k
(a wider candidate pool can lose more to PQ misordering), so the whole grid
is evaluated.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.models.searcher import SearchParameters
from scann_tpu_torch.types import DEFAULT_DEVICE


@dataclasses.dataclass
class AutotuneEntry:
    """One evaluated configuration."""

    params: SearchParameters
    recall: float
    cost: float


@dataclasses.dataclass
class AutotuneResult:
    """Cheapest configuration meeting the target, plus the full table."""

    params: SearchParameters
    recall: float
    target_met: bool
    table: List[AutotuneEntry]


def _unwrap(searcher):
    """Innermost concrete searcher: through the Scann facade (``_impl``)
    and a sharded wrapper (``_inner``) — the partition structure and the
    dataset live there; the search itself still goes through the outer
    object."""
    inner = getattr(searcher, "_impl", searcher)
    return getattr(inner, "_inner", inner)


def _dataset_of(searcher):
    searcher = _unwrap(searcher)
    ds = getattr(searcher, "dataset", None)
    if ds is None:
        ds = getattr(searcher, "_dataset", None)
    if ds is None:
        raise ScannError.invalid_argument(
            "autotune needs the searcher's dataset for exact ground truth; "
            "pass gt= explicitly")
    return ds


def _measure_of(searcher):
    searcher = _unwrap(searcher)
    m = getattr(searcher, "_measure", None)
    if m is None:
        for cfg_attr in ("_config", "config"):
            cfg = getattr(searcher, cfg_attr, None)
            m = getattr(cfg, "distance_measure", None)
            if m is not None:
                break
    return m


def _device_of(searcher):
    return getattr(searcher, "device", None) or getattr(
        _unwrap(searcher), "device", DEFAULT_DEVICE)


def _exact_gt(searcher, queries: np.ndarray, k: int) -> np.ndarray:
    from scann_tpu_torch.models.brute_force import BruteForceSearcher

    measure = _measure_of(searcher)
    ds = _dataset_of(searcher)
    device = _device_of(searcher)
    if measure is not None:
        bf = BruteForceSearcher(ds, measure, device=device)
    else:
        bf = BruteForceSearcher(ds, device=device)
    gt, _ = bf.search_batched_arrays(queries, k)
    return gt


def _recall(idx: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([
        len(set(a[a >= 0].tolist()) & set(g.tolist())) / k
        for a, g in zip(idx, gt)]))


def autotune(
    searcher,
    queries: np.ndarray,
    k: int = 10,
    target_recall: float = 0.95,
    p_grid: Optional[Sequence[int]] = None,
    pre_k_grid: Optional[Sequence[int]] = None,
    gt: Optional[np.ndarray] = None,
    leaf_weight: Optional[float] = None,
) -> AutotuneResult:
    """Pick the cheapest (num_leaves_to_search, pre_reordering_num_neighbors)
    meeting ``target_recall`` on a query sample.

    Args:
        searcher: any searcher honoring ``SearchParameters``:
            ``TreeXHybridSearcher`` and ``Scann`` tune (p, pre_k);
            ``BlockSweepSearcher`` and ``AsymmetricHasher`` tune pre_k only
            (the default p grid is detected from the partitioner).
        queries: [B, D] sample (a few hundred queries; each grid point
            searches them as one batch).
        gt: optional [B, k] exact ids; computed from the searcher's dataset
            with its own distance measure on its device when omitted.
        leaf_weight: relative cost of one searched partition against one
            re-ranked row; defaults to the searcher's leaf cap.

    Returns:
        AutotuneResult; ``target_met=False`` means no grid point reached the
        target and ``params`` is the highest-recall (then cheapest) point.
    """
    queries = np.asarray(queries, dtype=np.float32)
    if gt is None:
        gt = _exact_gt(searcher, queries, k)

    inner = _unwrap(searcher)
    partitioner = getattr(inner, "partitioner", None)
    has_partitions = partitioner is not None
    if p_grid is None:
        p_grid = (1, 2, 5, 10, 20, 40) if has_partitions else (None,)
    if pre_k_grid is None:
        pre_k_grid = (max(k, 10), 2 * k, 5 * k, 10 * k, 20 * k, 50 * k)
    pre_k_grid = sorted({max(int(pk), k) for pk in pre_k_grid})
    if leaf_weight is None:
        l_cap = None
        if has_partitions:
            # a sharded wrapper carries its l_cap itself
            l_cap = getattr(getattr(searcher, "_impl", searcher),
                            "_l_cap", None)
            csr_state = getattr(inner, "_csr_state", None)
            if l_cap is None and csr_state is not None:
                l_cap = csr_state()[-1]
        leaf_weight = float(l_cap) if l_cap else 0.0

    n_parts = None
    if has_partitions:
        sizes = getattr(partitioner, "partition_sizes", None)
        if callable(sizes):
            sizes = sizes()
        n_parts = len(sizes) if sizes is not None else None

    table: List[AutotuneEntry] = []
    for p in p_grid:
        if p is not None and n_parts is not None and p > n_parts:
            continue
        for pre_k in pre_k_grid:
            params = SearchParameters(
                pre_reordering_num_neighbors=int(pre_k))
            if p is not None:
                params.num_leaves_to_search = int(p)
            idx, _ = searcher.search_batched_arrays(queries, k, params)
            rec = _recall(idx, gt)
            cost = (0.0 if p is None else p * leaf_weight) + pre_k
            table.append(AutotuneEntry(params, rec, cost))

    if not table:
        raise ScannError.invalid_argument("autotune grid is empty")
    meeting = [e for e in table if e.recall >= target_recall]
    if meeting:
        best = min(meeting, key=lambda e: (e.cost, -e.recall))
        return AutotuneResult(best.params, best.recall, True, table)
    best = max(table, key=lambda e: (e.recall, -e.cost))
    return AutotuneResult(best.params, best.recall, False, table)


@dataclasses.dataclass
class SweepAutotuneResult:
    """Cheapest block-sweep build configuration meeting the target."""

    config: "object"          # BlockSweepConfig to build with
    params: SearchParameters  # serving params (pre_k)
    recall: float
    target_met: bool
    table: List[Tuple[dict, float, float]]  # (knobs, recall, cost)


def autotune_block_sweep(
    dataset,
    queries: np.ndarray,
    k: int = 10,
    target_recall: float = 0.99,
    r_grid: Sequence[int] = (32, 64),
    dtype_grid: Sequence[str] = ("bfloat16", "int8"),
    top2_options: Sequence[bool] = (False, True),
    pre_k_grid: Optional[Sequence[int]] = None,
    gt: Optional[np.ndarray] = None,
    measure=None,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> SweepAutotuneResult:
    """Tune the block sweep's build knobs (r, sweep_dtype, top2) and the
    serving pre_k on ``device``.

    Each (r, dtype) pair builds one sweep copy (no training); every (top2,
    pre_k) point is then one batched search of it: top2 is read from the
    searcher's config at search time and needs no state of its own, so the
    copy serves both.

    Cost proxy per query, at the sample's own B (the JAX package's,
    ``scann_tpu/utils/autotune.py:230-240``):
        stream   = N * (D + 8) * dtype_bytes / B
        minima   = (N / r) * 6 * (2 with top2)
        re-rank  = pre_k * (2 with top2) * D * 4
    A smaller r raises recall (fewer block collisions) and costs more
    minima; int8 halves the stream at a small recall cost; top2 lifts the
    collision ceiling at twice the re-rank width.
    """
    from scann_tpu_torch.models.block_sweep import (
        BlockSweepConfig,
        BlockSweepSearcher,
    )
    from scann_tpu_torch.models.brute_force import BruteForceSearcher
    from scann_tpu_torch.ops.distances import DistanceMeasure as DM

    measure = measure if measure is not None else DM.SQUARED_L2
    queries = np.asarray(queries, dtype=np.float32)
    b = len(queries)
    if gt is None:
        gt, _ = BruteForceSearcher(dataset, measure, device=device
                                   ).search_batched_arrays(queries, k)
    if pre_k_grid is None:
        pre_k_grid = (max(k, 10), 32, 64, 100)
    pre_k_grid = sorted({max(int(pk), k) for pk in pre_k_grid})
    n = dataset.size
    d = dataset.dimensionality

    table: List[Tuple[dict, float, float]] = []
    for dtype in dtype_grid:
        dtype_bytes = 1 if dtype == "int8" else 2
        for r in r_grid:
            cfg = BlockSweepConfig(
                distance_measure=measure, block_r=int(r),
                sweep_dtype=dtype, pre_reorder_k=max(pre_k_grid))
            s = BlockSweepSearcher(dataset, cfg, device=device)
            for top2 in top2_options:
                s._config = dataclasses.replace(cfg, top2=bool(top2))
                for pre_k in pre_k_grid:
                    params = SearchParameters(
                        pre_reordering_num_neighbors=int(pre_k))
                    idx, _ = s.search_batched_arrays(queries, k, params)
                    rec = _recall(idx, gt)
                    mult = 2 if top2 else 1
                    cost = (n * (d + 8) * dtype_bytes / max(b, 1)
                            + (n / r) * 6 * mult
                            + pre_k * mult * d * 4)
                    knobs = dict(block_r=int(r), sweep_dtype=dtype,
                                 top2=bool(top2), pre_k=int(pre_k))
                    table.append((knobs, rec, cost))
            del s

    meeting = [t for t in table if t[1] >= target_recall]
    chosen = (min(meeting, key=lambda t: (t[2], -t[1])) if meeting
              else max(table, key=lambda t: (t[1], -t[2])))
    knobs, rec, _ = chosen
    cfg = BlockSweepConfig(
        distance_measure=measure, block_r=knobs["block_r"],
        sweep_dtype=knobs["sweep_dtype"], top2=knobs["top2"],
        pre_reorder_k=knobs["pre_k"])
    return SweepAutotuneResult(
        config=cfg,
        params=SearchParameters(pre_reordering_num_neighbors=knobs["pre_k"]),
        recall=rec, target_met=bool(meeting), table=table)
