"""Arithmetic of the metrics: percentiles, recall, busy intervals."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch


def percentile(values: Sequence[float], pct: int) -> float:
    """The ``pct``-th percentile, linear between the order statistics
    (``statistics.quantiles(..., method="inclusive")``, numpy's default)."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100,
                                      method="inclusive")[pct - 1])


def recall_at_k(idx, gt, k=10):
    """Mean fraction of the k true neighbors present per row (a frozen copy
    of ``scann_tpu_torch.utils.benchmarking.recall_at_k``)."""
    return float(np.mean([len(set(map(int, a[:k])) & set(map(int, g[:k])))
                          / k for a, g in zip(idx, gt)]))


def hits(ids: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """[B] true neighbours found a row: the ids of ``gt`` [B, k] (distinct)
    that ``ids`` [B, k] holds; ``recall_at_k`` is their mean over k."""
    return (gt[:, :, None] == ids[:, None, :]).any(-1).sum(-1)


def union_length(intervals: Iterable[Tuple[int, int]], lo: int, hi: int
                 ) -> int:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals: Iterable[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end and end < hi:
            out.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out
