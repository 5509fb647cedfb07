"""Batched distances as matrix products (counterpart of
``scann_tpu/ops/distances.py``).

    squared_l2(Q, D) = ||q||^2 + ||d||^2 - 2 Q @ D^T

The JAX package computes the exact stages at ``Precision.HIGHEST``; here the
float32 products run in full float32, which holds only while TF32 is off
(``torch.backends.cuda.matmul.allow_tf32``, PyTorch's default). Sign
conventions follow the reference: dot-product distance is the negated dot.

``many_to_many`` covers SQUARED_L2 and DOT_PRODUCT; ``gathered_distances``
(the exact re-rank) adds COSINE and GENERAL_INNER_PRODUCT, the four measures
the block sweep serves. The other measures raise ``NotImplementedError``
until they are ported (ROADMAP.md queue 1, item 4).
"""

from __future__ import annotations

import enum
from typing import Optional

import torch


class DistanceMeasure(enum.Enum):
    """The reference's distance measures (same values as the JAX package's
    enum, so saved index metadata round-trips)."""

    L1 = "L1"
    L2 = "L2"
    SQUARED_L2 = "SquaredL2"
    COSINE = "Cosine"
    DOT_PRODUCT = "DotProduct"
    HAMMING = "Hamming"
    LIMITED_INNER_PRODUCT = "LimitedInnerProduct"
    GENERAL_INNER_PRODUCT = "GeneralInnerProduct"
    JACCARD = "Jaccard"
    NON_ZERO_INTERSECT = "NonZeroIntersect"
    DICE = "Dice"
    WEIGHTED_JACCARD = "WeightedJaccard"
    OVERLAP = "Overlap"


_PORTED = (DistanceMeasure.SQUARED_L2, DistanceMeasure.DOT_PRODUCT)
_PORTED_GATHERED = _PORTED + (DistanceMeasure.COSINE,
                              DistanceMeasure.GENERAL_INNER_PRODUCT)


def _check_ported(measure: DistanceMeasure, fn: str,
                  ported=_PORTED) -> None:
    if measure not in ported:
        raise NotImplementedError(
            f"{fn} for {measure} is not ported yet (ROADMAP.md queue 1, "
            f"item 4: all distance measures)")


def approx_to_measure_units(approx: torch.Tensor,
                            measure: DistanceMeasure) -> torch.Tensor:
    """Approximate (LUT) scores in the measure's own units: COSINE LUT scores
    are squared L2 on unit vectors, twice the cosine distance; every other
    measure's LUT scores are already in its units."""
    if measure == DistanceMeasure.COSINE:
        return approx * 0.5
    return approx


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, float32 accumulation."""
    x = x.float()
    return (x * x).sum(dim=-1)


def many_to_many(measure: DistanceMeasure, queries: torch.Tensor,
                 db: torch.Tensor,
                 db_sq_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, N] distances between ``queries`` [B, D] and ``db`` [N, D]."""
    _check_ported(measure, "many_to_many")
    queries = queries.float()
    db = db.float()
    dots = queries @ db.T
    if measure == DistanceMeasure.DOT_PRODUCT:
        return -dots
    if db_sq_norms is None:
        db_sq_norms = squared_norms(db)
    d = squared_norms(queries)[:, None] + db_sq_norms[None, :] - 2.0 * dots
    return d.clamp_min(0.0)


def gathered_distances(measure: DistanceMeasure, queries: torch.Tensor,
                       rows: torch.Tensor,
                       rows_sq_norms: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """[B, C] distances from each query to its own candidate rows
    ``rows`` [B, C, D] (the exact re-rank)."""
    _check_ported(measure, "gathered_distances", _PORTED_GATHERED)
    queries = queries.float()
    rows = rows.float()
    dots = torch.einsum("bd,bcd->bc", queries, rows)
    if measure in (DistanceMeasure.DOT_PRODUCT,
                   DistanceMeasure.GENERAL_INNER_PRODUCT):
        return -dots
    if rows_sq_norms is None:
        rows_sq_norms = (rows * rows).sum(dim=-1)
    q_sq = squared_norms(queries)
    if measure == DistanceMeasure.COSINE:
        denom = q_sq.sqrt()[:, None] * rows_sq_norms.sqrt()
        sim = torch.where(denom > 0.0, dots / denom.clamp_min(1e-30), 0.0)
        return 1.0 - sim
    return (q_sq[:, None] + rows_sq_norms - 2.0 * dots).clamp_min(0.0)
