"""Batched distances as matrix products (counterpart of
``scann_tpu/ops/distances.py``).

    squared_l2(Q, D) = ||q||^2 + ||d||^2 - 2 Q @ D^T

The JAX package computes the exact stages at ``Precision.HIGHEST``; here the
float32 products run in full float32, which holds only while TF32 is off
(``torch.backends.cuda.matmul.allow_tf32``, PyTorch's default). Sign
conventions follow the reference: dot-product distance is the negated dot.

``many_to_many`` covers every dense measure (L1, HAMMING and
NON_ZERO_INTERSECT stream database chunks; JACCARD and DICE are squared L2
on dense rows, as in the reference); ``gathered_distances`` (the exact
re-rank) covers the measures the JAX package's does. WEIGHTED_JACCARD and
OVERLAP have no dense form: ``many_to_many`` raises ``NotImplementedError``
for them, as the JAX package's does, and ``SparseBruteForceSearcher``
(``models/sparse_brute_force.py``) serves them over sparse datasets. The
five ``*_sparse`` functions at the end score one pair of sparse points on
the host.
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

    @property
    def is_matmul_friendly(self) -> bool:
        """True when the [B, N] distance matrix reduces to one matrix
        product (dense Jaccard and Dice are squared L2)."""
        return self in (
            DistanceMeasure.SQUARED_L2,
            DistanceMeasure.L2,
            DistanceMeasure.COSINE,
            DistanceMeasure.DOT_PRODUCT,
            DistanceMeasure.GENERAL_INNER_PRODUCT,
            DistanceMeasure.LIMITED_INNER_PRODUCT,
            DistanceMeasure.JACCARD,
            DistanceMeasure.DICE,
        )


# measures with no dense form, served by SparseBruteForceSearcher
_SPARSE_ONLY = (DistanceMeasure.WEIGHTED_JACCARD, DistanceMeasure.OVERLAP)
# measures without a bilinear form, streamed over database chunks
_ELEMENTWISE = (DistanceMeasure.L1, DistanceMeasure.HAMMING,
                DistanceMeasure.NON_ZERO_INTERSECT)
# dense Jaccard and Dice are squared L2, as in the reference
_SQUARED_L2_LIKE = (DistanceMeasure.SQUARED_L2, DistanceMeasure.JACCARD,
                    DistanceMeasure.DICE)
_NEG_DOT = (DistanceMeasure.DOT_PRODUCT,
            DistanceMeasure.GENERAL_INNER_PRODUCT)


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
                 db_sq_norms: Optional[torch.Tensor] = None,
                 chunk_size: int = 4096) -> torch.Tensor:
    """[B, N] distances between ``queries`` [B, D] and ``db`` [N, D], for
    every dense measure. L1, HAMMING and NON_ZERO_INTERSECT have no bilinear
    form and stream the database in chunks of ``chunk_size`` rows; the
    others are one float32 product plus a score transform."""
    if measure in _SPARSE_ONLY:
        raise NotImplementedError(
            f"many_to_many for {measure}: a sparse measure with no dense "
            f"form; search a SparseDataset with SparseBruteForceSearcher")
    queries = queries.float()
    db = db.float()
    if measure in _ELEMENTWISE:
        return _chunked_elementwise(measure, queries, db, chunk_size)
    dots = queries @ db.T
    if measure in _NEG_DOT:
        return -dots
    if db_sq_norms is None:
        db_sq_norms = squared_norms(db)
    q_sq = squared_norms(queries)
    if measure in _SQUARED_L2_LIKE:
        return (q_sq[:, None] + db_sq_norms[None, :] - 2.0 * dots).clamp_min(
            0.0)
    if measure == DistanceMeasure.L2:
        return (q_sq[:, None] + db_sq_norms[None, :] - 2.0 * dots).clamp_min(
            0.0).sqrt()
    if measure == DistanceMeasure.COSINE:
        # zero-norm rows have similarity 0, distance 1
        denom = q_sq.sqrt()[:, None] * db_sq_norms.sqrt()[None, :]
        sim = torch.where(denom > 0.0, dots / denom.clamp_min(1e-30), 0.0)
        return 1.0 - sim
    # LIMITED_INNER_PRODUCT: +inf when either vector's squared norm is > 1
    bad = (q_sq[:, None] > 1.0) | (db_sq_norms[None, :] > 1.0)
    return torch.where(bad, float("inf"), -dots)


def _chunked_elementwise(measure: DistanceMeasure, queries: torch.Tensor,
                         db: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """L1, dense HAMMING (count of differing positions) and dense
    NON_ZERO_INTERSECT (minus the count of positions non-zero in both), one
    [B, chunk, D] intermediate at a time."""
    n = db.shape[0]
    out = torch.empty(queries.shape[0], n, dtype=torch.float32,
                      device=queries.device)
    q = queries[:, None, :]
    for lo in range(0, n, max(1, chunk_size)):
        c = db[None, lo:lo + chunk_size, :]
        if measure == DistanceMeasure.L1:
            part = (q - c).abs().sum(dim=-1)
        elif measure == DistanceMeasure.HAMMING:
            part = (q != c).float().sum(dim=-1)
        else:
            part = -((q != 0.0) & (c != 0.0)).float().sum(dim=-1)
        out[:, lo:lo + chunk_size] = part
    return out


def one_to_many(measure: DistanceMeasure, query: torch.Tensor,
                db: torch.Tensor,
                db_sq_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Distances [N] from one query [D] to all database rows."""
    return many_to_many(measure, query[None, :], db, db_sq_norms)[0]


def pairwise_distances(measure: DistanceMeasure,
                       data: torch.Tensor) -> torch.Tensor:
    """[N, N] all-pairs distances within one set."""
    return many_to_many(measure, data, data)


def one_to_one(measure: DistanceMeasure, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Scalar distance between two dense vectors."""
    return many_to_many(measure, a[None, :], b[None, :])[0, 0]


def mask_padded_rows(dists: torch.Tensor, n_valid: int,
                     masked_value: float) -> torch.Tensor:
    """``dists`` with columns >= ``n_valid`` set to ``masked_value``."""
    col = torch.arange(dists.shape[-1], device=dists.device)
    return torch.where(col < n_valid, dists,
                       torch.tensor(masked_value, dtype=dists.dtype,
                                    device=dists.device))


def gathered_distances(measure: DistanceMeasure, queries: torch.Tensor,
                       rows: torch.Tensor,
                       rows_sq_norms: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """[B, C] distances from each query to its own candidate rows
    ``rows`` [B, C, D] (the exact re-rank)."""
    queries = queries.float()
    rows = rows.float()
    if measure == DistanceMeasure.L1:
        return (queries[:, None, :] - rows).abs().sum(dim=-1)
    dots = torch.einsum("bd,bcd->bc", queries, rows)
    if measure in _NEG_DOT:
        return -dots
    if rows_sq_norms is None:
        rows_sq_norms = (rows * rows).sum(dim=-1)
    q_sq = squared_norms(queries)
    if measure == DistanceMeasure.COSINE:
        denom = q_sq.sqrt()[:, None] * rows_sq_norms.sqrt()
        sim = torch.where(denom > 0.0, dots / denom.clamp_min(1e-30), 0.0)
        return 1.0 - sim
    d = (q_sq[:, None] + rows_sq_norms - 2.0 * dots).clamp_min(0.0)
    if measure in _SQUARED_L2_LIKE:
        return d
    if measure == DistanceMeasure.L2:
        return d.sqrt()
    raise NotImplementedError(f"gathered_distances for {measure}")


# ---------------------------------------------------------------------------
# Sparse set distances of one pair of points (host)
# ---------------------------------------------------------------------------


def jaccard_distance_sparse(a_indices, b_indices) -> float:
    """1 - |A∩B| / |A∪B| over sparse index sets; 0.0 when both are
    empty."""
    a, b = set(map(int, a_indices)), set(map(int, b_indices))
    union = len(a | b)
    if union == 0:
        return 0.0
    return 1.0 - len(a & b) / union


def dice_distance_sparse(a_indices, b_indices) -> float:
    """1 - 2|A∩B| / (|A|+|B|) over sparse index sets; 0.0 when both are
    empty."""
    a, b = set(map(int, a_indices)), set(map(int, b_indices))
    total = len(a) + len(b)
    if total == 0:
        return 0.0
    return 1.0 - 2.0 * len(a & b) / total


def non_zero_intersect_sparse(a_indices, b_indices) -> float:
    """-|A∩B| (more overlap = closer)."""
    a, b = set(map(int, a_indices)), set(map(int, b_indices))
    return -float(len(a & b))


def weighted_jaccard_distance_sparse(a_values, a_indices,
                                     b_values, b_indices) -> float:
    """1 - Σ min(|aᵢ|,|bᵢ|) / Σ max(|aᵢ|,|bᵢ|) over weighted sparse vectors,
    values taken by absolute value; 0.0 when both are empty. A repeated
    index keeps its last value."""
    av = {int(i): abs(float(v)) for i, v in zip(a_indices, a_values)}
    bv = {int(i): abs(float(v)) for i, v in zip(b_indices, b_values)}
    min_sum = sum(min(av[i], bv[i]) for i in av.keys() & bv.keys())
    max_sum = sum(av.values()) + sum(bv.values()) - min_sum
    if max_sum == 0.0:
        return 0.0
    return 1.0 - min_sum / max_sum


def overlap_coefficient_sparse(a_indices, b_indices) -> float:
    """|A∩B| / min(|A|,|B|) (Szymkiewicz–Simpson), a SIMILARITY in [0, 1];
    0.0 when either set is empty. The searcher serves the distance
    1 - overlap, so smaller is closer."""
    a, b = set(map(int, a_indices)), set(map(int, b_indices))
    if not a or not b:
        return 0.0
    return len(a & b) / min(len(a), len(b))
