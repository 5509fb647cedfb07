"""The plain reference: exact nearest neighbours and exact distances.

Plain PyTorch on the raw rows and queries the benchmark made, in blocks of
queries, float32 matrix products with TF32 off for the exact top-k and
float64 for the distance of each returned id. It imports nothing of the
program and takes nothing the program built.

Measures are named by the values of the configuration's
``distance_measure``: "DotProduct" ranks by the negated inner product,
"SquaredL2" by the squared Euclidean distance.
"""

from __future__ import annotations

from typing import Tuple

import torch

MEASURES = ("DotProduct", "SquaredL2")


def _check(measure: str) -> None:
    if measure not in MEASURES:
        raise ValueError(f"the reference has no measure {measure!r}")


def exact_precision() -> None:
    """Full float32 products: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def block_scores(measure: str, queries: torch.Tensor, rows: torch.Tensor,
                 rows_sq: torch.Tensor) -> torch.Tensor:
    """[B, N] float32 distances of a block of queries to every row."""
    dots = queries @ rows.T
    if measure == "DotProduct":
        return dots.neg_()
    q_sq = (queries * queries).sum(-1, keepdim=True)
    return dots.mul_(-2.0).add_(q_sq).add_(rows_sq)


def exact_top_k(rows: torch.Tensor, queries: torch.Tensor, k: int,
                measure: str, block: int = 1024
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids [Q, k] int64, distances [Q, k] float32) of the exact k nearest
    rows of each query, ascending."""
    _check(measure)
    exact_precision()
    rows_sq = (rows * rows).sum(-1)
    ids, dists = [], []
    for lo in range(0, queries.shape[0], block):
        d = block_scores(measure, queries[lo:lo + block], rows, rows_sq)
        v, i = torch.topk(d, k, dim=-1, largest=False, sorted=True)
        ids.append(i)
        dists.append(v)
        del d
    return torch.cat(ids), torch.cat(dists)


def distances_of(rows: torch.Tensor, queries: torch.Tensor,
                 ids: torch.Tensor, measure: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distance, scale) [B, k] float64 of each query to the rows ``ids``
    [B, k] names: the exact distance, and the size it is judged against
    (|q|^2 + |x|^2 for squared L2, |q| |x| for the inner product)."""
    _check(measure)
    x = rows[ids].double()                                   # [B, k, D]
    q = queries.double()[:, None, :]
    if measure == "DotProduct":
        dist = -(q * x).sum(-1)
        scale = q.norm(dim=-1) * x.norm(dim=-1)
    else:
        dist = ((q - x) ** 2).sum(-1)
        scale = (q * q).sum(-1) + (x * x).sum(-1)
    return dist, scale.clamp_min(1e-30)
