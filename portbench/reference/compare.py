"""The comparison that decides ``correct``.

It judges every answer the window served, once the window has closed,
against the plain reference (``exact.py``) on the same rows and queries:

- ``invalid``: result slots with no row (an id outside [0, N), or missing
  because fewer than k came back) or a distance that is not finite;
- ``duplicates``: ids returned twice for one query;
- ``disorder``: neighbouring results whose distances fall;
- ``dist_gap``: the largest gap between a returned distance and the
  reference's float64 distance of the returned id, as a share of the
  distance's scale (``exact.distances_of``): the configurations state an
  exact float32 re-rank;
- ``recall``: the mean share of each query's exact k nearest found,
  against the floor the configuration states.

The first three must be 0, ``dist_gap`` must not pass its limit and
``recall`` must not fall below its floor. A query counts as failed where
one of its slots breaks the first four.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from portbench.reference.exact import distances_of, exact_top_k
from portbench.stats import hits


@dataclasses.dataclass
class Verdict:
    numbers: Dict[str, dict]   # name -> {"value", "limit", "must_be"}
    failed: int                # queries with a faulty answer
    attempted: int             # queries judged
    recall: float

    @property
    def correct(self) -> bool:
        for n in self.numbers.values():
            v, lim = n["value"], n["limit"]
            if not (v >= lim if n["must_be"] == ">=" else v <= lim):
                return False
        return True


def _padded(ids: torch.Tensor, dists: torch.Tensor, b: int, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[b, k] answers; rows or columns that did not come back are
    (-1, nan)."""
    out_i = torch.full((b, k), -1, dtype=torch.int64, device=ids.device)
    out_d = torch.full((b, k), float("nan"), dtype=torch.float64,
                       device=ids.device)
    rb, rk = min(ids.shape[0], b), min(ids.shape[-1], k)
    out_i[:rb, :rk] = ids[:rb, :rk].long()
    out_d[:rb, :rk] = dists[:rb, :rk].double()
    return out_i, out_d


def judge(served: List[Tuple[int, torch.Tensor, torch.Tensor]],
          batches: List[torch.Tensor], rows: torch.Tensor, *, k: int,
          measure: str, gap_limit: float, recall_floor: float) -> Verdict:
    """Judge ``served``, the window's (slice, ids, distances) answers on the
    host, for the query ``batches`` of the slices over ``rows`` (all on the
    reference's device)."""
    dev, n = rows.device, rows.shape[0]
    gt = {}
    invalid = duplicates = disorder = failed = attempted = 0
    gap, found = 0.0, 0
    for s, ids_h, dists_h in served:
        q = batches[s]
        b = q.shape[0]
        if s not in gt:
            gt[s] = exact_top_k(rows, q, k, measure)[0]
        ids, dists = _padded(ids_h.to(dev), dists_h.to(dev), b, k)
        bad = (ids < 0) | (ids >= n) | ~torch.isfinite(dists)
        srt = ids.sort(dim=-1).values
        dup = torch.zeros_like(bad)
        dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        fall = torch.zeros_like(bad)
        fall[:, 1:] = dists[:, 1:] < dists[:, :-1]
        ref, scale = distances_of(rows, q, ids.clamp(0, n - 1), measure)
        gaps = torch.where(bad, 0.0, (dists - ref).abs() / scale)
        row_bad = (bad | dup | fall | (gaps > gap_limit)).any(-1)
        invalid += int(bad.sum())
        duplicates += int(dup.sum())
        disorder += int(fall.sum())
        gap = max(gap, float(gaps.max()))
        failed += int(row_bad.sum())
        attempted += b
        found += int(hits(ids, gt[s]).sum())
    recall = found / max(attempted * k, 1)
    numbers = {
        "invalid": {"value": invalid, "limit": 0, "must_be": "<="},
        "duplicates": {"value": duplicates, "limit": 0, "must_be": "<="},
        "disorder": {"value": disorder, "limit": 0, "must_be": "<="},
        "dist_gap": {"value": gap, "limit": gap_limit, "must_be": "<="},
        "recall": {"value": recall, "limit": recall_floor, "must_be": ">="},
    }
    return Verdict(numbers=numbers, failed=failed, attempted=attempted,
                   recall=recall)
