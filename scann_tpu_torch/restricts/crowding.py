"""Crowding: a cap on the results that share a group attribute
(counterpart of ``scann_tpu/restricts/crowding.py``).

A host pass over sorted candidate lists: they are k-sized, so it is O(k) a
query. To keep k results under crowding, searchers over-fetch (k *
over_fetch) candidates before the pass.
"""


from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CrowdingConfig:
    """The per-group cap and whether crowding applies."""

    per_crowd_limit: int = 2**63 - 1
    enabled: bool = False


def apply_crowding(indices: np.ndarray, dists: np.ndarray,
                   attributes: np.ndarray, per_crowd_limit: int,
                   k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized batch crowding pass.

    Args:
        indices: [B, M] sorted candidate indices (-1 = missing).
        dists: [B, M].
        attributes: [N] per-datapoint group ids.
        per_crowd_limit: max results per group.
        k: results to keep.

    Returns ([B, k] indices, [B, k] dists), -1/inf padded.
    """
    b, m = indices.shape
    out_idx = np.full((b, k), -1, dtype=indices.dtype)
    out_dist = np.full((b, k), np.inf, dtype=np.float32)
    for bi in range(b):
        counts: Dict[int, int] = {}
        w = 0
        for j in range(m):
            i = int(indices[bi, j])
            if i < 0:
                continue
            a = int(attributes[i]) if i < len(attributes) else 0
            c = counts.get(a, 0)
            if c < per_crowd_limit:
                counts[a] = c + 1
                out_idx[bi, w] = i
                out_dist[bi, w] = dists[bi, j]
                w += 1
                if w >= k:
                    break
    return out_idx, out_dist


class CrowdingConstraint:
    """One group attribute per datapoint and a cap per group."""

    def __init__(self, crowding_attributes: Sequence[int],
                 config: Optional[CrowdingConfig] = None):
        self.attributes = np.asarray(list(crowding_attributes), dtype=np.int64)
        self.config = config or CrowdingConfig()

    def get_attribute(self, index: int) -> Optional[int]:
        if 0 <= index < len(self.attributes):
            return int(self.attributes[index])
        return None

    def set_attribute(self, index: int, attribute: int) -> None:
        if index >= len(self.attributes):
            self.attributes = np.concatenate(
                [self.attributes, np.zeros(index + 1 - len(self.attributes), np.int64)])
        self.attributes[index] = attribute

    def apply(self, results: List[Tuple[int, float]], k: int) -> List[Tuple[int, float]]:
        """Filter a sorted (index, dist) list."""
        if not self.config.enabled:
            return list(results[:k])
        counts: Dict[int, int] = {}
        out = []
        for idx, dist in results:
            a = self.get_attribute(idx) or 0
            c = counts.get(a, 0)
            if c < self.config.per_crowd_limit:
                counts[a] = c + 1
                out.append((idx, dist))
                if len(out) >= k:
                    break
        return out

    def would_violate(self, index: int, current: List[Tuple[int, float]]) -> bool:
        if not self.config.enabled:
            return False
        a = self.get_attribute(index) or 0
        count = sum(1 for i, _ in current if (self.get_attribute(i) or 0) == a)
        return count >= self.config.per_crowd_limit

    def apply_batch(self, indices: np.ndarray, dists: np.ndarray, k: int):
        if not self.config.enabled:
            return indices[:, :k], dists[:, :k]
        return apply_crowding(indices, dists, self.attributes,
                              self.config.per_crowd_limit, k)


class CrowdingMultidimensional:
    """Multiple attribute dimensions, each with its own limit."""

    def __init__(self, num_dimensions: int, num_datapoints: int):
        self.attributes = np.zeros((num_dimensions, num_datapoints), dtype=np.int64)
        self.limits = [2**63 - 1] * num_dimensions

    def set_attribute(self, dim: int, index: int, attribute: int) -> None:
        self.attributes[dim, index] = attribute

    def set_limit(self, dim: int, limit: int) -> None:
        self.limits[dim] = int(limit)

    def apply(self, results: List[Tuple[int, float]], k: int) -> List[Tuple[int, float]]:
        counts: List[Dict[int, int]] = [{} for _ in range(self.attributes.shape[0])]
        out = []
        for idx, dist in results:
            ok = True
            for d in range(self.attributes.shape[0]):
                a = int(self.attributes[d, idx]) if idx < self.attributes.shape[1] else 0
                if counts[d].get(a, 0) >= self.limits[d]:
                    ok = False
                    break
            if ok:
                for d in range(self.attributes.shape[0]):
                    a = int(self.attributes[d, idx]) if idx < self.attributes.shape[1] else 0
                    counts[d][a] = counts[d].get(a, 0) + 1
                out.append((idx, dist))
                if len(out) >= k:
                    break
        return out
