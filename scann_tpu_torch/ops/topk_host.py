"""Host-side top-k structures (counterpart of
``scann_tpu/ops/topk_host.py``): a heap, a fixed-capacity sorted array and
a flat buffer with an epsilon threshold, for host merging, streaming use
and parity tests. The searchers select on the device (``ops/topk.py``).
"""


from __future__ import annotations

import heapq
from typing import List, Tuple


class TopK:
    """Max-heap keeping the k smallest distances."""

    def __init__(self, k: int):
        self.k = int(k)
        self._heap: List[Tuple[float, int]] = []  # (-dist, idx)

    def push(self, index: int, distance: float) -> None:
        if self.k <= 0:
            return
        if len(self._heap) < self.k:
            heapq.heappush(self._heap, (-distance, index))
        elif distance < -self._heap[0][0]:
            heapq.heapreplace(self._heap, (-distance, index))

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def threshold(self) -> float:
        """Current worst kept distance (inf until full)."""
        if len(self._heap) < self.k:
            return float("inf")
        return -self._heap[0][0]

    def drain_sorted(self) -> List[Tuple[int, float]]:
        out = sorted(((idx, -nd) for nd, idx in self._heap), key=lambda p: (p[1], p[0]))
        self._heap = []
        return out


class FixedTopK:
    """Fixed-capacity insertion-sorted array for small k."""

    def __init__(self, k: int):
        self.k = int(k)
        self._idx: List[int] = []
        self._dist: List[float] = []

    def push(self, index: int, distance: float) -> None:
        if self.k <= 0:
            return
        if len(self._idx) == self.k and distance >= self._dist[-1]:
            return
        lo, hi = 0, len(self._dist)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._dist[mid] <= distance:
                lo = mid + 1
            else:
                hi = mid
        self._idx.insert(lo, index)
        self._dist.insert(lo, distance)
        if len(self._idx) > self.k:
            self._idx.pop()
            self._dist.pop()

    def __len__(self) -> int:
        return len(self._idx)

    @property
    def threshold(self) -> float:
        return self._dist[-1] if len(self._idx) == self.k else float("inf")

    def results(self) -> List[Tuple[int, float]]:
        return list(zip(self._idx, self._dist))


class FastTopNeighbors:
    """Flat buffer with epsilon threshold."""

    def __init__(self, k: int, epsilon: float = float("inf")):
        self.k = int(k)
        self.epsilon = float(epsilon)
        self._pairs: List[Tuple[float, int]] = []
        self._threshold = float(epsilon)

    def push(self, index: int, distance: float) -> None:
        if distance > self._threshold:
            return
        self._pairs.append((distance, index))
        # amortized prune at 2k occupancy
        if len(self._pairs) >= max(2 * self.k, 32):
            self._prune()

    def push_batch(self, indices, distances) -> None:
        for i, d in zip(indices, distances):
            self.push(int(i), float(d))

    def _prune(self) -> None:
        self._pairs.sort()
        del self._pairs[self.k :]
        if len(self._pairs) == self.k:
            self._threshold = min(self.epsilon, self._pairs[-1][0])

    @property
    def threshold(self) -> float:
        return self._threshold

    def results(self) -> List[Tuple[int, float]]:
        self._pairs.sort()
        return [(i, d) for d, i in self._pairs[: self.k]]
