"""Seeded sampling on the host from ``np.random.default_rng`` (counterpart
of ``scann_tpu/utils/random.py``; reference: src/utils/random.rs:7-180)."""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np


class RandomSampler:
    """(reference: random.rs:7-68)."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)

    @classmethod
    def with_seed(cls, seed: int) -> "RandomSampler":
        return cls(seed)

    def sample_indices(self, n: int, k: int) -> np.ndarray:
        """k distinct indices from [0, n) (k clamped to n)."""
        k = min(k, n)
        return self._rng.choice(n, size=k, replace=False)

    def sample_with_replacement(self, n: int, k: int) -> np.ndarray:
        return self._rng.integers(0, n, size=k)

    def random_f32(self) -> float:
        return float(self._rng.random(dtype=np.float32))

    def shuffle(self, items: List) -> List:
        self._rng.shuffle(items)
        return items


class ReservoirSampler:
    """Streaming reservoir sampling (reference: random.rs:70-130)."""

    def __init__(self, capacity: int, seed: Optional[int] = None):
        self.capacity = int(capacity)
        self._rng = np.random.default_rng(seed)
        self._items: List = []
        self._seen = 0

    def add(self, item) -> None:
        self._seen += 1
        if len(self._items) < self.capacity:
            self._items.append(item)
        else:
            j = int(self._rng.integers(0, self._seen))
            if j < self.capacity:
                self._items[j] = item

    def extend(self, items: Iterable) -> None:
        for it in items:
            self.add(it)

    @property
    def items(self) -> List:
        return list(self._items)

    @property
    def seen(self) -> int:
        return self._seen
