"""Bitset allow / deny lists and token maps (counterpart of
``scann_tpu/restricts/allowlist.py``).

Backed by numpy bool arrays, the allow masks' own form, so ``to_mask``
is a copy.
"""


from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np


class RestrictAllowlist:
    """Whitelist bitset."""

    def __init__(self, capacity: int):
        self._bits = np.zeros(int(capacity), dtype=bool)

    @classmethod
    def from_indices(cls, indices: Iterable[int], capacity: int) -> "RestrictAllowlist":
        a = cls(capacity)
        idx = np.asarray(list(indices), dtype=np.int64)
        idx = idx[(idx >= 0) & (idx < capacity)]
        a._bits[idx] = True
        return a

    @classmethod
    def from_set(cls, s, capacity: int) -> "RestrictAllowlist":
        return cls.from_indices(s, capacity)

    def add(self, index: int) -> None:
        if 0 <= index < len(self._bits):
            self._bits[index] = True

    def remove(self, index: int) -> None:
        if 0 <= index < len(self._bits):
            self._bits[index] = False

    def is_allowed(self, index: int) -> bool:
        return bool(0 <= index < len(self._bits) and self._bits[index])

    def indices(self) -> List[int]:
        return np.nonzero(self._bits)[0].tolist()

    def clear(self) -> None:
        self._bits[:] = False

    @property
    def capacity(self) -> int:
        return len(self._bits)

    def count(self) -> int:
        return int(self._bits.sum())

    def to_mask(self, n: int) -> np.ndarray:
        if n <= len(self._bits):
            return self._bits[:n].copy()
        out = np.zeros(n, dtype=bool)
        out[: len(self._bits)] = self._bits
        return out


class RestrictDenylist:
    """Blacklist bitset — everything allowed unless denied."""

    def __init__(self, capacity: int):
        self._denied = np.zeros(int(capacity), dtype=bool)

    @classmethod
    def from_indices(cls, indices: Iterable[int], capacity: int) -> "RestrictDenylist":
        idx = np.asarray(list(indices), dtype=np.int64)
        idx = idx[idx >= 0]
        # same grow-past-capacity semantics as deny(): every listed index
        # is denied, even beyond the constructed capacity
        if len(idx):
            capacity = max(int(capacity), int(idx.max()) + 1)
        d = cls(capacity)
        d._denied[idx] = True
        return d

    def deny(self, index: int) -> None:
        if index < 0:
            return
        if index >= len(self._denied):
            # grow so points appended after construction can be denied
            grown = np.zeros(max(index + 1, 2 * len(self._denied)), bool)
            grown[: len(self._denied)] = self._denied
            self._denied = grown
        self._denied[index] = True

    def allow(self, index: int) -> None:
        if 0 <= index < len(self._denied):
            self._denied[index] = False

    def is_allowed(self, index: int) -> bool:
        """Everything is allowed unless explicitly denied — including
        indices beyond the constructed capacity (e.g. points appended to
        the dataset after the denylist was built)."""
        if 0 <= index < len(self._denied):
            return bool(not self._denied[index])
        return True

    def clear(self) -> None:
        self._denied[:] = False

    @property
    def capacity(self) -> int:
        return len(self._denied)

    def to_mask(self, n: int) -> np.ndarray:
        # never-denied indices past the capacity stay allowed (True)
        out = np.ones(n, dtype=bool)
        m = min(n, len(self._denied))
        out[:m] = ~self._denied[:m]
        return out


class SparseAllowlist:
    """Set-backed allowlist for sparse selections."""

    def __init__(self):
        self._set = set()

    @classmethod
    def from_indices(cls, indices: Iterable[int]) -> "SparseAllowlist":
        s = cls()
        s._set = set(int(i) for i in indices)
        return s

    def add(self, index: int) -> None:
        self._set.add(int(index))

    def remove(self, index: int) -> None:
        self._set.discard(int(index))

    def is_allowed(self, index: int) -> bool:
        return int(index) in self._set

    def indices(self):
        return iter(sorted(self._set))

    def to_mask(self, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=bool)
        idx = np.asarray([i for i in self._set if 0 <= i < n], dtype=np.int64)
        out[idx] = True
        return out


class RestrictTokenMap:
    """token -> datapoint indices map."""

    def __init__(self, num_datapoints: int):
        self.num_datapoints = int(num_datapoints)
        self._token_to_indices: Dict[int, List[int]] = {}

    def add_token(self, index: int, token: int) -> None:
        self._token_to_indices.setdefault(int(token), []).append(int(index))

    def set_tokens(self, index: int, tokens: Iterable[int]) -> None:
        for t in tokens:
            self.add_token(index, t)

    def get_indices(self, token: int):
        return self._token_to_indices.get(int(token))

    @property
    def num_tokens(self) -> int:
        return len(self._token_to_indices)

    def create_allowlist(self, tokens: Iterable[int]) -> RestrictAllowlist:
        out = RestrictAllowlist(self.num_datapoints)
        for t in tokens:
            for i in self._token_to_indices.get(int(t), ()):
                out.add(i)
        return out
