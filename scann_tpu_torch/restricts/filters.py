"""Composable restrict filters (counterpart of
``scann_tpu/restricts/filters.py``).

Every filter has the scalar predicate (``is_allowed``) and a vectorized
form (``to_mask(n) -> np.ndarray[bool]``) that the searchers take as an
allow mask. And / or / not compose the masks.
"""


from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


class RestrictFilter:
    """Base filter."""

    def is_allowed(self, index: int) -> bool:
        raise NotImplementedError

    def to_mask(self, n: int) -> np.ndarray:
        """[n] bool allow mask, the form the searchers take."""
        return np.fromiter((self.is_allowed(i) for i in range(n)), dtype=bool, count=n)


class NoRestrict(RestrictFilter):
    """Allows everything."""

    def is_allowed(self, index: int) -> bool:
        return True

    def to_mask(self, n: int) -> np.ndarray:
        return np.ones(n, dtype=bool)


class PredicateFilter(RestrictFilter):
    """Arbitrary predicate."""

    def __init__(self, predicate: Callable[[int], bool]):
        self.predicate = predicate

    def is_allowed(self, index: int) -> bool:
        return bool(self.predicate(index))


class RangeFilter(RestrictFilter):
    """Allow [start, end)."""

    def __init__(self, start: int, end: int):
        self.start, self.end = int(start), int(end)

    def is_allowed(self, index: int) -> bool:
        return self.start <= index < self.end

    def to_mask(self, n: int) -> np.ndarray:
        m = np.zeros(n, dtype=bool)
        m[max(self.start, 0) : max(min(self.end, n), 0)] = True
        return m


class AndFilter(RestrictFilter):
    """Allowed by every filter."""

    def __init__(self, filters: Sequence[RestrictFilter] = ()):
        self.filters: List[RestrictFilter] = list(filters)

    def add(self, f: RestrictFilter) -> "AndFilter":
        self.filters.append(f)
        return self

    def is_allowed(self, index: int) -> bool:
        return all(f.is_allowed(index) for f in self.filters)

    def to_mask(self, n: int) -> np.ndarray:
        m = np.ones(n, dtype=bool)
        for f in self.filters:
            m &= f.to_mask(n)
        return m


class OrFilter(RestrictFilter):
    """Allowed by any filter (everything when there is none)."""

    def __init__(self, filters: Sequence[RestrictFilter] = ()):
        self.filters: List[RestrictFilter] = list(filters)

    def add(self, f: RestrictFilter) -> "OrFilter":
        self.filters.append(f)
        return self

    def is_allowed(self, index: int) -> bool:
        if not self.filters:
            return True
        return any(f.is_allowed(index) for f in self.filters)

    def to_mask(self, n: int) -> np.ndarray:
        if not self.filters:
            return np.ones(n, dtype=bool)
        m = np.zeros(n, dtype=bool)
        for f in self.filters:
            m |= f.to_mask(n)
        return m


class NotFilter(RestrictFilter):
    """Allowed where the inner filter disallows."""

    def __init__(self, inner: RestrictFilter):
        self.inner = inner

    def is_allowed(self, index: int) -> bool:
        return not self.inner.is_allowed(index)

    def to_mask(self, n: int) -> np.ndarray:
        return ~self.inner.to_mask(n)


class AllowlistFilter(RestrictFilter):
    """Filter backed by a RestrictAllowlist bitset."""

    def __init__(self, allowlist):
        self.allowlist = allowlist

    def is_allowed(self, index: int) -> bool:
        return self.allowlist.is_allowed(index)

    def to_mask(self, n: int) -> np.ndarray:
        return self.allowlist.to_mask(n)


class DenylistFilter(RestrictFilter):
    """Filter backed by a RestrictDenylist bitset."""

    def __init__(self, denylist):
        self.denylist = denylist

    def is_allowed(self, index: int) -> bool:
        return self.denylist.is_allowed(index)

    def to_mask(self, n: int) -> np.ndarray:
        return self.denylist.to_mask(n)
