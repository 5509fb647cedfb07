"""Partition tables (counterpart of ``scann_tpu/partitioning/partitioner.py``).

CSR layout: ``offsets [K+1]`` + ``point_indices [M]`` (assignments sorted by
token, stable) + ``partition_sizes [K]``. With spilling a point is assigned
to several partitions: ``extra_pairs`` rows (point, token) add assignments
after the primary one, so M >= N.
"""

from __future__ import annotations

from typing import Optional

import torch

from scann_tpu_torch.errors import ScannError


class DatabaseTokenization:
    """Token assignment tables, int64 tensors on the tokens' device."""

    def __init__(self, tokens: torch.Tensor, num_partitions: int,
                 extra_pairs: Optional[torch.Tensor] = None):
        tokens = torch.as_tensor(tokens).long()
        self.tokens = tokens
        self.num_partitions = int(num_partitions)
        pts = torch.arange(len(tokens), device=tokens.device)
        toks = tokens
        if extra_pairs is not None and len(extra_pairs):
            extra_pairs = torch.as_tensor(extra_pairs).long().to(
                tokens.device)
            pts = torch.cat([pts, extra_pairs[:, 0]])
            toks = torch.cat([toks, extra_pairs[:, 1]])
        if toks.numel() and (int(toks.min()) < 0
                             or int(toks.max()) >= num_partitions):
            raise ScannError.invalid_argument(
                f"tokens must lie in [0, {num_partitions}); got range "
                f"[{int(toks.min())}, {int(toks.max())}]")
        counts = torch.bincount(toks, minlength=self.num_partitions)
        self.offsets = torch.zeros(self.num_partitions + 1, dtype=torch.int64,
                                   device=tokens.device)
        torch.cumsum(counts, 0, out=self.offsets[1:])
        self.point_indices = pts[torch.argsort(toks, stable=True)]
        self.partition_sizes = counts
        self._max_multiplicity: Optional[int] = None

    @classmethod
    def from_csr(cls, tokens: torch.Tensor, offsets: torch.Tensor,
                 point_indices: torch.Tensor) -> "DatabaseTokenization":
        """Rebuild from saved CSR arrays; multi-assignment (spilled) tables
        keep every assignment, which the primary tokens alone cannot
        encode."""
        self = cls.__new__(cls)
        self.tokens = torch.as_tensor(tokens).long()
        self.offsets = torch.as_tensor(offsets).long().to(self.tokens.device)
        self.point_indices = torch.as_tensor(point_indices).long().to(
            self.tokens.device)
        self.num_partitions = len(self.offsets) - 1
        self.partition_sizes = torch.diff(self.offsets)
        self._max_multiplicity = None
        return self

    @property
    def max_partition_size(self) -> int:
        return (int(self.partition_sizes.max())
                if len(self.partition_sizes) else 0)

    @property
    def max_multiplicity(self) -> int:
        """Most partitions any one point is assigned to (1 without
        spilling). Searchers over-select by this factor and dedup."""
        if self._max_multiplicity is None:
            self._max_multiplicity = (
                int(torch.bincount(self.point_indices).max())
                if len(self.point_indices) else 1)
        return self._max_multiplicity

    def partition_indices(self, token: int) -> torch.Tensor:
        """Point indices in one partition."""
        lo, hi = int(self.offsets[token]), int(self.offsets[token + 1])
        return self.point_indices[lo:hi]
