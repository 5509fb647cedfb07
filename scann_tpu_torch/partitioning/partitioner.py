"""Partition tables (counterpart of ``scann_tpu/partitioning/partitioner.py``).

CSR layout: ``offsets [K+1]`` + ``point_indices [N]`` (points sorted by
token, stable) + ``partition_sizes [K]``. One assignment per point: the JAX
package's ``extra_pairs`` (spilling) waits for ROADMAP.md queue 1, item 3.
"""

from __future__ import annotations

import torch

from scann_tpu_torch.errors import ScannError


class DatabaseTokenization:
    """Token assignment tables, int64 tensors on the tokens' device."""

    def __init__(self, tokens: torch.Tensor, num_partitions: int):
        tokens = torch.as_tensor(tokens).long()
        self.tokens = tokens
        self.num_partitions = int(num_partitions)
        if tokens.numel() and (int(tokens.min()) < 0
                               or int(tokens.max()) >= num_partitions):
            raise ScannError.invalid_argument(
                f"tokens must lie in [0, {num_partitions}); got range "
                f"[{int(tokens.min())}, {int(tokens.max())}]")
        counts = torch.bincount(tokens, minlength=self.num_partitions)
        self.offsets = torch.zeros(self.num_partitions + 1, dtype=torch.int64,
                                   device=tokens.device)
        torch.cumsum(counts, 0, out=self.offsets[1:])
        self.point_indices = torch.argsort(tokens, stable=True)
        self.partition_sizes = counts

    @classmethod
    def from_csr(cls, tokens: torch.Tensor, offsets: torch.Tensor,
                 point_indices: torch.Tensor) -> "DatabaseTokenization":
        """Rebuild from saved CSR arrays. Only single-assignment tables are
        accepted: a point listed twice means the index was built with
        spilling."""
        self = cls.__new__(cls)
        self.tokens = torch.as_tensor(tokens).long()
        self.offsets = torch.as_tensor(offsets).long().to(self.tokens.device)
        self.point_indices = torch.as_tensor(point_indices).long().to(
            self.tokens.device)
        self.num_partitions = len(self.offsets) - 1
        self.partition_sizes = torch.diff(self.offsets)
        if len(self.point_indices) != len(self.tokens):
            raise NotImplementedError(
                "multi-assignment (spilled) tokenization is not ported yet "
                "(ROADMAP.md queue 1, item 3: spilling and SOAR)")
        return self

    @property
    def max_partition_size(self) -> int:
        return (int(self.partition_sizes.max())
                if len(self.partition_sizes) else 0)

    def partition_indices(self, token: int) -> torch.Tensor:
        """Point indices in one partition."""
        lo, hi = int(self.offsets[token]), int(self.offsets[token + 1])
        return self.point_indices[lo:hi]
