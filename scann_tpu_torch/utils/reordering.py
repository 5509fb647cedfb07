"""Exact re-rank helpers (counterpart of ``scann_tpu/utils/reordering.py``).

This slice holds the plain float32 re-rank store: a [N, D] float32 tensor
whose rows are gathered for the exact distances. The JAX package's
low-precision stores (bf16 rows, the int8 codec tuples, the id-embedded CSR
store) raise ``NotImplementedError`` until they are ported (ROADMAP.md
queue 1, item 3: rerank dtypes).
"""

from __future__ import annotations

import torch


def _check_plain_store(db_repr) -> torch.Tensor:
    if isinstance(db_repr, tuple) or db_repr.dtype != torch.float32:
        kind = "an int8 codec store" if isinstance(db_repr, tuple) else \
            f"a {db_repr.dtype} store"
        raise NotImplementedError(
            f"re-ranking from {kind} is not ported yet (ROADMAP.md queue 1, "
            f"item 3: rerank dtypes)")
    return db_repr


def gather_rerank_rows(db_repr: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """float32 candidate rows ``db_repr[idx]`` ([..., D]) from a float32
    re-rank store."""
    return _check_plain_store(db_repr)[idx]


def rerank_store_rows(db_repr: torch.Tensor) -> int:
    """Row count of a re-rank store."""
    return _check_plain_store(db_repr).shape[0]
