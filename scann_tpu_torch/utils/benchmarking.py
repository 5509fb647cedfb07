"""Benchmark helpers (counterpart of ``scann_tpu/utils/benchmarking.py``)."""

from __future__ import annotations

import numpy as np


def recall_at_k(idx, gt, k=10):
    """Mean fraction of the k true neighbors present per row."""
    return float(np.mean([len(set(map(int, a[:k])) & set(map(int, g[:k]))) / k
                          for a, g in zip(idx, gt)]))
