"""Dataset statistics for quantizer calibration (counterpart of
``scann_tpu/quantization/stats.py``).

float64 host statistics: min, max, mean and the *sample* standard deviation
(divide by count - 1), as the JAX package computes them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class QuantizationStats:
    min_value: float = 0.0
    max_value: float = 0.0
    mean: float = 0.0
    std_dev: float = 0.0

    @classmethod
    def from_array(cls, data: np.ndarray) -> "QuantizationStats":
        flat = np.asarray(data, dtype=np.float32).ravel()
        if flat.size == 0:
            return cls()
        acc = flat.astype(np.float64)
        mean = float(acc.mean())
        if flat.size > 1:
            var = float(((acc * acc).sum() - acc.sum() ** 2 / flat.size)
                        / (flat.size - 1))
        else:
            var = 0.0
        return cls(min_value=float(flat.min()), max_value=float(flat.max()),
                   mean=mean, std_dev=float(np.sqrt(max(var, 0.0))))

    @classmethod
    def from_dataset(cls, dataset) -> "QuantizationStats":
        return cls.from_array(dataset.numpy())
