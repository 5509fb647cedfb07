"""bfloat16 dataset (counterpart of ``scann_tpu/quantization/bfloat16.py``):
a dataset stored as bf16 (2x compression), converted with PyTorch's own
bf16 cast (round to nearest even, the same bytes as the JAX package's
``ml_dtypes`` cast of float32 values)."""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import _canonical
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.types import require_device


def float64_sq_norms(rows: torch.Tensor) -> torch.Tensor:
    """Squared norms [N] float32 of stored low-precision rows, summed in
    float64 on the host, as the JAX package computes them."""
    f64 = rows.double()
    return (f64 * f64).sum(dim=1).float()


class BFloat16Dataset:
    """[N, D] bf16 dataset: a host tensor plus one cached device copy."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data)
        if data.ndim != 2:
            raise ScannError.invalid_argument("expected [N, D]")
        self._data = torch.from_numpy(
            np.ascontiguousarray(data)).to(torch.bfloat16)
        self._device_cache = None

    @classmethod
    def from_f32(cls, data: np.ndarray) -> "BFloat16Dataset":
        return cls(np.asarray(data, dtype=np.float32))

    @property
    def size(self) -> int:
        return self._data.shape[0]

    @property
    def dimensionality(self) -> int:
        return self._data.shape[1]

    def to_f32(self) -> np.ndarray:
        return self._data.float().numpy()

    def get(self, index: int) -> np.ndarray:
        return self._data[index].float().numpy()

    def memory_usage_bytes(self) -> int:
        return self._data.numel() * 2

    def compression_ratio(self) -> float:
        return 2.0

    def device(self, device: Union[str, torch.device]
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(codes [N, D] bf16, squared norms [N] float32, N) on ``device``,
        cached."""
        device = require_device(device)
        cached = self._device_cache
        if cached is None or cached[0].device != _canonical(device):
            self._device_cache = (self._data.to(device),
                                  float64_sq_norms(self._data).to(device))
        return self._device_cache[0], self._device_cache[1], self.size

