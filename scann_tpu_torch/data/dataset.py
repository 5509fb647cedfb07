"""Dense dataset container (counterpart of ``scann_tpu/data/dataset.py``):
a host numpy copy plus one cached device tensor."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError


class DenseDataset:
    """[N, D] float32 dataset. ``device_tensor(device)`` uploads once and
    caches; asking for another device replaces the cache. The GPU needs no
    row padding, so the tensor is exactly [N, D]."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim != 2:
            raise ScannError.invalid_argument(
                f"expected [N, D] array, got shape {data.shape}")
        self._data = data
        self._device_cache: Optional[torch.Tensor] = None

    @property
    def size(self) -> int:
        return self._data.shape[0]

    @property
    def dimensionality(self) -> int:
        return self._data.shape[1]

    @property
    def is_empty(self) -> bool:
        return self.size == 0

    def numpy(self) -> np.ndarray:
        """Host view [N, D]."""
        return self._data

    def device_tensor(self, device: Union[str, torch.device]) -> torch.Tensor:
        """[N, D] float32 tensor on ``device``, cached."""
        device = torch.device(device)
        cached = self._device_cache
        if cached is None or cached.device != _canonical(device):
            self._device_cache = torch.from_numpy(self._data).to(device)
        return self._device_cache


def _canonical(device: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` name the same device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
