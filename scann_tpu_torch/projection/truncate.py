"""Truncation to a window of dimensions (counterpart of
``scann_tpu/projection/truncate.py``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.projection.base import Projection
from scann_tpu_torch.types import DEFAULT_DEVICE


class TruncateProjection(Projection):
    """Keep dims [offset, offset + output_dim)."""

    def __init__(self, input_dim: int, output_dim: int, offset: int = 0,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        if offset < 0 or output_dim <= 0:
            raise ScannError.invalid_argument(
                "truncation window must have offset >= 0 and output_dim > 0")
        if offset + output_dim > input_dim:
            raise ScannError.invalid_argument(
                "truncation window exceeds input dim")
        self._in = int(input_dim)
        self._out = int(output_dim)
        self.offset = int(offset)
        self.device = torch.device(device)

    @property
    def input_dim(self) -> int:
        return self._in

    @property
    def output_dim(self) -> int:
        return self._out

    def project(self, x) -> torch.Tensor:
        return self._check(x)[..., self.offset:self.offset + self._out]

    def inverse_project(self, x) -> Optional[torch.Tensor]:
        """Zero-padded back to ``input_dim``."""
        x = self._as_tensor(x)
        out = x.new_zeros(x.shape[:-1] + (self._in,))
        out[..., self.offset:self.offset + self._out] = x
        return out
