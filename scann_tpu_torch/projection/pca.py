"""PCA projection (counterpart of ``scann_tpu/projection/pca.py``), trained
by ``utils/linear_algebra.fit_pca`` on the device."""

from __future__ import annotations

from typing import Optional, Union

import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.projection.base import Projection
from scann_tpu_torch.types import DEFAULT_DEVICE
from scann_tpu_torch.utils.linear_algebra import PcaResult, as_rows, fit_pca


class PcaProjection(Projection):
    def __init__(self, input_dim: int, output_dim: int,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self._in = int(input_dim)
        self._out = int(output_dim)
        self.device = torch.device(device)
        self.result: Optional[PcaResult] = None

    @classmethod
    def from_numpy(cls, components, mean, explained_variance,
                   explained_variance_ratio,
                   device: Union[str, torch.device] = DEFAULT_DEVICE
                   ) -> "PcaProjection":
        """A trained projection from a JAX ``PcaResult``'s fields."""
        result = PcaResult.from_numpy(components, mean, explained_variance,
                                      explained_variance_ratio, device)
        p = cls(result.components.shape[1], result.components.shape[0],
                device=result.mean.device)
        p.result = result
        return p

    @property
    def input_dim(self) -> int:
        return self._in

    @property
    def output_dim(self) -> int:
        return self._out

    @property
    def is_trainable(self) -> bool:
        return True

    @property
    def is_trained(self) -> bool:
        return self.result is not None

    def train(self, data) -> "PcaProjection":
        x = as_rows(data, self.device)
        if x.shape[1] != self._in:
            raise ScannError.invalid_argument("training data dim mismatch")
        self.result = fit_pca(x, self._out, device=self.device)
        return self

    def project(self, x) -> torch.Tensor:
        if self.result is None:
            raise ScannError.failed_precondition("PCA not trained")
        return (self._check(x) - self.result.mean) @ self.result.components.T

    def inverse_project(self, x) -> Optional[torch.Tensor]:
        """Approximate reconstruction from the kept axes."""
        if self.result is None:
            return None
        return self._as_tensor(x) @ self.result.components + self.result.mean

    def explained_variance_ratio(self) -> torch.Tensor:
        if self.result is None:
            raise ScannError.failed_precondition("PCA not trained")
        return self.result.explained_variance_ratio
