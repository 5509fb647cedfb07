"""Projection interface, the identity and the factory (counterpart of
``scann_tpu/projection/base.py``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


class Projection:
    """``project`` is batched: [.., D_in] -> [.., D_out], float32 tensors
    on ``self.device``."""

    device: torch.device

    @property
    def input_dim(self) -> int:
        raise NotImplementedError

    @property
    def output_dim(self) -> int:
        raise NotImplementedError

    def project(self, x) -> torch.Tensor:
        raise NotImplementedError

    def inverse_project(self, x) -> Optional[torch.Tensor]:
        return None

    @property
    def is_trainable(self) -> bool:
        return False

    def _as_tensor(self, x) -> torch.Tensor:
        """``x`` (numpy or a tensor) as float32 on the device."""
        return torch.as_tensor(x, dtype=torch.float32,
                               device=require_device(self.device))

    def _check(self, x) -> torch.Tensor:
        x = self._as_tensor(x)
        if x.shape[-1] != self.input_dim:
            raise ScannError.invalid_argument(
                f"input dim {x.shape[-1]} != projection input "
                f"{self.input_dim}")
        return x


class IdentityProjection(Projection):
    """Returns its input."""

    def __init__(self, dim: int,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self._dim = int(dim)
        self.device = torch.device(device)

    @property
    def input_dim(self) -> int:
        return self._dim

    @property
    def output_dim(self) -> int:
        return self._dim

    def project(self, x) -> torch.Tensor:
        return self._check(x)

    def inverse_project(self, x) -> Optional[torch.Tensor]:
        return self._as_tensor(x)


class ProjectionFactory:
    """Projections by name, on ``device``."""

    @staticmethod
    def create(kind: str, device: Union[str, torch.device] = DEFAULT_DEVICE,
               **kwargs) -> Projection:
        from scann_tpu_torch.projection.chunking import (
            ChunkingConfig,
            ChunkingProjection,
        )
        from scann_tpu_torch.projection.opq import OpqConfig, OpqProjection
        from scann_tpu_torch.projection.pca import PcaProjection
        from scann_tpu_torch.projection.random import (
            RandomGaussianProjection,
            RandomOrthogonalProjection,
        )
        from scann_tpu_torch.projection.truncate import TruncateProjection

        kind = kind.lower()
        if kind == "identity":
            return IdentityProjection(kwargs["dim"], device=device)
        if kind == "pca":
            return PcaProjection(kwargs["input_dim"], kwargs["output_dim"],
                                 device=device)
        if kind == "random_orthogonal":
            return RandomOrthogonalProjection(
                kwargs["input_dim"], kwargs.get("output_dim"),
                kwargs.get("seed", 42), device=device)
        if kind == "random_gaussian":
            return RandomGaussianProjection(
                kwargs["input_dim"], kwargs["output_dim"],
                kwargs.get("seed", 42), device=device)
        if kind == "opq":
            return OpqProjection(OpqConfig(
                dim=kwargs["dim"],
                num_subspaces=kwargs.get("num_subspaces", 8),
                num_iterations=kwargs.get("num_iterations", 10),
                seed=kwargs.get("seed", 42)), device=device)
        if kind == "truncate":
            return TruncateProjection(kwargs["input_dim"],
                                      kwargs["output_dim"],
                                      kwargs.get("offset", 0), device=device)
        if kind == "chunking":
            return ChunkingProjection(ChunkingConfig(
                input_dim=kwargs["input_dim"],
                num_chunks=kwargs["num_chunks"]), device=device)
        raise ScannError.invalid_argument(f"unknown projection kind {kind!r}")
