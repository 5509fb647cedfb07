"""Random projections (counterpart of ``scann_tpu/projection/random.py``).

The matrices are drawn on the device from a ``torch.Generator`` seeded with
``seed``; the JAX package draws from ``jax.random``, so the same seed gives
other matrices with the same properties. ``from_numpy`` carries a JAX
projection's ``matrix`` across.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.projection.base import Projection
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device
from scann_tpu_torch.utils.linear_algebra import random_orthogonal_matrix


class _MatrixProjection(Projection):
    """``x @ matrix.T`` for a fixed [out, in] matrix."""

    matrix: torch.Tensor

    @property
    def input_dim(self) -> int:
        return self._in

    @property
    def output_dim(self) -> int:
        return self._out

    def project(self, x) -> torch.Tensor:
        return self._check(x) @ self.matrix.T

    @classmethod
    def from_numpy(cls, matrix,
                   device: Union[str, torch.device] = DEFAULT_DEVICE):
        """The projection with a given [out, in] ``matrix`` (a JAX
        projection's ``matrix``)."""
        p = cls.__new__(cls)
        p.device = require_device(device)
        p.matrix = torch.tensor(np.asarray(matrix, np.float32),
                                device=p.device)
        p._out, p._in = p.matrix.shape
        return p


class RandomOrthogonalProjection(_MatrixProjection):
    """The first ``output_dim`` rows of a random orthogonal matrix."""

    def __init__(self, input_dim: int, output_dim: Optional[int] = None,
                 seed: int = 42,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self._in = int(input_dim)
        self._out = int(output_dim) if output_dim is not None else self._in
        if not 0 < self._out <= self._in:
            raise ScannError.invalid_argument(
                f"output_dim must be in (0, {self._in}], got {self._out}")
        self.device = torch.device(device)
        full = random_orthogonal_matrix(self._in, seed, device=self.device)
        self.matrix = full[:self._out]  # [out, in]

    def inverse_project(self, x) -> Optional[torch.Tensor]:
        # orthonormal rows: the transpose is the (pseudo-)inverse
        return self._as_tensor(x) @ self.matrix


class RandomGaussianProjection(_MatrixProjection):
    """Johnson–Lindenstrauss projection: a standard Gaussian [out, in]
    matrix scaled by 1 / sqrt(out)."""

    def __init__(self, input_dim: int, output_dim: int, seed: int = 42,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self._in = int(input_dim)
        self._out = int(output_dim)
        self.device = require_device(device)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.matrix = torch.randn(self._out, self._in, generator=gen,
                                  device=self.device) / math.sqrt(self._out)
