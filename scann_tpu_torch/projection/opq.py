"""OPQ-style learned rotation (counterpart of
``scann_tpu/projection/opq.py``): the reference's simplified eigen-based
refinement, not full k-means OPQ. Start from a random orthogonal matrix
(or a given one); each iteration rotates the data, replaces each
subspace's diagonal block by the eigenvectors of that subspace's
covariance, and orthonormalizes the product again.

The rotation and the covariances run on the device; the small eigen and
Gram–Schmidt steps run in float64 on the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.projection.base import Projection
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device
from scann_tpu_torch.utils.linear_algebra import (
    as_rows,
    gram_schmidt,
    random_orthogonal_matrix,
    symmetric_eigen,
)


@dataclasses.dataclass
class OpqConfig:
    dim: int
    num_subspaces: int = 8
    num_iterations: int = 10
    seed: int = 42


class OpqProjection(Projection):
    def __init__(self, config: OpqConfig,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config
        self.device = torch.device(device)
        self.rotation: Optional[torch.Tensor] = None  # [D, D], x @ R

    @classmethod
    def from_numpy(cls, rotation, config: Optional[OpqConfig] = None,
                   device: Union[str, torch.device] = DEFAULT_DEVICE
                   ) -> "OpqProjection":
        """A trained projection from a JAX projection's ``rotation``."""
        rotation = np.asarray(rotation, np.float32)
        p = cls(config or OpqConfig(dim=rotation.shape[0]), device=device)
        p.rotation = torch.tensor(rotation, device=require_device(p.device))
        return p

    @property
    def input_dim(self) -> int:
        return self.config.dim

    @property
    def output_dim(self) -> int:
        return self.config.dim

    @property
    def is_trainable(self) -> bool:
        return True

    @property
    def is_trained(self) -> bool:
        return self.rotation is not None

    def train(self, data, initial_rotation=None) -> "OpqProjection":
        """Fit the rotation to ``data`` [N, D], starting from
        ``initial_rotation`` [D, D] when given (else a random orthogonal
        matrix drawn from ``config.seed``)."""
        x = as_rows(data, self.device)
        if x.numel() == 0:
            raise ScannError.invalid_argument("Cannot train on empty data")
        d = x.shape[1]
        if d != self.config.dim:
            raise ScannError.invalid_argument(
                "Data dimension does not match config")
        s = self.config.num_subspaces
        if d % s != 0:
            raise ScannError.invalid_argument(
                "Dimension must be divisible by num_subspaces")
        dsub = d // s

        if initial_rotation is None:
            rotation = random_orthogonal_matrix(
                d, self.config.seed, device=self.device).cpu().numpy()
        else:
            rotation = np.asarray(initial_rotation, np.float32)
        for _ in range(self.config.num_iterations):
            rotated = x @ torch.from_numpy(rotation).to(x.device)
            blocks = rotated.reshape(-1, s, dsub)
            covs = torch.einsum("nsd,nse->sde", blocks, blocks).cpu().numpy()
            new_rotation = np.zeros((d, d), dtype=np.float32)
            for si in range(s):
                lo = si * dsub
                _, vecs = symmetric_eigen(covs[si])
                new_rotation[lo:lo + dsub, lo:lo + dsub] = vecs
            combined = rotation @ new_rotation
            # orthonormalize again against drift
            rotation = gram_schmidt(combined.T).T.astype(np.float32)
            if rotation.shape != (d, d):
                # Gram–Schmidt lost rank: keep the product as it is
                rotation = combined
        self.rotation = torch.from_numpy(
            np.ascontiguousarray(rotation, np.float32)).to(x.device)
        return self

    def project(self, x) -> torch.Tensor:
        if self.rotation is None:
            raise ScannError.failed_precondition("OPQ not trained")
        return self._check(x) @ self.rotation

    def inverse_project(self, x) -> Optional[torch.Tensor]:
        if self.rotation is None:
            return None
        return self._as_tensor(x) @ self.rotation.T
