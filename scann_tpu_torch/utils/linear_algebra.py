"""Linear algebra for training (counterpart of
``scann_tpu/utils/linear_algebra.py``): PCA by an SVD on the device, random
orthogonal matrices from the QR of a Gaussian drawn from a
``torch.Generator``, and the small float64 host helpers (symmetric
eigendecomposition, Gram–Schmidt) that the JAX package also runs in numpy.

The JAX package draws its Gaussian from ``jax.random``, which the port
cannot repeat: the same seed gives another orthogonal matrix here, with the
same properties. State crosses from the JAX package through each drawn
object's ``from_numpy``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


@dataclasses.dataclass
class PcaResult:
    """Principal axes and variances, tensors on one device."""

    components: torch.Tensor          # [out_dim, D] principal axes (rows)
    mean: torch.Tensor                # [D]
    explained_variance: torch.Tensor  # [out_dim]
    explained_variance_ratio: torch.Tensor

    @classmethod
    def from_numpy(cls, components, mean, explained_variance,
                   explained_variance_ratio,
                   device: Union[str, torch.device] = DEFAULT_DEVICE
                   ) -> "PcaResult":
        """A result from numpy arrays (a JAX ``PcaResult``'s fields)."""
        device = require_device(device)
        return cls(*(torch.tensor(np.asarray(a, np.float32), device=device)
                     for a in (components, mean, explained_variance,
                               explained_variance_ratio)))


def as_rows(data, device: Union[str, torch.device]) -> torch.Tensor:
    """``data`` (a tensor, a numpy array or a dataset with ``numpy()``) as
    float32 [N, D] on ``device``."""
    if hasattr(data, "numpy") and not isinstance(data, torch.Tensor):
        data = data.numpy()
    return torch.as_tensor(data, dtype=torch.float32,
                           device=require_device(device))


def fit_pca(data, out_dim: int,
            device: Union[str, torch.device] = DEFAULT_DEVICE) -> PcaResult:
    """The ``out_dim`` principal axes of ``data`` [N, D]: an economy SVD of
    the centred rows on ``device``, variances s² / (N - 1)."""
    x = as_rows(data, device)
    n, d = x.shape
    if out_dim <= 0 or out_dim > d:
        raise ScannError.invalid_argument(f"out_dim {out_dim} not in [1, {d}]")
    if n < 2:
        raise ScannError.invalid_argument("PCA needs at least 2 samples")
    mean = x.mean(dim=0)
    _, s, vt = torch.linalg.svd(x - mean[None, :], full_matrices=False)
    var = (s * s) / max(n - 1, 1)
    return PcaResult(
        components=vt[:out_dim],
        mean=mean,
        explained_variance=var[:out_dim],
        explained_variance_ratio=var[:out_dim] / max(float(var.sum()),
                                                     1e-30),
    )


def random_orthogonal_matrix(dim: int, seed: int = 42,
                             device: Union[str, torch.device] = DEFAULT_DEVICE
                             ) -> torch.Tensor:
    """[dim, dim] float32: the Q of the QR of a Gaussian matrix drawn on
    ``device`` from a generator seeded with ``seed``, its signs fixed so
    that diag(R) > 0."""
    device = require_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    g = torch.randn(dim, dim, generator=gen, device=device)
    q, r = torch.linalg.qr(g)
    return q * torch.sign(torch.diagonal(r))[None, :]


def symmetric_eigen(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition of a symmetric matrix in float64 on the host,
    eigenvalues descending: (eigenvalues [D], eigenvectors [D, D] as
    columns), float32."""
    mat = np.asarray(mat, dtype=np.float32)
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        raise ScannError.invalid_argument("matrix must be square")
    w, v = np.linalg.eigh(mat.astype(np.float64))
    order = np.argsort(w)[::-1]
    return w[order].astype(np.float32), v[:, order].astype(np.float32)


def gram_schmidt(vectors: np.ndarray) -> np.ndarray:
    """Orthonormalize rows in float64 on the host; rows that fall below
    1e-10 after projection are dropped (the result may have fewer rows)."""
    v = np.asarray(vectors, dtype=np.float64).copy()
    out = []
    for row in v:
        for u in out:
            row = row - np.dot(row, u) * u
        norm = np.linalg.norm(row)
        if norm > 1e-10:
            out.append(row / norm)
    return np.asarray(out, dtype=np.float32)
