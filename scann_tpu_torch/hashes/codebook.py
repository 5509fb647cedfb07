"""Product-quantization codebook (counterpart of
``scann_tpu/hashes/codebook.py``).

One k-means per subspace with seed ``seed + s``; the codebook is one
[S, C, d_sub] tensor. Encoding is a batched argmin over all subspaces at
once, chunked over rows; lookup tables are one batched product. With
``anisotropic_threshold`` set, the k-means centroids only start the
training, which goes on for ``avq_iters`` rounds under the score-aware
anisotropic loss (``hashes/avq.py``), and encoding minimizes that loss too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes.avq import (
    anisotropic_eta,
    avq_encode,
    avq_refine,
    unit_directions,
)
from scann_tpu_torch.trees.kmeans import KMeans, KMeansConfig, KMeansInit
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


@dataclasses.dataclass
class CodebookConfig:
    num_codes: int = 256
    num_subspaces: int = 8
    max_iterations: int = 25
    convergence_threshold: float = 1e-4
    seed: Optional[int] = None
    # score-aware (AVQ) training and encoding, e.g. 0.2; None = plain PQ
    anisotropic_threshold: Optional[float] = None
    avq_iters: int = 8


def encode_kernel(data: torch.Tensor, centroids: torch.Tensor,
                  chunk_size: int = 65536) -> torch.Tensor:
    """[N, D] float32, [S, C, d_sub] -> [N, S] int64 argmin codes."""
    n = data.shape[0]
    s, c, dsub = centroids.shape
    cent_sq = (centroids * centroids).sum(dim=-1)            # [S, C]
    out = torch.empty(n, s, dtype=torch.int64, device=data.device)
    for lo in range(0, n, chunk_size):
        xs = data[lo:lo + chunk_size].float().reshape(-1, s, dsub)
        dots = torch.einsum("nsd,scd->nsc", xs, centroids)
        x_sq = (xs * xs).sum(dim=-1)
        dists = x_sq[:, :, None] + cent_sq[None, :, :] - 2.0 * dots
        out[lo:lo + chunk_size] = dists.argmin(dim=-1)
    return out


def lut_kernel(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Per-query squared-L2 lookup tables [B, S, C] from [B, D] queries."""
    b = queries.shape[0]
    s, c, dsub = centroids.shape
    qs = queries.float().reshape(b, s, dsub)
    dots = torch.einsum("bsd,scd->bsc", qs, centroids)
    q_sq = (qs * qs).sum(dim=-1)
    cent_sq = (centroids * centroids).sum(dim=-1)
    return (q_sq[:, :, None] + cent_sq[None, :, :] - 2.0 * dots).clamp_min(0.0)


class Codebook:
    """[S, C, d_sub] PQ codebook trained and applied on ``device``."""

    def __init__(self, config: Optional[CodebookConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config or CodebookConfig()
        self.device = torch.device(device)
        self.centroids: Optional[torch.Tensor] = None   # [S, C, d_sub]
        self.eta: Optional[float] = None   # anisotropic weight ratio (AVQ)

    def train(self, data: torch.Tensor, directions=None) -> "Codebook":
        """Train on ``data`` [N, D] (moved to the codebook's device).
        ``directions`` (AVQ only): [N, D] rows of the original points, whose
        unit directions weight the loss; for residual quantization
        (tree-x-AH) these are the points, not the residuals. Default: the
        rows of ``data``."""
        x = torch.as_tensor(data, dtype=torch.float32,
                            device=require_device(self.device))
        if x.shape[0] == 0:
            raise ScannError.invalid_argument("Cannot train on empty dataset")
        n, d = x.shape
        s = self.config.num_subspaces
        if d % s != 0:
            raise ScannError.invalid_argument(
                f"Dimensionality {d} must be divisible by num_subspaces {s}")
        dsub = d // s
        c = min(self.config.num_codes, n)
        seed = self.config.seed if self.config.seed is not None else 42
        subs = x.reshape(n, s, dsub)
        centroids = torch.empty(s, c, dsub, dtype=torch.float32,
                                device=self.device)
        for sub in range(s):
            centroids[sub] = KMeans(KMeansConfig(
                num_clusters=c,
                max_iterations=self.config.max_iterations,
                convergence_threshold=self.config.convergence_threshold,
                init_method=KMeansInit.KMEANS_PLUS_PLUS,
                seed=seed + sub,
            ), device=self.device).fit(subs[:, sub, :].contiguous()).centers
        if self.config.anisotropic_threshold is not None:
            self.eta = anisotropic_eta(self.config.anisotropic_threshold, d)
            h = unit_directions(x if directions is None else directions)
            centroids, _, _ = avq_refine(
                x, h.to(self.device), centroids, self.eta,
                iters=int(self.config.avq_iters))
        self.centroids = centroids
        return self

    @property
    def num_codes(self) -> int:
        return 0 if self.centroids is None else self.centroids.shape[1]

    @property
    def num_subspaces(self) -> int:
        return 0 if self.centroids is None else self.centroids.shape[0]

    def centroids_device(self) -> torch.Tensor:
        """The [S, C, d_sub] centroids, already on the codebook's device."""
        self._check_trained()
        return self.centroids

    def encode_dataset(self, data: torch.Tensor,
                       directions=None) -> torch.Tensor:
        """[N, D] -> [N, S] uint8 codes, on the input's device. A codebook
        trained with AVQ encodes by the anisotropic loss, weighted by the
        unit rows of ``directions`` (default: of ``data``)."""
        self._check_trained()
        if self.eta is not None:
            h = unit_directions(data if directions is None else directions)
            return avq_encode(data, h, self.centroids, self.eta).to(
                torch.uint8)
        return encode_kernel(data, self.centroids).to(torch.uint8)

    def _check_trained(self) -> None:
        if self.centroids is None:
            raise ScannError.failed_precondition("codebook not trained")

    def _as_rows(self, data) -> torch.Tensor:
        """``data`` as float32 on the centroids' device (trained only)."""
        self._check_trained()
        return torch.as_tensor(data, dtype=torch.float32,
                               device=self.centroids.device)

    def encode(self, point) -> torch.Tensor:
        """One point [D] -> its [S] uint8 codes."""
        return self.encode_dataset(self._as_rows(point)[None, :])[0]

    def decode(self, codes) -> torch.Tensor:
        """[..., S] codes -> [..., D] float32 reconstruction (each
        subspace's centroid, concatenated)."""
        self._check_trained()
        codes = torch.as_tensor(codes, device=self.centroids.device).long()
        s, _, dsub = self.centroids.shape
        parts = self.centroids[torch.arange(s, device=codes.device), codes]
        return parts.reshape(*codes.shape[:-1], s * dsub)

    def reconstruction_error(self, data) -> float:
        """Mean over rows of the squared L2 error of decode(encode(row))."""
        x = self._as_rows(data)
        rec = self.decode(self.encode_dataset(x))
        return float(((x - rec) ** 2).sum(-1).mean())

    def lookup_tables(self, queries) -> torch.Tensor:
        """[B, D] (or one [D]) queries -> [B, S, C] squared-L2 tables."""
        q = self._as_rows(queries)
        if q.dim() == 1:
            q = q[None, :]
        return lut_kernel(q, self.centroids)
