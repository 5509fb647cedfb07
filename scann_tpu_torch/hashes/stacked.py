"""Stacked (multi-level residual) product quantization (counterpart of
``scann_tpu/hashes/stacked.py``).

Each level trains a full PQ ``Codebook`` on the residuals the previous
levels leave (level seeds ``seed + 1000 * level``, as in the JAX package);
encoding subtracts each level's reconstruction before encoding the next.
``AdditiveQuantizer`` is the variant with one subspace a level. Training
and encoding run on the codebooks' device; the loop over the few levels
runs on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes.codebook import Codebook, CodebookConfig
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device
from scann_tpu_torch.utils.linear_algebra import as_rows


@dataclasses.dataclass
class StackedQuantizerConfig:
    num_levels: int = 2
    num_codes: int = 16
    num_subspaces: int = 8
    max_iterations: int = 25
    seed: Optional[int] = None


class StackedQuantizer:
    """Residual multi-level PQ on ``device``."""

    def __init__(self, config: Optional[StackedQuantizerConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config or StackedQuantizerConfig()
        self.device = torch.device(device)
        self.levels: List[Codebook] = []
        self.dimensionality = 0

    @classmethod
    def from_numpy(cls, level_centroids: Sequence[np.ndarray],
                   config: Optional[StackedQuantizerConfig] = None,
                   device: Union[str, torch.device] = DEFAULT_DEVICE
                   ) -> "StackedQuantizer":
        """A trained quantizer from each level's [S, C, d_sub] centroids (a
        JAX quantizer's ``levels[i].centroids``), loaded as saved
        codebooks are."""
        from scann_tpu_torch.io import _codebook

        device = require_device(device)
        levels = [_codebook({"codebook": np.asarray(c, np.float32)}, None,
                            device) for c in level_centroids]
        s, c, dsub = levels[0].centroids.shape
        q = cls(config or StackedQuantizerConfig(
            num_levels=len(levels), num_codes=c, num_subspaces=s),
            device=device)
        q.levels = levels
        q.dimensionality = s * dsub
        return q

    @property
    def is_trained(self) -> bool:
        return bool(self.levels)

    def train(self, data) -> "StackedQuantizer":
        residual = as_rows(data, self.device).clone()
        if residual.shape[0] == 0:
            raise ScannError.invalid_argument("Cannot train on empty dataset")
        cfg = self.config
        self.dimensionality = residual.shape[1]
        seed = cfg.seed if cfg.seed is not None else 42
        self.levels = []
        for lvl in range(cfg.num_levels):
            cb = Codebook(CodebookConfig(
                num_codes=cfg.num_codes,
                num_subspaces=cfg.num_subspaces,
                max_iterations=cfg.max_iterations,
                seed=seed + 1000 * lvl,
            ), device=self.device).train(residual)
            residual = residual - cb.decode(cb.encode_dataset(residual))
            self.levels.append(cb)
        return self

    def encode(self, points) -> torch.Tensor:
        """[.., D] -> [.., L, S] uint8 codes."""
        self._check_trained()
        x = as_rows(points, self.device)
        single = x.dim() == 1
        residual = x[None, :] if single else x
        out = []
        for cb in self.levels:
            codes = cb.encode_dataset(residual)
            out.append(codes)
            residual = residual - cb.decode(codes)
        out = torch.stack(out, dim=1)
        return out[0] if single else out

    def decode(self, codes) -> torch.Tensor:
        """[.., L, S] codes -> [.., D] reconstruction (the sum of the
        levels')."""
        self._check_trained()
        codes = torch.as_tensor(codes, device=self.levels[0].centroids.device)
        single = codes.dim() == 2
        if single:
            codes = codes[None]
        out = torch.zeros(codes.shape[0], self.dimensionality,
                          device=codes.device)
        for li, cb in enumerate(self.levels):
            out += cb.decode(codes[:, li, :])
        return out[0] if single else out

    def reconstruction_error(self, data) -> float:
        """Mean over rows of the squared L2 error of decode(encode(row))."""
        x = as_rows(data, self.device)
        rec = self.decode(self.encode(x))
        return float(((x - rec) ** 2).sum(-1).mean())

    def _check_trained(self):
        if not self.levels:
            raise ScannError.failed_precondition("quantizer not trained")


class AdditiveQuantizer(StackedQuantizer):
    """One subspace a level."""

    def __init__(self, num_levels: int = 4, num_codes: int = 256,
                 max_iterations: int = 25, seed: Optional[int] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        super().__init__(StackedQuantizerConfig(
            num_levels=num_levels, num_codes=num_codes, num_subspaces=1,
            max_iterations=max_iterations, seed=seed), device=device)
