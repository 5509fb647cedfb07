"""Lookup-table types and the u8 table codec (counterpart of
``scann_tpu/hashes/lut.py``).

Batched LUTs live on the device as [B, S, C] float32 tensors
(``hashes/codebook.lut_kernel``) and go straight to the scoring kernels
(``ops/scoring_kernels.py``). The host classes hold one query's tables for
scalar checks; the codec quantizes a batch of tables to u8 with one global
range per query, and :func:`luts_i8_evenfirst` lays the u8 tables out for
the fused int8 sweep.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError


class LookupTable:
    """Per-query [S, C] float32 distance tables."""

    def __init__(self, distances: np.ndarray):
        distances = np.asarray(distances, dtype=np.float32)
        if distances.ndim != 2:
            raise ScannError.invalid_argument(
                "LUT must be [num_subspaces, num_codes]")
        self.distances = distances

    @classmethod
    def from_query(cls, codebook, query: np.ndarray) -> "LookupTable":
        """Squared-L2 tables of one query under a trained ``Codebook``."""
        from scann_tpu_torch.hashes.codebook import lut_kernel

        cent = codebook.centroids
        q = torch.as_tensor(np.asarray(query, np.float32).reshape(1, -1),
                            device=cent.device)
        return cls(lut_kernel(q, cent)[0].cpu().numpy())

    @property
    def num_subspaces(self) -> int:
        return self.distances.shape[0]

    @property
    def num_codes(self) -> int:
        return self.distances.shape[1]

    def compute_distance(self, codes: np.ndarray) -> float:
        """Σ_s table[s][code_s]."""
        codes = np.asarray(codes, dtype=np.int64)
        return float(self.distances[np.arange(self.num_subspaces), codes].sum())

    def compute_distances_batch(self, codes_batch: np.ndarray) -> np.ndarray:
        codes_batch = np.asarray(codes_batch, dtype=np.int64)
        return self.distances[
            np.arange(self.num_subspaces)[None, :], codes_batch
        ].sum(axis=1).astype(np.float32)

    def subspace_distances(self, s: int) -> np.ndarray:
        return self.distances[s]

    def to_int8(self) -> "LookupTableInt8":
        """Global-range u8 quantization."""
        lo = float(self.distances.min())
        hi = float(self.distances.max())
        scale = 255.0 / (hi - lo) if hi > lo else 1.0
        q = np.floor((self.distances - lo) * scale + 0.5).astype(np.uint8)
        return LookupTableInt8(q, scale=scale, offset=lo)


class LookupTableInt8:
    """u8-quantized tables: distance = (Σ u8) / scale + offset * S."""

    def __init__(self, distances: np.ndarray, scale: float, offset: float):
        self.distances = np.asarray(distances, dtype=np.uint8)
        self.scale = float(scale)
        self.offset = float(offset)

    @property
    def num_subspaces(self) -> int:
        return self.distances.shape[0]

    @property
    def num_codes(self) -> int:
        return self.distances.shape[1]

    def compute_distance_raw(self, codes: np.ndarray) -> int:
        codes = np.asarray(codes, dtype=np.int64)
        return int(self.distances[np.arange(self.num_subspaces), codes]
                   .astype(np.uint32).sum())

    def compute_distance(self, codes: np.ndarray) -> float:
        return (self.compute_distance_raw(codes) / self.scale
                + self.offset * self.num_subspaces)


def quantize_luts_u8(luts: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """Batch u8 quantization with one global min/max per query:
        q = floor((v - bias) * 255/range + 0.5); dequant sum = sum*multiplier + bias*S

    Args: luts [B, S, C] float32. Returns (u8 luts [B, S, C], multiplier
    [B], bias [B])."""
    luts = np.asarray(luts, dtype=np.float32)
    lo = luts.min(axis=(1, 2))
    hi = luts.max(axis=(1, 2))
    rng = hi - lo
    degenerate = rng < 1e-10
    scale = np.where(degenerate, 1.0, 255.0 / np.where(degenerate, 1.0, rng))
    multiplier = np.where(degenerate, 1.0, 1.0 / scale)
    q = np.floor((luts - lo[:, None, None]) * scale[:, None, None] + 0.5)
    return (np.clip(q, 0, 255).astype(np.uint8), multiplier.astype(np.float32),
            lo.astype(np.float32))


def quantize_luts_u8_device(luts: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """:func:`quantize_luts_u8` on a [B, S, C] float32 tensor, on its
    device, in float32: each step is its own correctly rounded operation (no
    fused multiply-add; the divisions are tensor by tensor, since
    ``scalar / tensor`` multiplies by a rounded reciprocal), as in the JAX
    package's program.

    Returns (u8 [B, S, C], multiplier [B] float32, bias [B] float32)."""
    luts = luts.float()
    lo = luts.amin(dim=(1, 2))
    hi = luts.amax(dim=(1, 2))
    rng = hi - lo
    degenerate = rng < 1e-10
    one = torch.ones_like(rng)
    scale = torch.where(degenerate, one,
                        torch.full_like(rng, 255.0)
                        / torch.where(degenerate, one, rng))
    multiplier = torch.where(degenerate, one, one / scale)
    q = torch.floor((luts - lo[:, None, None]) * scale[:, None, None] + 0.5)
    return q.clamp(0, 255).to(torch.uint8), multiplier, lo


def luts_i8_evenfirst(q_u8: torch.Tensor) -> torch.Tensor:
    """u8 tables [B, S, C] -> the fused sweep's [B, S_pad*C] int8 tables.

    Pads S to even with q=0 rows (after the kernel's +128*S_pad bias fold
    they add 0, so padding never moves a sum), orders subspaces even-first
    to match the packed low/high nibble split, and biases by -128 into
    int8."""
    b, s, c = q_u8.shape
    q = q_u8.to(torch.int16)
    if s % 2:
        q = torch.cat([q, q.new_zeros(b, 1, c)], dim=1)
    q = torch.cat([q[:, 0::2], q[:, 1::2]], dim=1)
    return (q - 128).to(torch.int8).reshape(b, -1)
