"""Chunking into equal subspaces, each optionally projected (counterpart of
``scann_tpu/projection/chunking.py``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.projection.base import Projection
from scann_tpu_torch.types import DEFAULT_DEVICE


@dataclasses.dataclass
class ChunkingConfig:
    input_dim: int
    num_chunks: int
    project_chunks: bool = False
    chunk_output_dim: Optional[int] = None

    def __post_init__(self):
        if self.input_dim % self.num_chunks != 0:
            raise ScannError.invalid_argument(
                "input_dim must be divisible by num_chunks")

    def with_projection(self, output_dim_per_chunk: int) -> "ChunkingConfig":
        self.project_chunks = True
        self.chunk_output_dim = output_dim_per_chunk
        return self


class ChunkingProjection(Projection):
    """Splits vectors into ``num_chunks`` equal chunks. With
    ``project_chunks`` each chunk gets a random orthogonal projection
    (seed 42 + chunk); ``set_chunk_projection`` installs any other."""

    def __init__(self, config: ChunkingConfig,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config
        self.device = torch.device(device)
        self.chunk_dim = config.input_dim // config.num_chunks
        self.chunk_projections: List[Optional[Projection]] = \
            [None] * config.num_chunks
        if config.project_chunks:
            from scann_tpu_torch.projection.random import (
                RandomOrthogonalProjection,
            )

            out = config.chunk_output_dim
            if out is None or not 0 < out <= self.chunk_dim:
                raise ScannError.invalid_argument(
                    f"chunk_output_dim must be in (0, {self.chunk_dim}], "
                    f"got {out}")
            for i in range(config.num_chunks):
                self.chunk_projections[i] = RandomOrthogonalProjection(
                    self.chunk_dim, out, seed=42 + i, device=self.device)

    @property
    def input_dim(self) -> int:
        return self.config.input_dim

    @property
    def output_dim(self) -> int:
        return sum(p.output_dim if p is not None else self.chunk_dim
                   for p in self.chunk_projections)

    def set_chunk_projection(self, chunk_idx: int,
                             projection: Projection) -> None:
        if projection.input_dim != self.chunk_dim:
            raise ScannError.invalid_argument(
                f"chunk projection input {projection.input_dim} != chunk dim "
                f"{self.chunk_dim}")
        self.chunk_projections[chunk_idx] = projection

    def chunks(self, x) -> List[torch.Tensor]:
        """[.., D] split into ``num_chunks`` tensors [.., chunk_dim]."""
        return list(torch.split(self._check(x), self.chunk_dim, dim=-1))

    def project(self, x) -> torch.Tensor:
        return torch.cat([p.project(c) if p is not None else c
                          for c, p in zip(self.chunks(x),
                                          self.chunk_projections)], dim=-1)
