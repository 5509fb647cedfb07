"""Flat k-means partitioner (counterpart of
``scann_tpu/partitioning/tree_partitioner.py``, flat build only).

Build = k-means over the dataset (or a seeded training sample of it), then
every row is assigned to its nearest centroid. Balancing
(``max_partition_size``), spilling and hierarchical trees wait for later
slices and raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.partitioning.partitioner import DatabaseTokenization
from scann_tpu_torch.trees.kmeans import (
    KMeans,
    KMeansConfig,
    KMeansInit,
    assign_clusters,
)
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


@dataclasses.dataclass
class TreePartitionerConfig:
    num_partitions: int = 100
    max_iterations: int = 100
    convergence_threshold: float = 1e-5
    seed: int = 42
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    num_levels: int = 1
    training_sample_size: Optional[int] = None
    spilling: bool = False
    max_partition_size: Optional[object] = None


def check_flat_partitioning(cfg: TreePartitionerConfig) -> None:
    """Raise for the partitioner options this slice has not ported."""
    if cfg.max_partition_size is not None:
        raise NotImplementedError(
            "partition balancing (max_partition_size) is not ported yet "
            "(ROADMAP.md queue 1, item 2b: balancing)")
    if cfg.spilling:
        raise NotImplementedError(
            "spilling is not ported yet (ROADMAP.md queue 1, item 3: "
            "spilling and SOAR)")
    if cfg.num_levels != 1:
        raise NotImplementedError(
            "hierarchical partitioning is not ported yet (ROADMAP.md "
            "queue 1, item 8: kmeans_tree)")
    if cfg.distance_measure != DistanceMeasure.SQUARED_L2:
        raise NotImplementedError(
            f"partitioning under {cfg.distance_measure} is not ported yet "
            f"(ROADMAP.md queue 1, item 3: non-L2 measures)")


class TreePartitioner:
    """Flat k-means partitioner on ``device``."""

    def __init__(self, config: Optional[TreePartitionerConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config or TreePartitionerConfig()
        self.device = torch.device(device)
        self.centers: Optional[torch.Tensor] = None      # [K, D] float32
        self.tokenization: Optional[DatabaseTokenization] = None

    def build(self, data: torch.Tensor) -> "TreePartitioner":
        """Train centroids on ``data`` [N, D] (a device tensor) and tokenize
        every row."""
        cfg = self.config
        check_flat_partitioning(cfg)
        data = data.to(require_device(self.device))
        n = data.shape[0]
        if n == 0:
            raise ScannError.invalid_argument("cannot partition empty dataset")
        k = min(cfg.num_partitions, n)

        train = data
        if cfg.training_sample_size is not None and cfg.training_sample_size < n:
            gen = torch.Generator(device=data.device)
            gen.manual_seed(cfg.seed)
            sel = torch.randperm(n, generator=gen, device=data.device)
            train = data[sel[:cfg.training_sample_size]]

        result = KMeans(KMeansConfig(
            num_clusters=k,
            max_iterations=cfg.max_iterations,
            convergence_threshold=cfg.convergence_threshold,
            init_method=KMeansInit.KMEANS_PLUS_PLUS,
            seed=cfg.seed,
        ), device=data.device).fit(train)
        self.centers = result.centers
        tokens = result.assignments if train is data else self.tokenize(data)
        self.tokenization = DatabaseTokenization(tokens, k)
        return self

    def tokenize(self, data: torch.Tensor) -> torch.Tensor:
        """[N] int64 nearest-centroid token of every row (chunked so the
        [chunk, K] distance block stays bounded)."""
        return assign_clusters(data.float(), self.centers)[0]

    @property
    def num_partitions(self) -> int:
        return 0 if self.centers is None else self.centers.shape[0]
