"""Unified ``Scann`` facade and ``ScannBuilder`` (counterpart of
``scann_tpu/models/scann.py``).

The config selects the searcher, as in the JAX package:

  - ``brute_force.block_sweep``         -> BlockSweepSearcher (BRUTE_FORCE)
  - ``brute_force.scalar_quantization`` -> ScalarQuantizedBruteForceSearcher
  - partitioning + hash                 -> TreeXHybridSearcher (TREE_AH)
  - partitioning                        -> PartitionedSearcher (PARTITIONED)
  - hash                                -> AsymmetricHasher (HASHED)
  - nothing                             -> BruteForceSearcher (BRUTE_FORCE)

each built on ``device`` (the current CUDA device unless the caller names
another). The facade only routes: its searches are the inner searcher's
with the parameters the config implies. ``auto_config``, ``Scann.auto`` and
``ScannBuilder.auto()`` need the chip profile, the advisor and the
autotuner, and a ``mesh`` needs the sharded searchers: they raise
``NotImplementedError`` naming their ROADMAP.md items (10b, 11).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.config import HashConfig, ScannConfig
from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes.hasher import (
    AsymmetricHasher,
    AsymmetricHasherConfig,
)
from scann_tpu_torch.models.block_sweep import (
    BlockSweepConfig,
    BlockSweepSearcher,
)
from scann_tpu_torch.models.brute_force import BruteForceSearcher
from scann_tpu_torch.models.partitioned import PartitionedSearcher
from scann_tpu_torch.models.scalar_quantized import (
    ScalarQuantizedBruteForceSearcher,
    ScalarQuantizedConfig,
)
from scann_tpu_torch.models.searcher import SearchParameters, Searcher
from scann_tpu_torch.models.tree_x_hybrid import (
    TreeXHybridConfig,
    TreeXHybridSearcher,
)
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.partitioning.tree_partitioner import (
    TreePartitionerConfig,
)
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


class SearchMode(enum.Enum):
    BRUTE_FORCE = "BruteForce"
    PARTITIONED = "Partitioned"
    HASHED = "Hashed"
    TREE_AH = "TreeAH"


def _auto_unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the chip profile, the advisor and the autotuner, "
        f"which are not ported yet (ROADMAP.md queue 1, item 10b: tuning "
        f"and the harness)")


def _mesh_unported() -> NotImplementedError:
    return NotImplementedError(
        "a mesh needs the sharded searchers, which are not ported yet "
        "(ROADMAP.md queue 1, item 11: multiple GPUs)")


def _hash_to_ah_config(hc: HashConfig, for_tree_ah: bool,
                       measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
                       rerank_dtype: str = "float32",
                       ) -> AsymmetricHasherConfig:
    """HashConfig(num_buckets, num_blocks) -> the hasher's (num_codes,
    num_subspaces), seed 42. ``rerank_dtype`` carries the re-rank store's
    dtype into HASHED mode (tree-x-AH takes it through its own config)."""
    return AsymmetricHasherConfig(
        num_codes=int(hc.num_buckets),
        num_subspaces=int(hc.num_blocks),
        training_sample_size=int(hc.training_sample_size),
        seed=42,
        distance_measure=measure,
        anisotropic_threshold=hc.anisotropic_threshold,
        rerank_dtype=rerank_dtype,
    )


def _rerank_dtype_of(r) -> str:
    """The re-rank store dtype an ExactReorderingConfig selects: an explicit
    rerank_dtype wins; ``quantized`` alone selects int8."""
    if r is None:
        return "float32"
    if r.quantized and r.rerank_dtype == "float32":
        return "int8"
    return r.rerank_dtype


def _tree_cfg_of(config: ScannConfig) -> TreeXHybridConfig:
    """ScannConfig (partitioning + hash [+ reordering]) -> the
    TreeXHybridConfig the facade builds: the re-rank depth becomes
    ``pre_reorder_multiplier`` = num_candidates / num_neighbors (at least
    1)."""
    p = config.partitioning
    cfg = TreeXHybridConfig(
        num_partitions=int(p.num_partitions),
        partitions_to_search=int(p.num_partitions_to_search),
        hash_config=_hash_to_ah_config(config.hash, for_tree_ah=True),
        distance_measure=config.distance_measure,
        spilling=bool(p.spilling),
        spilling_threshold=float(p.spilling_threshold),
        spilling_mode=str(p.spilling_mode),
        soar_lambda=float(p.soar_lambda),
        max_partition_size=p.max_partition_size,
        split_stragglers=bool(p.split_stragglers),
        partition_max_iterations=int(p.max_training_iterations),
        partition_convergence_threshold=float(p.convergence_threshold),
        partition_num_levels=int(p.num_levels),
        partition_training_sample_size=p.training_sample_size,
    )
    if config.exact_reordering is not None:
        cfg.pre_reorder_multiplier = max(
            float(config.exact_reordering.num_candidates)
            / max(config.num_neighbors, 1), 1.0)
        cfg.rerank_dtype = _rerank_dtype_of(config.exact_reordering)
    return cfg


def _partitioner_cfg_of(config: ScannConfig) -> TreePartitionerConfig:
    """ScannConfig.partitioning -> the PARTITIONED mode's partitioner."""
    p = config.partitioning
    return TreePartitionerConfig(
        num_partitions=int(p.num_partitions),
        max_iterations=int(p.max_training_iterations),
        convergence_threshold=float(p.convergence_threshold),
        num_levels=int(p.num_levels),
        distance_measure=config.distance_measure,
        training_sample_size=p.training_sample_size,
        spilling=bool(p.spilling),
        spilling_threshold=float(p.spilling_threshold),
        spilling_mode=str(p.spilling_mode),
        soar_lambda=float(p.soar_lambda),
        max_partition_size=p.max_partition_size,
        split_stragglers=bool(p.split_stragglers),
    )


def auto_config(n: int, dim: int,
                measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
                force_tree: bool = False) -> ScannConfig:
    """The JAX package picks an architecture from the dataset's scale and
    its chip profile; the port has no profile yet."""
    raise _auto_unported("auto_config")


class Scann(Searcher):
    """Config-driven searcher facade."""

    def __init__(self, dataset: DenseDataset,
                 config: Optional[ScannConfig] = None,
                 _impl: Optional[Searcher] = None,
                 _mode: Optional[SearchMode] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        """``_impl`` / ``_mode``: a searcher built elsewhere, which the
        facade then only wraps."""
        config = config or ScannConfig()
        if dataset.is_empty:
            raise ScannError.invalid_argument("Dataset cannot be empty")
        self.device = require_device(device)
        self._dataset = dataset
        self._config = config
        if _impl is not None:
            self._impl = _impl
            self.search_mode = _mode or SearchMode.TREE_AH
            return
        measure = config.distance_measure
        bf = config.brute_force
        if bf is not None and bf.block_sweep:
            # an explicit ExactReorderingConfig wins for the re-rank depth
            pre_k = (int(config.exact_reordering.num_candidates)
                     if config.exact_reordering is not None
                     else int(bf.block_sweep_pre_k))
            self._impl: Searcher = BlockSweepSearcher(
                dataset, BlockSweepConfig(
                    distance_measure=measure, pre_reorder_k=pre_k,
                    sweep_dtype=bf.block_sweep_dtype,
                    top2=bool(bf.block_sweep_top2),
                    rerank_dtype=_rerank_dtype_of(config.exact_reordering)),
                device=self.device)
            self.search_mode = SearchMode.BRUTE_FORCE
        elif bf is not None and bf.scalar_quantization:
            self._impl = ScalarQuantizedBruteForceSearcher(
                dataset, ScalarQuantizedConfig(
                    distance_measure=measure,
                    storage="int4" if bf.quantization_bits == 4 else "int8"),
                device=self.device)
            self.search_mode = SearchMode.BRUTE_FORCE
        elif config.partitioning is not None and config.hash is not None:
            self._impl = TreeXHybridSearcher(
                _tree_cfg_of(config), device=self.device).build(dataset)
            self.search_mode = SearchMode.TREE_AH
        elif config.partitioning is not None:
            self._impl = PartitionedSearcher(
                dataset, config=_partitioner_cfg_of(config),
                num_partitions_to_search=int(
                    config.partitioning.num_partitions_to_search),
                distance_measure=measure, device=self.device)
            self.search_mode = SearchMode.PARTITIONED
        elif config.hash is not None:
            self._impl = AsymmetricHasher(_hash_to_ah_config(
                config.hash, for_tree_ah=False, measure=measure,
                rerank_dtype=_rerank_dtype_of(config.exact_reordering)),
                device=self.device).build(dataset)
            self.search_mode = SearchMode.HASHED
        else:
            self._impl = BruteForceSearcher(dataset, measure,
                                            device=self.device)
            self.search_mode = SearchMode.BRUTE_FORCE

    # -- constructors ---------------------------------------------------------
    @classmethod
    def brute_force(cls, dataset: DenseDataset,
                    measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
                    device: Union[str, torch.device] = DEFAULT_DEVICE
                    ) -> "Scann":
        return cls(dataset,
                   ScannConfig(distance_measure=measure).with_brute_force(),
                   device=device)

    @classmethod
    def partitioned(cls, dataset: DenseDataset, num_partitions: int,
                    partitions_to_search: int,
                    device: Union[str, torch.device] = DEFAULT_DEVICE
                    ) -> "Scann":
        cfg = ScannConfig().with_partitioning()
        cfg.partitioning.num_partitions = num_partitions
        cfg.partitioning.num_partitions_to_search = partitions_to_search
        return cls(dataset, cfg, device=device)

    @classmethod
    def hashed(cls, dataset: DenseDataset, num_blocks: int,
               device: Union[str, torch.device] = DEFAULT_DEVICE
               ) -> "Scann":
        cfg = ScannConfig().with_hashing()
        cfg.hash.num_blocks = num_blocks
        return cls(dataset, cfg, device=device)

    @classmethod
    def auto(cls, dataset: DenseDataset,
             measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
             target_recall: Optional[float] = None,
             tune_queries: Optional[np.ndarray] = None,
             seed: int = 0, mesh=None, device=DEFAULT_DEVICE) -> "Scann":
        """The JAX package's scale-, profile- and recall-driven build."""
        if mesh is not None:
            raise _mesh_unported()
        raise _auto_unported("Scann.auto")

    def describe(self) -> dict:
        """The chosen mode, the inner searcher's class and the shape."""
        return {
            "search_mode": self.search_mode.value,
            "impl": type(self._impl).__name__,
            "n": self.dataset_size(),
            "dim": self.dimensionality(),
            "distance_measure": self._config.distance_measure.value,
        }

    # -- delegation -----------------------------------------------------------
    @property
    def config(self) -> ScannConfig:
        return self._config

    @property
    def impl(self) -> Searcher:
        return self._impl

    def distance_measure(self) -> DistanceMeasure:
        return self._config.distance_measure

    def dataset_size(self) -> int:
        return self._dataset.size

    @property
    def size(self) -> int:
        return self._dataset.size

    def dimensionality(self) -> int:
        return self._dataset.dimensionality

    def search_arguments(self, k: Optional[int] = None,
                         params: Optional[SearchParameters] = None,
                         query_config=None
                         ) -> Tuple[int, Optional[SearchParameters]]:
        """(k, params) the facade passes to its searcher: ``query_config``
        (config.QueryConfig) fills what explicit ``k`` / ``params`` leave
        unset; k defaults to the config's num_neighbors; HASHED mode with an
        ExactReorderingConfig re-ranks its num_candidates unless the params
        set a depth."""
        if query_config is not None:
            qp = query_config.to_search_parameters()
            if k is None:
                k = qp.num_neighbors
            if params is None:
                params = qp
        k = k if k is not None else self._config.num_neighbors
        if (self._config.exact_reordering is not None
                and self.search_mode == SearchMode.HASHED):
            if params is None:
                params = SearchParameters()
            if params.pre_reordering_num_neighbors is None:
                params = dataclasses.replace(
                    params, pre_reordering_num_neighbors=(
                        self._config.exact_reordering.num_candidates))
        return k, params

    def search_batched_arrays(self, queries: np.ndarray,
                              k: Optional[int] = None,
                              params: Optional[SearchParameters] = None,
                              query_config=None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy, from
        the inner searcher (explicit ``params`` and ``k`` win over
        ``query_config``)."""
        k, params = self.search_arguments(k, params, query_config)
        return self._impl.search_batched_arrays(queries, k, params)

    def search_batched_tensors(self, queries: torch.Tensor,
                               k: Optional[int] = None,
                               params: Optional[SearchParameters] = None,
                               query_config=None):
        """(ids [B, k] int64, distances [B, k] float32) on the device, from
        the inner searcher's tensor search; no host copy of the results."""
        k, params = self.search_arguments(k, params, query_config)
        return self._impl.search_batched_tensors(queries, k, params)


class ScannBuilder:
    """Fluent builder of a :class:`Scann`."""

    def __init__(self):
        self._config = ScannConfig()
        self._auto = False

    def num_neighbors(self, k: int) -> "ScannBuilder":
        self._config.num_neighbors = k
        return self

    def distance_measure(self, measure: DistanceMeasure) -> "ScannBuilder":
        self._config.distance_measure = measure
        return self

    def brute_force(self) -> "ScannBuilder":
        self._config.with_brute_force()
        return self

    def tree(self, num_partitions: int,
             partitions_to_search: int) -> "ScannBuilder":
        self._config.with_partitioning()
        self._config.partitioning.num_partitions = num_partitions
        self._config.partitioning.num_partitions_to_search = \
            partitions_to_search
        return self

    def hash(self, num_blocks: int, num_buckets: int = 256) -> "ScannBuilder":
        self._config.with_hashing()
        self._config.hash.num_blocks = num_blocks
        self._config.hash.num_buckets = num_buckets
        return self

    def reorder(self, num_candidates: int) -> "ScannBuilder":
        self._config.with_reordering()
        self._config.exact_reordering.num_candidates = num_candidates
        return self

    def auto(self) -> "ScannBuilder":
        """Defer the architecture to the dataset's scale at build time
        (raises there: ROADMAP.md item 10b)."""
        self._auto = True
        return self

    def build(self, dataset: DenseDataset,
              device: Union[str, torch.device] = DEFAULT_DEVICE) -> Scann:
        if self._auto:
            raise _auto_unported("ScannBuilder.auto().build")
        return Scann(dataset, self._config, device=device)
