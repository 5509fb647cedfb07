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
``ScannBuilder.auto()`` choose the config from the dataset's scale, the
card's profile (``utils/chip_profile``) and, given a recall target, sample
statistics (``utils/advisor``) and tuned serving parameters
(``utils/autotune``); given a ``mesh``, ``Scann.auto`` builds and serves
a sharded tree-x-AH (``parallel/sharded_flagship``) when the rows pass one
card's budget.
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
from scann_tpu_torch.utils.trace import span


class SearchMode(enum.Enum):
    BRUTE_FORCE = "BruteForce"
    PARTITIONED = "Partitioned"
    HASHED = "Hashed"
    TREE_AH = "TreeAH"


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
    """Pick an architecture from the dataset's scale (the reference always
    requires an explicit mode), as the JAX package does
    (``scann_tpu/models/scann.py:114-169``), with the crossovers of the
    card's profile (``utils/chip_profile.load_profile``):

    - up to ``sweep_max_n`` points, the bf16 block sweep with its exact
      re-rank: it streams every row, so its recall does not depend on
      cluster skew, and below the crossover its batch is the cheaper;
    - past it, tree-x-AH with a partition every ``partition_density``
      points (at least 256, at most 65,536, rounded to 256), p=10, LUT16
      codes at about two dimensions a subspace (the divisor of ``dim``
      closest to that: a prime ``dim`` gets one dimension a subspace, not
      one whole-vector subspace, which would carry almost no information)
      and a re-rank of 150, in bfloat16 once the float32 rows pass
      ``f32_rerank_max_bytes``.
    """
    from scann_tpu_torch.utils.chip_profile import load_profile

    prof = load_profile()
    cfg = ScannConfig(distance_measure=measure)
    if n <= prof.sweep_max_n and not force_tree:
        cfg.with_brute_force()
        cfg.brute_force.block_sweep = True
        return cfg
    dens = max(int(prof.partition_density), 1)
    parts = int(min(max(256, round(n / dens / 256) * 256), 65536))
    cfg.with_partitioning()
    cfg.partitioning.num_partitions = parts
    cfg.partitioning.num_partitions_to_search = 10
    cfg.with_hashing()
    cfg.hash.num_buckets = 16
    blocks = min((s for s in range(1, dim + 1) if dim % s == 0),
                 key=lambda s: (abs(dim / s - 2), -s), default=1)
    cfg.hash.num_blocks = max(blocks, 1)
    cfg.with_reordering()
    cfg.exact_reordering.num_candidates = 150
    if n * dim * 4 > prof.f32_rerank_max_bytes:
        cfg.exact_reordering.rerank_dtype = "bfloat16"
    return cfg


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
        # the mesh-aware auto() records its decision here, as the JAX
        # facade does; describe() reports it
        self._auto_decision = None
        self.default_params: Optional[SearchParameters] = None
        self.autotune_result = None
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
             seed: int = 0, mesh=None,
             device: Union[str, torch.device] = DEFAULT_DEVICE) -> "Scann":
        """Architecture and build knobs from the dataset's scale, the card's
        profile and, with a ``target_recall``, cheap sample statistics
        (``utils/advisor.advise_config`` over 20,000 sampled rows: SOAR and
        the balance cap turn on where the sample shows skewed cluster
        mass), as the JAX package does (``scann_tpu/models/scann.py:
        279-371``).

        With ``target_recall`` set, the serving parameters are then tuned on
        ``tune_queries`` (default: 256 sampled rows of the dataset) and
        become the facade's defaults, so a search without explicit
        parameters meets the target. The host draws are the JAX package's,
        in its order, so both packages sample the same rows.

        ``mesh`` (a :class:`~scann_tpu_torch.parallel.mesh.Mesh` over a
        "db" axis) makes the choice mesh-aware, as in the JAX package: when
        the re-rank copy of the rows passes the one-card budget (the
        profile's ``f32_rerank_max_bytes``), auto() takes the tree
        architecture, builds it over the mesh with the rows only ever
        sharded (``ShardedTreeXHybridSearcher.build``) and serves the
        sharded wrapper; within the budget it keeps the single-device
        build. :meth:`describe` reports the decision."""
        n, dim = dataset.size, dataset.dimensionality
        rng = np.random.default_rng(seed)
        data = None
        if target_recall is None:
            cfg = auto_config(n, dim, measure)
        else:
            from scann_tpu_torch.utils.advisor import advise_config

            data = dataset.numpy()
            sample_idx = rng.choice(n, min(n, 20_000), replace=False)
            cfg = advise_config(n, dim, data[sample_idx], measure,
                                target_recall, seed=seed, device=device)
            cfg.num_neighbors = 10

        self = None
        if mesh is not None and mesh.devices.size > 1:
            from scann_tpu_torch.utils.chip_profile import load_profile

            prof = load_profile()
            rdt = _rerank_dtype_of(cfg.exact_reordering)
            itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[rdt]
            serving_bytes = n * dim * itemsize
            budget = int(prof.f32_rerank_max_bytes)
            shards_needed = max(1, -(-serving_bytes // budget))
            if shards_needed > 1:
                if cfg.partitioning is None or cfg.hash is None:
                    # past one card's budget the sweep's two copies of the
                    # rows bind harder still: the tree it is
                    cfg = auto_config(n, dim, measure, force_tree=True)
                from scann_tpu_torch.parallel.sharded_flagship import (
                    ShardedTreeXHybridSearcher,
                )

                impl = ShardedTreeXHybridSearcher.build(
                    dataset, _tree_cfg_of(cfg), mesh)
                self = cls(dataset, cfg, _impl=impl,
                           _mode=SearchMode.TREE_AH, device=device)
                self._auto_decision = {
                    "sharded": True, "shards": int(mesh.devices.size),
                    "shards_needed": int(shards_needed),
                    "serving_bytes": int(serving_bytes),
                    "per_chip_budget": budget,
                    "reason": "serving bytes exceed one-chip budget",
                }
        if self is None:
            self = cls(dataset, cfg, device=device)
            if mesh is not None:
                self._auto_decision = {
                    "sharded": False,
                    "reason": "fits one chip; single-device build kept",
                }
        if target_recall is None:
            return self
        if data is None:
            data = dataset.numpy()
        if tune_queries is None:
            tune_queries = data[rng.choice(n, min(n, 256), replace=False)]
        from scann_tpu_torch.utils.autotune import autotune

        res = autotune(self, np.asarray(tune_queries, np.float32),
                       k=cfg.num_neighbors, target_recall=target_recall)
        self.default_params = res.params
        self.autotune_result = res
        return self

    def describe(self) -> dict:
        """The chosen mode, the inner searcher's class, the shape and, after
        ``auto(target_recall=...)``, the tuned parameters."""
        out = {
            "search_mode": self.search_mode.value,
            "impl": type(self._impl).__name__,
            "n": self.dataset_size(),
            "dim": self.dimensionality(),
            "distance_measure": self._config.distance_measure.value,
        }
        if self._auto_decision:
            out["auto"] = dict(self._auto_decision)
        if self.autotune_result is not None:
            out["autotuned_params"] = str(self.autotune_result.params)
        return out

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

    def _docids(self):
        return self._dataset.docids

    def search_arguments(self, k: Optional[int] = None,
                         params: Optional[SearchParameters] = None,
                         query_config=None
                         ) -> Tuple[int, Optional[SearchParameters]]:
        """(k, params) the facade passes to its searcher: ``query_config``
        (config.QueryConfig) fills what explicit ``k`` / ``params`` leave
        unset, then the parameters ``auto(target_recall=...)`` tuned; k
        defaults to the config's num_neighbors; HASHED mode with an
        ExactReorderingConfig re-ranks its num_candidates unless the params
        set a depth."""
        if query_config is not None:
            qp = query_config.to_search_parameters()
            if k is None:
                k = qp.num_neighbors
            if params is None:
                params = qp
        if params is None:
            params = self.default_params
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
        with span("scann.search"):
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
        (:func:`auto_config`)."""
        self._auto = True
        return self

    def build(self, dataset: DenseDataset,
              device: Union[str, torch.device] = DEFAULT_DEVICE) -> Scann:
        if self._auto:
            cfg = auto_config(dataset.size, dataset.dimensionality,
                              self._config.distance_measure)
            cfg.num_neighbors = self._config.num_neighbors
            return Scann(dataset, cfg, device=device)
        return Scann(dataset, self._config, device=device)
