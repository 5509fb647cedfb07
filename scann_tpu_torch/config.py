"""Configuration dataclasses (counterpart of ``scann_tpu/config.py``).

JSON-round-trippable configs with ``with_*`` fluent setters that return
``self``. Field names, defaults, enum values and ``to_dict`` output are the
JAX package's, so ``save_index`` writes the dict the JAX package writes and
each package's ``from_json`` reads the other's JSON.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass
from typing import Any, Optional

from scann_tpu_torch.ops.distances import DistanceMeasure


class HashType(enum.Enum):
    """Hashing algorithm."""

    ASYMMETRIC_HASHING = "AsymmetricHashing"
    PRODUCT_QUANTIZATION = "ProductQuantization"


class LutFormat(enum.Enum):
    """Lookup-table numeric format."""

    INT8 = "Int8"
    INT16 = "Int16"
    FLOAT = "Float"


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


class _JsonMixin:
    def to_dict(self) -> dict:
        return _to_jsonable(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            t = _FIELD_TYPES.get((cls.__name__, f.name))
            if v is None:
                # nested and enum fields take None as absent; a plain field
                # keeps an explicit None (max_partition_size None = balancing
                # off, against its "auto" default)
                if t is None:
                    kwargs[f.name] = None
                continue
            if t is not None:
                v = t.from_dict(v) if isinstance(v, dict) else t(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


@dataclass
class BruteForceConfig(_JsonMixin):
    """Brute-force search config."""

    scalar_quantization: bool = False
    quantization_bits: int = 0
    # the bf16 block-min sweep + exact re-rank (models/block_sweep.py):
    # approximate, not exact brute force
    block_sweep: bool = False
    block_sweep_pre_k: int = 100
    # dtype of the streamed sweep copy: "bfloat16" or "int8"
    block_sweep_dtype: str = "bfloat16"
    # keep the two smallest a block (the tournament kernel)
    block_sweep_top2: bool = False

    def with_scalar_quantization(self, bits: int = 8) -> "BruteForceConfig":
        self.scalar_quantization = True
        self.quantization_bits = bits
        return self

    def with_block_sweep(self, pre_k: int = 100,
                         sweep_dtype: str = "bfloat16",
                         top2: bool = False) -> "BruteForceConfig":
        self.block_sweep = True
        self.block_sweep_pre_k = pre_k
        self.block_sweep_dtype = sweep_dtype
        self.block_sweep_top2 = top2
        return self


@dataclass
class PartitioningConfig(_JsonMixin):
    """K-means partitioning config."""

    num_partitions: int = 100
    num_partitions_to_search: int = 10
    max_training_iterations: int = 100
    convergence_threshold: float = 1e-5
    num_levels: int = 1
    spilling: bool = False
    spilling_threshold: float = 0.0
    # "distance" or "soar" secondary assignments (TreePartitionerConfig)
    spilling_mode: str = "distance"
    soar_lambda: float = 1.0
    # rows k-means trains on (None = the whole dataset)
    training_sample_size: Optional[int] = None
    # partition balance cap ("auto" = 1.5x the mean size, None = off) and
    # the principal-axis split of partitions still over it
    max_partition_size: Optional[object] = "auto"
    split_stragglers: bool = True

    def with_partitions_to_search(self, n: int) -> "PartitioningConfig":
        self.num_partitions_to_search = n
        return self

    def with_spilling(self, threshold: float) -> "PartitioningConfig":
        self.spilling = True
        self.spilling_threshold = threshold
        return self

    def with_soar(self, soar_lambda: float = 1.0) -> "PartitioningConfig":
        self.spilling = True
        self.spilling_mode = "soar"
        self.soar_lambda = soar_lambda
        return self

    def with_levels(self, levels: int) -> "PartitioningConfig":
        self.num_levels = levels
        return self


@dataclass
class HashConfig(_JsonMixin):
    """Asymmetric-hashing config."""

    hash_type: HashType = HashType.ASYMMETRIC_HASHING
    num_buckets: int = 256
    num_blocks: int = 16
    lut_format: LutFormat = LutFormat.INT8
    training_sample_size: int = 100_000
    # score-aware anisotropic codebook training (hashes/avq.py), e.g. 0.2
    # for MIPS / cosine; None = plain reconstruction-loss PQ
    anisotropic_threshold: Optional[float] = None

    def with_type(self, hash_type: HashType) -> "HashConfig":
        self.hash_type = hash_type
        return self

    def with_buckets(self, buckets: int) -> "HashConfig":
        self.num_buckets = buckets
        return self

    def with_blocks(self, blocks: int) -> "HashConfig":
        self.num_blocks = blocks
        return self

    def with_lut_format(self, fmt: LutFormat) -> "HashConfig":
        self.lut_format = fmt
        return self

    def with_anisotropic_threshold(self, t: Optional[float]) -> "HashConfig":
        self.anisotropic_threshold = t
        return self


@dataclass
class ExactReorderingConfig(_JsonMixin):
    """Exact re-ranking config."""

    num_candidates: int = 100
    quantized: bool = False
    # dtype of the re-rank store: "float32", "bfloat16" or "int8" (int8 is
    # also what quantized=True selects)
    rerank_dtype: str = "float32"

    def with_quantized(self) -> "ExactReorderingConfig":
        self.quantized = True
        return self


@dataclass
class QueryConfig(_JsonMixin):
    """Per-query overrides, honoured through ``to_search_parameters`` and
    the ``Scann`` facade's ``query_config`` argument."""

    num_neighbors: Optional[int] = None
    num_partitions_to_search: Optional[int] = None
    reordering_num_candidates: Optional[int] = None
    epsilon: Optional[float] = None

    def to_search_parameters(self):
        """Partitions -> leaves to search, reordering candidates -> pre_k,
        epsilon -> the threshold on the final (reported) distances, so one
        epsilon means the same in every search mode."""
        from scann_tpu_torch.models.searcher import SearchParameters

        return SearchParameters(
            num_neighbors=self.num_neighbors,
            num_leaves_to_search=self.num_partitions_to_search,
            pre_reordering_num_neighbors=self.reordering_num_candidates,
            post_reordering_epsilon=self.epsilon,
        )


@dataclass
class ScannConfig(_JsonMixin):
    """Top-level searcher config."""

    num_neighbors: int = 10
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    brute_force: Optional[BruteForceConfig] = None
    partitioning: Optional[PartitioningConfig] = None
    hash: Optional[HashConfig] = None
    exact_reordering: Optional[ExactReorderingConfig] = None

    def with_num_neighbors(self, k: int) -> "ScannConfig":
        self.num_neighbors = k
        return self

    def with_distance_measure(self, measure: DistanceMeasure
                              ) -> "ScannConfig":
        self.distance_measure = measure
        return self

    def with_brute_force(self, cfg: Optional[BruteForceConfig] = None
                         ) -> "ScannConfig":
        self.brute_force = cfg or BruteForceConfig()
        return self

    def with_partitioning(self, cfg: Optional[PartitioningConfig] = None
                          ) -> "ScannConfig":
        self.partitioning = cfg or PartitioningConfig()
        return self

    def with_hashing(self, cfg: Optional[HashConfig] = None) -> "ScannConfig":
        self.hash = cfg or HashConfig()
        return self

    def with_reordering(self, cfg: Optional[ExactReorderingConfig] = None
                        ) -> "ScannConfig":
        self.exact_reordering = cfg or ExactReorderingConfig()
        return self

    def has_partitioning(self) -> bool:
        return self.partitioning is not None

    def has_hashing(self) -> bool:
        return self.hash is not None

    def has_reordering(self) -> bool:
        return self.exact_reordering is not None


# nested and enum field coercion of from_dict
_FIELD_TYPES = {
    ("ScannConfig", "distance_measure"): DistanceMeasure,
    ("ScannConfig", "brute_force"): BruteForceConfig,
    ("ScannConfig", "partitioning"): PartitioningConfig,
    ("ScannConfig", "hash"): HashConfig,
    ("ScannConfig", "exact_reordering"): ExactReorderingConfig,
    ("HashConfig", "hash_type"): HashType,
    ("HashConfig", "lut_format"): LutFormat,
}
