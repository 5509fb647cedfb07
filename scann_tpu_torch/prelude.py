"""Convenience prelude (counterpart of ``scann_tpu/prelude.py``): ``from
scann_tpu_torch.prelude import *`` brings the common names."""

from scann_tpu_torch import (
    BruteForceSearcher,
    DenseDataset,
    DistanceMeasure,
    DocIdCollection,
    ErrorCode,
    ExactReorderingConfig,
    HashConfig,
    NNResult,
    PartitionedSearcher,
    PartitioningConfig,
    ScalarQuantizedBruteForceSearcher,
    ScalarQuantizedConfig,
    Scann,
    ScannBuilder,
    ScannConfig,
    ScannError,
    SearchMode,
    SearchParameters,
    SearchResult,
    SparseBruteForceSearcher,
    SparseDataset,
    TreeXHybridConfig,
    TreeXHybridSearcher,
    load_index,
    save_index,
)
from scann_tpu_torch.hashes import (
    AsymmetricHasher,
    AsymmetricHasherConfig,
    Codebook,
)
from scann_tpu_torch.mutator import (
    DynamicSearcher,
    MutableDataset,
    MutationBuffer,
)
from scann_tpu_torch.restricts import (
    CrowdingConstraint,
    NoRestrict,
    PredicateFilter,
    RangeFilter,
    RestrictAllowlist,
)
from scann_tpu_torch.trees.kmeans import KMeans, KMeansConfig

__all__ = [
    "BruteForceSearcher", "DenseDataset", "DistanceMeasure", "DocIdCollection",
    "ErrorCode", "ExactReorderingConfig", "HashConfig", "NNResult",
    "PartitionedSearcher", "PartitioningConfig",
    "ScalarQuantizedBruteForceSearcher", "ScalarQuantizedConfig", "Scann",
    "ScannBuilder", "ScannConfig", "ScannError", "SearchMode",
    "SearchParameters", "SearchResult", "SparseBruteForceSearcher",
    "SparseDataset", "TreeXHybridConfig", "TreeXHybridSearcher",
    "load_index", "save_index", "AsymmetricHasher", "AsymmetricHasherConfig",
    "Codebook", "DynamicSearcher", "MutableDataset", "MutationBuffer",
    "CrowdingConstraint", "NoRestrict", "PredicateFilter", "RangeFilter",
    "RestrictAllowlist", "KMeans", "KMeansConfig",
]
