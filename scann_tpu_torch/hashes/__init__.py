"""PQ hashing: codebooks, lookup tables, LUT16 packing and the asymmetric
hasher searcher."""

from scann_tpu_torch.hashes.hasher import (
    AsymmetricHasher,
    AsymmetricHasherConfig,
)

__all__ = ["AsymmetricHasher", "AsymmetricHasherConfig"]
