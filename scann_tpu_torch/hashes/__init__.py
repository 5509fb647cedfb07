"""Product quantization and asymmetric hashing: codebooks, lookup tables,
LUT16 packing, the hasher searcher and stacked / additive residual
quantizers (``hashes.stacked``)."""

from scann_tpu_torch.hashes.codebook import Codebook, CodebookConfig
from scann_tpu_torch.hashes.hasher import (
    AsymmetricHasher,
    AsymmetricHasherConfig,
)
from scann_tpu_torch.hashes.lut import LookupTable, LookupTableInt8
from scann_tpu_torch.hashes.lut16 import Lut16SimdTables, PackedCodes4Bit

__all__ = [
    "Codebook",
    "CodebookConfig",
    "LookupTable",
    "LookupTableInt8",
    "PackedCodes4Bit",
    "Lut16SimdTables",
    "AsymmetricHasher",
    "AsymmetricHasherConfig",
]
