"""Quantization: dataset statistics, int8/int4 scalar quantization,
bfloat16 and fp8 datasets (counterpart of ``scann_tpu/quantization``)."""

from scann_tpu_torch.quantization.bfloat16 import BFloat16Dataset
from scann_tpu_torch.quantization.fp8 import (
    Fp8Dataset,
    Fp8Format,
    Fp8Quantizer,
)
from scann_tpu_torch.quantization.scalar import (
    PrecomputedQuery,
    QuantizedDataset,
    ScalarQuantizer,
    ScalarQuantizerConfig,
)
from scann_tpu_torch.quantization.stats import QuantizationStats

__all__ = [
    "BFloat16Dataset",
    "Fp8Dataset",
    "Fp8Format",
    "Fp8Quantizer",
    "PrecomputedQuery",
    "QuantizationStats",
    "QuantizedDataset",
    "ScalarQuantizer",
    "ScalarQuantizerConfig",
]
