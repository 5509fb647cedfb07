"""Quantized-database brute-force searcher: int8, int4, bf16 and fp8
storage (counterpart of ``scann_tpu/models/scalar_quantized.py``).

Exact search over the dequantized rows: asymmetric scoring
(``ops/asymmetric.py``) then the tie-free top-k, in query chunks as the
exact brute-force searcher runs them. On a CUDA device int8 and int4 codes
take the transposed [D, N_pad] layout and the int8-dots kernel (the JAX
package's dispatch: on the accelerator, when the dataset has a transposed
layout); on the CPU, and for bf16 and fp8 storage, the raw dots are a
float32 product of the cast codes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.models.brute_force import exact_top_k
from scann_tpu_torch.models.searcher import SearchParameters, Searcher
from scann_tpu_torch.ops.asymmetric import asymmetric_many_to_many
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.quantization.bfloat16 import BFloat16Dataset
from scann_tpu_torch.quantization.fp8 import Fp8Dataset, Fp8Format
from scann_tpu_torch.quantization.scalar import (
    QuantizedDataset,
    ScalarQuantizer,
    ScalarQuantizerConfig,
)
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


@dataclasses.dataclass
class ScalarQuantizedConfig:
    """The JAX package's ``ScalarQuantizedConfig``, field for field."""

    quantizer_config: ScalarQuantizerConfig = dataclasses.field(
        default_factory=ScalarQuantizerConfig)
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    # "int8" / "int4" use the scalar codec; "bf16", "fp8_e4m3" and
    # "fp8_e5m2" store floating-point values
    storage: str = "int8"


class ScalarQuantizedBruteForceSearcher(Searcher):
    """Exact search over a quantized copy of ``dataset``, built on
    ``device`` (the current CUDA device unless the caller names another)."""

    def __init__(self, dataset: DenseDataset,
                 config: Optional[ScalarQuantizedConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        cfg = config or ScalarQuantizedConfig()
        self.device = require_device(device)
        self._config = cfg
        self._measure = cfg.distance_measure
        self._dim = dataset.dimensionality
        self._docid_table = dataset.docids
        storage = cfg.storage
        if storage in ("int8", "int4"):
            qcfg = dataclasses.replace(cfg.quantizer_config)
            if storage == "int4":
                qcfg.bits = 4
            quantizer = ScalarQuantizer(qcfg, device=self.device)
            self._quantized = QuantizedDataset.from_dataset(dataset,
                                                            quantizer)
            self._scale = float(quantizer.scale)
            self._offset = float(quantizer.min_value)
        elif storage == "bf16":
            self._quantized = BFloat16Dataset.from_f32(dataset.numpy())
            self._scale, self._offset = 1.0, 0.0
        elif storage in ("fp8_e4m3", "fp8_e5m2"):
            fmt = Fp8Format.E4M3 if storage == "fp8_e4m3" else Fp8Format.E5M2
            self._quantized = Fp8Dataset(dataset.numpy(), fmt)
            self._scale, self._offset = 1.0, 0.0
        else:
            raise ScannError.invalid_argument(f"unknown storage {storage!r}")

    @classmethod
    def from_quantized(cls, quantized: QuantizedDataset,
                       distance_measure: DistanceMeasure =
                       DistanceMeasure.SQUARED_L2,
                       device: Union[str, torch.device] = DEFAULT_DEVICE
                       ) -> "ScalarQuantizedBruteForceSearcher":
        """Wrap an already-quantized dataset."""
        self = cls.__new__(cls)
        self.device = require_device(device)
        self._config = ScalarQuantizedConfig(
            distance_measure=distance_measure)
        self._measure = distance_measure
        self._dim = quantized.dimensionality
        self._docid_table = None
        self._quantized = quantized
        self._scale = float(quantized.quantizer.scale)
        self._offset = float(quantized.quantizer.min_value)
        return self

    # -- metadata ---------------------------------------------------------
    @property
    def quantized_dataset(self):
        return self._quantized

    def dataset_size(self) -> int:
        return self._quantized.size

    def dimensionality(self) -> int:
        return self._dim

    def _docids(self):
        return self._docid_table

    def memory_usage(self) -> int:
        """Stored codes plus one float32 norm per row."""
        return self._quantized.memory_usage_bytes() + 4 * self._quantized.size

    def compression_ratio(self) -> float:
        return self._quantized.compression_ratio()

    # -- search -------------------------------------------------------------
    def uses_kernel(self) -> bool:
        """Whether searches take the transposed codes and the int8-dots
        kernel: int8 / int4 codes on a CUDA device."""
        return (self.device.type == "cuda"
                and isinstance(self._quantized, QuantizedDataset))

    def device_codes(self) -> Tuple[torch.Tensor, torch.Tensor, int, bool]:
        """(codes, dequantized squared norms, N, transposed) as searches
        use them: [D, N_pad] uint8 for the kernel, else [N, D] codes cast to
        float32 once per call."""
        transposed = self.uses_kernel()
        if transposed:
            codes, norms, n = self._quantized.device_transposed(self.device)
        else:
            codes, norms, n = self._quantized.device(self.device)
        return codes, norms, n, transposed

    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) for [B, D] float32
        queries on the searcher's device, -1 / inf where a result is
        missing."""
        n = self.dataset_size()
        if n == 0:
            raise ScannError.failed_precondition("dataset is empty")
        k = min(int(k), n)
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")
        codes, norms, n, transposed = self.device_codes()
        if not transposed:
            codes = codes.float()
        eps = params.effective_epsilon() if params is not None else np.inf
        queries = queries.to(codes.device).float()
        return exact_top_k(
            lambda qc: asymmetric_many_to_many(
                self._measure, qc, codes, norms, self._scale, self._offset,
                codes_transposed=transposed),
            queries, norms.shape[0], n, k, eps)

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        queries = self._validate_queries(queries)
        idx, dists = self.search_batched_tensors(torch.from_numpy(queries), k,
                                                 params)
        return (idx.cpu().numpy().astype(np.int32),
                dists.cpu().numpy().astype(np.float32))
