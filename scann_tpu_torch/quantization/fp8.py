"""fp8 (E4M3 / E5M2) quantization (counterpart of
``scann_tpu/quantization/fp8.py``).

The codec is PyTorch's cast to ``torch.float8_e4m3fn`` / ``float8_e5m2``
(round to nearest even): for values inside the format's range it gives the
JAX package's ``ml_dtypes`` bytes. :class:`Fp8Quantizer` saturates by
clipping to +-max before the cast, as the JAX package does. The dataset
casts without clipping, as the JAX package does; there, past the E4M3 range,
``ml_dtypes`` gives NaN and PyTorch saturates at +-448 (E5M2 overflows to
inf in both).
"""

from __future__ import annotations

import enum
from typing import Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import _canonical
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.quantization.bfloat16 import float64_sq_norms
from scann_tpu_torch.types import require_device


class Fp8Format(enum.Enum):
    E4M3 = "E4M3"
    E5M2 = "E5M2"

    @property
    def torch_dtype(self) -> torch.dtype:
        return (torch.float8_e4m3fn if self is Fp8Format.E4M3
                else torch.float8_e5m2)

    @property
    def max_value(self) -> float:
        return 448.0 if self is Fp8Format.E4M3 else 57344.0


class Fp8Quantizer:
    """Elementwise fp8 codec on host tensors."""

    def __init__(self, fmt: Fp8Format = Fp8Format.E4M3):
        self.format = fmt

    def quantize(self, values: np.ndarray) -> torch.Tensor:
        """float32 -> fp8 tensor, saturating at +-max."""
        v = torch.from_numpy(np.ascontiguousarray(values, dtype=np.float32))
        m = self.format.max_value
        return v.clamp(-m, m).to(self.format.torch_dtype)

    def dequantize(self, codes: torch.Tensor) -> np.ndarray:
        return torch.as_tensor(codes).to(self.format.torch_dtype).float() \
            .numpy()

    def encode_bits(self, value: float) -> int:
        """float32 -> raw fp8 byte."""
        return int(self.quantize(np.array([value])).view(torch.uint8)[0])

    def decode_bits(self, bits: int) -> float:
        """raw fp8 byte -> float32."""
        raw = torch.tensor([bits & 0xFF], dtype=torch.uint8)
        return float(raw.view(self.format.torch_dtype).float()[0])


class Fp8Dataset:
    """[N, D] fp8 dataset: a host tensor plus one cached device copy."""

    def __init__(self, data: np.ndarray, fmt: Fp8Format = Fp8Format.E4M3):
        data = np.asarray(data)
        if data.ndim != 2:
            raise ScannError.invalid_argument("expected [N, D]")
        self.format = fmt
        self._data = torch.from_numpy(np.ascontiguousarray(
            data, dtype=np.float32)).to(fmt.torch_dtype)
        self._device_cache = None

    @property
    def size(self) -> int:
        return self._data.shape[0]

    @property
    def dimensionality(self) -> int:
        return self._data.shape[1]

    def to_f32(self) -> np.ndarray:
        return self._data.float().numpy()

    def raw_bytes(self) -> np.ndarray:
        return self._data.view(torch.uint8).numpy()

    def memory_usage_bytes(self) -> int:
        return self._data.numel()

    def compression_ratio(self) -> float:
        return 4.0

    def device(self, device: Union[str, torch.device]
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(codes [N, D] fp8, squared norms [N] float32, N) on ``device``,
        cached."""
        device = require_device(device)
        cached = self._device_cache
        if cached is None or cached[0].device != _canonical(device):
            self._device_cache = (self._data.to(device),
                                  float64_sq_norms(self._data).to(device))
        return self._device_cache[0], self._device_cache[1], self.size
