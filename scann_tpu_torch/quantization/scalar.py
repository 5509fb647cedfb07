"""Int8/int4 scalar quantization (counterpart of
``scann_tpu/quantization/scalar.py``), byte for byte the JAX package's
codec:

    levels    = 2^bits - 1
    calibrate: [min, max] from an explicit range, the symmetric abs-max, or
               mean +- num_std_devs * std clipped to the observed min/max
    quantize:  q = clamp(floor((clamp(v, min, max) - min) * inv_scale + 0.5),
                         0, levels)           (half away from zero, v >= min)
    dequant:   v' = u8(q) * scale + min

Codes are uint8 on the host (``raw_data_i8`` gives the reference's i8
view). Arrays of 2**22 values or more quantize on the quantizer's device,
with the same float32 operations in the same order, so both codecs give the
same bytes. Every scalar of the device codec is a float32 tensor: PyTorch
applies a Python scalar in its own way (``scalar / tensor`` multiplies by a
rounded reciprocal), and only tensor-by-tensor float32 operations are the
numpy codec's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset, _canonical
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.ops.scoring_kernels import INT8_DOTS_TILE_N
from scann_tpu_torch.quantization.stats import QuantizationStats
from scann_tpu_torch.types import DEFAULT_DEVICE, align_up, require_device

# arrays of at least this many values quantize on the device
DEVICE_CODEC_MIN_VALUES = 1 << 22


@dataclasses.dataclass
class ScalarQuantizerConfig:
    """The JAX package's ``ScalarQuantizerConfig``, field for field."""

    bits: int = 8
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    symmetric: bool = False
    num_std_devs: float = 3.0

    def with_range(self, lo: float, hi: float) -> "ScalarQuantizerConfig":
        self.min_value, self.max_value = lo, hi
        return self


class ScalarQuantizer:
    """Calibrated scalar quantizer. ``device`` (the current CUDA device by
    default) runs the codec for arrays of 2**22 values or more."""

    def __init__(self, config: Optional[ScalarQuantizerConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config or ScalarQuantizerConfig()
        if self.config.bits not in (4, 8):
            raise ScannError.invalid_argument(
                f"bits must be 4 or 8, got {self.config.bits}")
        self.device = torch.device(device)
        self.num_levels = (1 << self.config.bits) - 1
        self.min_value = 0.0
        self.max_value = 1.0
        self.scale = 1.0
        self.inv_scale = 1.0
        self.zero_point = 0

    def calibrate(self, stats: QuantizationStats) -> "ScalarQuantizer":
        cfg = self.config
        if cfg.min_value is not None and cfg.max_value is not None:
            self.min_value, self.max_value = cfg.min_value, cfg.max_value
        elif cfg.symmetric:
            abs_max = max(abs(stats.min_value), abs(stats.max_value))
            self.min_value, self.max_value = -abs_max, abs_max
        else:
            rng = cfg.num_std_devs * stats.std_dev
            self.min_value = max(stats.mean - rng, stats.min_value)
            self.max_value = min(stats.mean + rng, stats.max_value)
        span = self.max_value - self.min_value
        if span > 1e-10:
            self.scale = span / self.num_levels
            self.inv_scale = self.num_levels / span
            self.zero_point = int(round(-self.min_value * self.inv_scale))
        else:
            self.scale = 1.0
            self.inv_scale = 1.0
            self.zero_point = 0
        return self

    def calibrate_from_dataset(self, dataset: DenseDataset
                               ) -> "ScalarQuantizer":
        return self.calibrate(QuantizationStats.from_dataset(dataset))

    def calibrate_from_array(self, arr: np.ndarray) -> "ScalarQuantizer":
        return self.calibrate(QuantizationStats.from_array(arr))

    # -- codec -----------------------------------------------------------
    def quantize(self, values: np.ndarray) -> np.ndarray:
        """float32 -> uint8 codes 0..num_levels."""
        values = np.asarray(values, dtype=np.float32)
        if values.size >= DEVICE_CODEC_MIN_VALUES:
            return self._quantize_device(values)
        v = np.clip(values, self.min_value, self.max_value)
        # floor(x + 0.5), not numpy's banker's rounding: the reference rounds
        # half away from zero, and x >= 0 here
        q = np.floor((v - self.min_value) * np.float32(self.inv_scale)
                     + 0.5).astype(np.int64)
        return np.clip(q, 0, self.num_levels).astype(np.uint8)

    def _quantize_device(self, values: np.ndarray) -> np.ndarray:
        """The host codec's float32 operations on ``self.device``."""
        device = require_device(self.device)

        def f32(x: float) -> torch.Tensor:
            return torch.tensor(x, dtype=torch.float32, device=device)

        v = torch.from_numpy(values).to(device)
        lo, hi = f32(self.min_value), f32(self.max_value)
        q = (torch.clamp(v, lo, hi) - lo) * f32(self.inv_scale) + f32(0.5)
        q = torch.clamp(torch.floor(q), f32(0.0), f32(self.num_levels))
        return q.to(torch.uint8).cpu().numpy()

    def dequantize(self, codes: np.ndarray) -> np.ndarray:
        """uint8 codes (or the reference's i8 bytes) -> float32."""
        c = np.asarray(codes)
        u = c.view(np.uint8) if c.dtype == np.int8 else c.astype(np.uint8)
        return (u.astype(np.float32) * np.float32(self.scale)
                + np.float32(self.min_value))

    def quantize_value(self, value: float) -> int:
        return int(self.quantize(np.array([value]))[0])

    def dequantize_value(self, code: int) -> float:
        return float(self.dequantize(np.array([code & 0xFF],
                                              dtype=np.uint8))[0])


class PrecomputedQuery:
    """Per-query 256-entry dequantization table: ``dequant(code)`` for every
    byte, for host-side scalar scoring. The device path folds the codec into
    one product instead (``ops/asymmetric.py``)."""

    def __init__(self, query: np.ndarray, quantizer: ScalarQuantizer):
        self.query = np.asarray(query, dtype=np.float32)
        self.dequant_table = quantizer.dequantize(
            np.arange(256, dtype=np.uint8))

    def squared_l2_to_codes(self, codes: np.ndarray) -> float:
        """Exact distance between the query and one quantized row."""
        vals = self.dequant_table[np.asarray(codes, np.uint8)]
        diff = self.query - vals
        return float((diff * diff).sum())


class QuantizedDataset:
    """uint8 codes on the host plus the calibration, with two device
    layouts, each cached per device:

      - :meth:`device`: [N, D] uint8 codes and the squared norms of the
        dequantized rows;
      - :meth:`device_transposed`: [D, N_pad] uint8 codes for the int8-dots
        kernel, N padded with code-0 rows to its column tile, and the
        squared norms of the padded rows.
    """

    def __init__(self, codes: np.ndarray, quantizer: ScalarQuantizer):
        codes = np.asarray(codes, dtype=np.uint8)
        if codes.ndim != 2:
            raise ScannError.invalid_argument("codes must be [N, D]")
        self.codes = codes
        self.quantizer = quantizer
        self._cache: Dict[Tuple[str, bool], Tuple[torch.Tensor,
                                                  torch.Tensor]] = {}

    @classmethod
    def from_dataset(cls, dataset: DenseDataset,
                     quantizer: Optional[ScalarQuantizer] = None
                     ) -> "QuantizedDataset":
        q = quantizer or ScalarQuantizer()
        q.calibrate_from_dataset(dataset)
        return cls(q.quantize(dataset.numpy()), q)

    @property
    def size(self) -> int:
        return self.codes.shape[0]

    @property
    def dimensionality(self) -> int:
        return self.codes.shape[1]

    def raw_data_i8(self) -> np.ndarray:
        """The reference's byte-identical i8 view."""
        return self.codes.view(np.int8)

    def get_quantized(self, index: int) -> np.ndarray:
        return self.codes[index]

    def dequantize_row(self, index: int) -> np.ndarray:
        return self.quantizer.dequantize(self.codes[index])

    def dequantize_all(self) -> np.ndarray:
        return self.quantizer.dequantize(self.codes)

    def memory_usage_bytes(self) -> int:
        return int(self.codes.nbytes)

    def compression_ratio(self) -> float:
        return 4.0  # float32 -> one byte per value

    def _norms(self, codes_dev: torch.Tensor) -> torch.Tensor:
        """Squared norms of the dequantized rows [N] float32."""
        scale = torch.tensor(self.quantizer.scale, dtype=torch.float32,
                             device=codes_dev.device)
        lo = torch.tensor(self.quantizer.min_value, dtype=torch.float32,
                          device=codes_dev.device)
        d = codes_dev.float() * scale + lo
        return (d * d).sum(dim=1)

    def _cached(self, device, transposed: bool):
        device = _canonical(require_device(device))
        key = (str(device), transposed)
        if key not in self._cache:
            n_pad = align_up(max(self.size, 1), INT8_DOTS_TILE_N) \
                if transposed else self.size
            codes = torch.zeros(n_pad, self.dimensionality, dtype=torch.uint8,
                                device=device)
            codes[:self.size] = torch.from_numpy(self.codes).to(device)
            norms = self._norms(codes)
            if transposed:
                codes = codes.T.contiguous()
            self._cache[key] = (codes, norms)
        return self._cache[key]

    def device(self, device: Union[str, torch.device]
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(codes [N, D] uint8, dequantized squared norms [N] float32, N)."""
        codes, norms = self._cached(device, False)
        return codes, norms, self.size

    def device_transposed(self, device: Union[str, torch.device]
                          ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(codes [D, N_pad] uint8, squared norms [N_pad] float32, N) for
        the int8-dots kernel; N_pad is N rounded up to its column tile."""
        codes, norms = self._cached(device, True)
        return codes, norms, self.size
