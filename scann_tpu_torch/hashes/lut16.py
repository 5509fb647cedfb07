"""LUT16: 4-bit PQ codes and their packing (counterpart of
``scann_tpu/hashes/lut16.py``).

Byte-for-byte the JAX package's layout: two codes per byte, **low nibble
first** — byte = (code[2i] & 0xF) | ((code[2i+1] & 0xF) << 4); an odd
subspace count leaves the last high nibble zero. The host functions are the
JAX package's numpy code; :func:`pack_codes_4bit_device` packs a code tensor
where it lies (the hasher packs on the card).

``Lut16SimdTables`` is the u8 globally quantized table codec the fused
sweep's int8 tables come from (``hashes/lut.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes.lut import quantize_luts_u8


def pack_codes_4bit(codes: np.ndarray) -> np.ndarray:
    """[N, S] codes (0..15) -> [N, ceil(S/2)] packed bytes, low nibble first."""
    codes = np.asarray(codes)
    if codes.max(initial=0) > 15:
        raise ScannError.invalid_argument("4-bit packing requires codes <= 15")
    n, s = codes.shape
    if s % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), codes.dtype)], axis=1)
    lo = codes[:, 0::2].astype(np.uint8) & 0x0F
    hi = (codes[:, 1::2].astype(np.uint8) & 0x0F) << 4
    return (lo | hi).astype(np.uint8)


def unpack_codes_4bit(packed: np.ndarray, num_subspaces: int) -> np.ndarray:
    """[N, ceil(S/2)] bytes -> [N, S] codes 0..15."""
    packed = np.asarray(packed, dtype=np.uint8)
    n = packed.shape[0]
    out = np.zeros((n, packed.shape[1] * 2), dtype=np.uint8)
    out[:, 0::2] = packed & 0x0F
    out[:, 1::2] = (packed >> 4) & 0x0F
    return out[:, :num_subspaces]


def pack_codes_4bit_device(codes: torch.Tensor) -> torch.Tensor:
    """:func:`pack_codes_4bit` on a [N, S] uint8 tensor (codes <= 15, not
    checked: the encoder's codes are below its C), on the tensor's device."""
    n, s = codes.shape
    if s % 2:
        codes = torch.cat([codes, codes.new_zeros(n, 1)], dim=1)
    return (codes[:, 0::2] & 0x0F) | ((codes[:, 1::2] & 0x0F) << 4)


def unpack_codes_4bit_device(packed: torch.Tensor,
                             num_subspaces: int) -> torch.Tensor:
    """:func:`unpack_codes_4bit` on a [N, ceil(S/2)] uint8 tensor, on the
    tensor's device."""
    out = torch.stack([packed & 0x0F, (packed >> 4) & 0x0F], dim=-1)
    return out.reshape(packed.shape[0], -1)[:, :num_subspaces]


class PackedCodes4Bit:
    """Packed 4-bit code matrix (host numpy)."""

    def __init__(self, data: np.ndarray, num_subspaces: int,
                 num_datapoints: int):
        self.data = np.asarray(data, dtype=np.uint8)
        self.num_subspaces = int(num_subspaces)
        self.num_datapoints = int(num_datapoints)

    @classmethod
    def from_codes(cls, codes: np.ndarray) -> "PackedCodes4Bit":
        codes = np.asarray(codes)
        return cls(pack_codes_4bit(codes), codes.shape[1], codes.shape[0])

    @property
    def bytes_per_point(self) -> int:
        return (self.num_subspaces + 1) // 2

    def get_codes(self, index: int) -> np.ndarray:
        return unpack_codes_4bit(self.data[index:index + 1],
                                 self.num_subspaces)[0]

    def unpack_all(self) -> np.ndarray:
        return unpack_codes_4bit(self.data, self.num_subspaces)

    def raw_bytes(self) -> np.ndarray:
        """The flat byte stream, row after row."""
        return self.data.reshape(-1)


class Lut16SimdTables:
    """u8 globally quantized 16-entry tables (host numpy).

    dequant(sum_u8) = sum * multiplier + bias * num_subspaces
    """

    def __init__(self, packed_tables: np.ndarray, bias: float,
                 multiplier: float):
        self.packed_tables = np.asarray(packed_tables, dtype=np.uint8)  # [S, 16]
        self.bias = float(bias)
        self.multiplier = float(multiplier)

    @classmethod
    def from_float_tables(cls, tables: np.ndarray) -> "Lut16SimdTables":
        tables = np.asarray(tables, dtype=np.float32)
        q, mult, bias = quantize_luts_u8(tables[None, ...])
        return cls(q[0], float(bias[0]), float(mult[0]))

    @property
    def num_subspaces(self) -> int:
        return self.packed_tables.shape[0]

    def compute_distances_batch(self, packed_codes: np.ndarray,
                                num_datapoints: Optional[int] = None
                                ) -> np.ndarray:
        """Host scoring of packed codes with the quantized tables."""
        codes = unpack_codes_4bit(
            np.asarray(packed_codes, np.uint8).reshape(
                num_datapoints or -1, (self.num_subspaces + 1) // 2),
            self.num_subspaces,
        )
        sums = self.packed_tables[
            np.arange(self.num_subspaces)[None, :], codes.astype(np.int64)
        ].astype(np.uint32).sum(axis=1)
        return (sums.astype(np.float32) * self.multiplier
                + self.bias * self.num_subspaces)
