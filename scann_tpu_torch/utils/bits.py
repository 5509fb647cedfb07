"""Bit utilities on the host (counterpart of ``scann_tpu/utils/bits.py``;
reference: src/utils/bits.rs:4-180)."""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

_POPCOUNT_TABLE = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def popcount(x: int) -> int:
    return bin(int(x)).count("1")


def popcount_bytes(data: np.ndarray) -> int:
    """Total set bits over a byte array."""
    return int(_POPCOUNT_TABLE[np.asarray(data, dtype=np.uint8)].sum())


def hamming_distance_bytes(a: np.ndarray, b: np.ndarray) -> int:
    """Bitwise Hamming distance over byte strings (reference: bits.rs:30-45)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return int(_POPCOUNT_TABLE[np.bitwise_xor(a, b)].sum())


def hamming_distance_batch(query: np.ndarray, db: np.ndarray) -> np.ndarray:
    """[B] query bytes vs [N, B] database byte codes -> [N] distances."""
    x = np.bitwise_xor(np.asarray(db, np.uint8), np.asarray(query, np.uint8)[None, :])
    return _POPCOUNT_TABLE[x].sum(axis=1).astype(np.int64)


def pack_bits(bits: Iterable[bool]) -> np.ndarray:
    """Pack booleans into bytes, LSB-first (reference: bits.rs:80-110)."""
    bits = np.asarray(list(bits), dtype=bool)
    return np.packbits(bits, bitorder="little")


def unpack_bits(data: np.ndarray, n_bits: int) -> np.ndarray:
    return np.unpackbits(np.asarray(data, np.uint8), bitorder="little")[:n_bits].astype(bool)


class BitIterator:
    """Iterate set-bit positions (reference: bits.rs:120-160)."""

    def __init__(self, data: np.ndarray):
        self._data = np.asarray(data, dtype=np.uint8)

    def __iter__(self) -> Iterator[int]:
        for byte_idx, byte in enumerate(self._data):
            b = int(byte)
            while b:
                low = b & (-b)
                yield byte_idx * 8 + low.bit_length() - 1
                b ^= low


def next_power_of_two(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def log2_ceil(x: int) -> int:
    if x <= 1:
        return 0
    return (x - 1).bit_length()
