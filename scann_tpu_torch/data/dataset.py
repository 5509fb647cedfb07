"""Dataset containers (counterpart of ``scann_tpu/data/dataset.py``).

``DenseDataset`` is a host numpy copy, optional docids and one cached
device tensor. ``Datapoint`` is the owned dense-or-sparse point type.
``SparseDataset`` is a list of sparse datapoints, the input of
``models/sparse_brute_force.SparseBruteForceSearcher``.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.docid import DocIdCollection
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


class Datapoint:
    """Owned dense-or-sparse datapoint. Sparse indices are kept sorted
    (``get`` binary-searches them), whatever the construction order."""

    def __init__(self, values: np.ndarray,
                 indices: Optional[np.ndarray] = None,
                 dimensionality: Optional[int] = None):
        self.values = np.asarray(values)
        self.indices = (None if indices is None
                        else np.asarray(indices, dtype=np.int64))
        if self.indices is not None:
            if len(self.indices) != len(self.values):
                raise ScannError.invalid_argument(
                    "indices/values length mismatch")
            if len(self.indices) > 1 and np.any(np.diff(self.indices) < 0):
                order = np.argsort(self.indices, kind="stable")
                self.indices = self.indices[order]
                self.values = self.values[order]
            self.dimensionality = dimensionality if dimensionality is not None \
                else (int(self.indices.max()) + 1 if len(self.indices) else 0)
        else:
            self.dimensionality = len(self.values)

    @classmethod
    def dense(cls, values) -> "Datapoint":
        return cls(np.asarray(values))

    @classmethod
    def sparse(cls, indices, values,
               dimensionality: Optional[int] = None) -> "Datapoint":
        return cls(np.asarray(values), np.asarray(indices), dimensionality)

    @property
    def is_dense(self) -> bool:
        return self.indices is None

    @property
    def is_sparse(self) -> bool:
        return self.indices is not None

    def get(self, dim: int) -> float:
        """Value at dimension ``dim``: O(1) dense, a binary search sparse."""
        if self.is_dense:
            return float(self.values[dim])
        pos = np.searchsorted(self.indices, dim)
        if pos < len(self.indices) and self.indices[pos] == dim:
            return float(self.values[pos])
        return 0.0

    def to_dense(self) -> "Datapoint":
        if self.is_dense:
            return self
        out = np.zeros(self.dimensionality,
                       dtype=np.asarray(self.values).dtype)
        out[self.indices] = self.values
        return Datapoint(out)

    def squared_l2_norm(self) -> float:
        v = self.values.astype(np.float64)
        return float(np.dot(v, v))

    def l2_norm(self) -> float:
        return math.sqrt(self.squared_l2_norm())

    def normalize(self) -> "Datapoint":
        n = self.l2_norm()
        if n == 0.0:
            return self
        return Datapoint(self.values / n, self.indices, self.dimensionality)


class DenseDataset:
    """[N, D] dataset (float32 unless ``dtype`` says otherwise), with
    optional docids. ``device()`` / ``device_tensor()`` upload once and
    cache; asking for another device replaces the cache, and ``append``
    drops it. The card needs no row padding, so the tensor is exactly
    [N, D]."""

    def __init__(self, data: np.ndarray, docids: Optional[Iterable] = None,
                 dtype=np.float32):
        data = np.asarray(data, dtype=dtype)
        if data.ndim != 2:
            raise ScannError.invalid_argument(
                f"expected [N, D] array, got shape {data.shape}")
        self._data = data
        self._docids = DocIdCollection(docids) if docids is not None else None
        if self._docids is not None and len(self._docids) != data.shape[0]:
            raise ScannError.invalid_argument("docid count != datapoint count")
        self._device_cache: Optional[torch.Tensor] = None

    @classmethod
    def from_vecs(cls, vecs: Sequence[Sequence[float]], docids=None,
                  dtype=np.float32) -> "DenseDataset":
        return cls(np.asarray(vecs, dtype=dtype), docids=docids, dtype=dtype)

    @classmethod
    def from_flat(cls, flat: Sequence[float], dimensionality: int,
                  docids=None, dtype=np.float32) -> "DenseDataset":
        arr = np.asarray(flat, dtype=dtype)
        if dimensionality <= 0 or arr.size % dimensionality != 0:
            raise ScannError.invalid_argument(
                f"flat length {arr.size} not divisible by dimensionality "
                f"{dimensionality}")
        return cls(arr.reshape(-1, dimensionality), docids=docids,
                   dtype=dtype)

    @classmethod
    def empty(cls, dimensionality: int, dtype=np.float32) -> "DenseDataset":
        return cls(np.zeros((0, dimensionality), dtype=dtype), dtype=dtype)

    def __len__(self) -> int:
        return self._data.shape[0]

    @property
    def size(self) -> int:
        return self._data.shape[0]

    @property
    def dimensionality(self) -> int:
        return self._data.shape[1]

    @property
    def is_empty(self) -> bool:
        return self.size == 0

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def docids(self) -> Optional[DocIdCollection]:
        return self._docids

    def get(self, index: int) -> np.ndarray:
        if not 0 <= index < self.size:
            raise ScannError.out_of_range(
                f"index {index} out of range [0, {self.size})")
        return self._data[index]

    def __getitem__(self, index: int) -> np.ndarray:
        return self.get(index)

    def numpy(self) -> np.ndarray:
        """Host view [N, D]."""
        return self._data

    def append(self, point: np.ndarray, docid=None) -> int:
        """Append one row (and its docid); its index. Drops the device
        cache."""
        point = np.asarray(point, dtype=self._data.dtype)
        if point.shape != (self.dimensionality,):
            raise ScannError.invalid_argument(
                f"point shape {point.shape} != ({self.dimensionality},)")
        self._data = np.concatenate([self._data, point[None, :]], axis=0)
        if docid is not None:
            if self._docids is None:
                self._docids = DocIdCollection()
            self._docids.add(docid)
        self._device_cache = None
        return self.size - 1

    def device(self, device: Union[str, torch.device] = DEFAULT_DEVICE
               ) -> Tuple[torch.Tensor, int]:
        """(tensor [N, D] on ``device``, N), cached until ``append``."""
        return self.device_tensor(require_device(device)), self.size

    def device_tensor(self, device: Union[str, torch.device]) -> torch.Tensor:
        """[N, D] tensor on ``device``, cached."""
        device = torch.device(device)
        cached = self._device_cache
        if cached is None or cached.device != _canonical(device):
            self._device_cache = torch.from_numpy(self._data).to(device)
        return self._device_cache

    def drop_device_cache(self) -> None:
        """Free the cached device tensor; the host copy stays."""
        self._device_cache = None

    def memory_usage_bytes(self) -> int:
        """Bytes of the host copy."""
        return int(self._data.nbytes)


class SparseDataset:
    """Sparse datapoints over ``dimensionality`` columns, kept on the host
    in append order."""

    def __init__(self, dimensionality: int):
        self._dim = dimensionality
        self._points: List[Datapoint] = []

    @property
    def dimensionality(self) -> int:
        return self._dim

    @property
    def size(self) -> int:
        return len(self._points)

    def __len__(self) -> int:
        return len(self._points)

    def append(self, indices, values) -> int:
        """Append one point (its indices may repeat and come in any order;
        ``Datapoint`` sorts them); its index."""
        dp = Datapoint.sparse(indices, values, self._dim)
        if len(dp.indices) and int(dp.indices.max()) >= self._dim:
            raise ScannError.out_of_range("sparse index beyond dimensionality")
        self._points.append(dp)
        return len(self._points) - 1

    def get(self, index: int) -> Datapoint:
        return self._points[index]

    def to_dense(self) -> DenseDataset:
        """[N, D] float32 rows; a repeated index keeps its last value."""
        out = np.zeros((len(self._points), self._dim), dtype=np.float32)
        for i, p in enumerate(self._points):
            out[i, p.indices] = p.values
        return DenseDataset(out)

    def to_padded_csr(self, max_nnz: Optional[int] = None,
                      device: Union[str, torch.device] = DEFAULT_DEVICE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(indices [N, max_nnz] int32 padded with -1, values [N, max_nnz]
        float32 padded with 0) on ``device``; a point with more than
        ``max_nnz`` entries keeps its first ``max_nnz``."""
        if max_nnz is None:
            max_nnz = max((len(p.values) for p in self._points), default=1)
        n = len(self._points)
        idx = np.full((n, max_nnz), -1, dtype=np.int32)
        val = np.zeros((n, max_nnz), dtype=np.float32)
        for i, p in enumerate(self._points):
            m = min(len(p.values), max_nnz)
            idx[i, :m] = p.indices[:m]
            val[i, :m] = p.values[:m]
        device = require_device(device)
        return (torch.from_numpy(idx).to(device),
                torch.from_numpy(val).to(device))


def _canonical(device: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` name the same device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
