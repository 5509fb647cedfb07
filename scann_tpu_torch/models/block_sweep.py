"""Block-sweep searcher: bf16 block-min sweep + exact re-rank (counterpart of
``scann_tpu/models/block_sweep.py``).

Stores the database once as bf16 rows augmented with their squared norm
(``ops/sweep.py``), so the whole first pass is one product per tile in the
CUDA sweep kernel; the ``pre_k`` survivors are then re-ranked exactly in
float32. No training: the index is the augmented copy, the float32 re-rank
rows in the same stored order and the inverse of the stride shuffle.

This slice serves SQUARED_L2, DOT_PRODUCT, COSINE and GENERAL_INNER_PRODUCT
with a float32, bfloat16 or int8 re-rank store (``utils/reordering``), the
bf16 or int8 sweep copy, top-1 or top-2 blocks, the stride shuffle,
pre/post epsilons and fused allowlists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.models.searcher import (
    SearchParameters,
    Searcher,
    epsilons,
    pad_results_to_k,
)
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.ops.sweep import (
    INT8_NORM_DIGIT_MAX,
    build_allow_penalty,
    build_augmented_db,
    build_int8_augmented_db,
    qmajor_step_rows,
    shuffle_stride_for,
    sweep_search,
)
from scann_tpu_torch.types import DEFAULT_DEVICE, cdiv, require_device
from scann_tpu_torch.utils.reordering import (
    build_rerank_store,
    rerank_store_bytes,
)

_SWEEP_MEASURES = (DistanceMeasure.SQUARED_L2, DistanceMeasure.DOT_PRODUCT,
                   DistanceMeasure.GENERAL_INNER_PRODUCT,
                   DistanceMeasure.COSINE)


@dataclasses.dataclass
class BlockSweepConfig:
    """The JAX package's ``BlockSweepConfig``, field for field."""

    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    # candidates kept per query for the exact re-rank
    pre_reorder_k: int = 100
    # r:1 in-kernel reduction — one candidate survives per r-point block
    block_r: int = 32
    # row padding unit of the sweep copy (rows pad to a multiple of the
    # q-major step rounded up to tile_n)
    tile_n: int = 2048
    # queries per sweep program (half of it under top2)
    max_batch: int = 1024
    # re-rank the two smallest per block (the tournament kernel)
    top2: bool = False
    # stride-shuffle rows at build so cluster-sorted datasets spread over
    # the blocks; survivors' ids resolve through the inverse table
    shuffle: bool = True
    # dtype of the re-rank store: "float32", "bfloat16" (half the bytes) or
    # "int8" (a quarter: the per-dimension affine codec)
    rerank_dtype: str = "float32"
    # dtype of the streamed sweep copy: "bfloat16" or "int8"
    sweep_dtype: str = "bfloat16"


class BlockSweepSearcher(Searcher):
    """bf16 block-min sweep + exact float32 re-rank on ``device`` (the
    current CUDA device unless the caller names another)."""

    def __init__(self, dataset: DenseDataset,
                 config: Optional[BlockSweepConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        if not isinstance(dataset, DenseDataset):
            raise ScannError.invalid_argument(
                "BlockSweepSearcher needs a DenseDataset")
        cfg = config or BlockSweepConfig()
        if cfg.distance_measure not in _SWEEP_MEASURES:
            raise ScannError.invalid_argument(
                f"BlockSweepSearcher does not support {cfg.distance_measure}")
        if cfg.tile_n % cfg.block_r:
            raise ScannError.invalid_argument("tile_n must be divisible by r")
        if cfg.rerank_dtype not in ("float32", "bfloat16", "int8"):
            raise ScannError.invalid_argument(
                f"rerank_dtype must be float32, bfloat16 or int8, got "
                f"{cfg.rerank_dtype!r}")
        if cfg.sweep_dtype not in ("bfloat16", "int8"):
            raise ScannError.invalid_argument(
                f"sweep_dtype must be bfloat16 or int8, got "
                f"{cfg.sweep_dtype!r}")
        self._config = cfg
        self._dataset = dataset
        self._measure = cfg.distance_measure
        self.device = torch.device(device)
        self._state = None      # (aug, re-rank store, n) on the device
        self._aug_scales: Optional[torch.Tensor] = None
        self._aug_sn = 0.0
        self._inv_perm: Optional[torch.Tensor] = None
        self._inv_host: Optional[np.ndarray] = None

    # -- metadata -----------------------------------------------------------
    @property
    def config(self) -> BlockSweepConfig:
        return self._config

    @property
    def dataset(self) -> DenseDataset:
        return self._dataset

    def dataset_size(self) -> int:
        return self._dataset.size

    def dimensionality(self) -> int:
        return self._dataset.dimensionality

    def _docids(self):
        return self._dataset.docids

    def memory_usage(self) -> int:
        """Device bytes beyond the raw dataset: the augmented sweep copy plus
        a low-precision re-rank store (the float32 re-rank rows are the
        dataset itself, in stored order, and are not counted — as in the
        JAX package)."""
        if self._state is None:
            return 0
        aug, rows, _ = self._state
        total = aug.numel() * aug.element_size()
        if self._config.rerank_dtype != "float32":
            total += rerank_store_bytes(rows)
        return total

    # -- device state ---------------------------------------------------------
    def device_state(self):
        """(augmented sweep copy [N_pad, D1] bf16 or int8, re-rank store in
        the same stored order, N), built on the device once. The store is
        the float32 rows [N, D], or for ``rerank_dtype`` bfloat16 / int8 the
        low-precision store encoded on the host and uploaded once
        (:func:`~scann_tpu_torch.utils.reordering.build_rerank_store`).

        Rows pad to a multiple of the q-major step rounded up to tile_n, as
        in the JAX package, so the same kernel forms apply. With the shuffle
        on, row i is stored at (i * s) % N and ``_inv_perm`` maps a stored
        position back to its id."""
        n = self._dataset.size
        if self._state is not None and self._state[2] == n:
            return self._state
        device = require_device(self.device)
        cfg = self._config
        pad_to = cfg.tile_n * cdiv(qmajor_step_rows(cfg.block_r), cfg.tile_n)
        data = self._dataset.numpy()
        if cfg.shuffle and n > 1:
            stride = shuffle_stride_for(n)
            pos = (np.arange(n, dtype=np.int64) * stride) % n
            inv = np.empty(n, np.int64)
            inv[pos] = np.arange(n, dtype=np.int64)
            self._inv_host = inv
            self._inv_perm = torch.from_numpy(inv).to(device)
            data_p = data[inv]
        else:
            stride, self._inv_perm, self._inv_host = 0, None, None
            data_p = data
        if cfg.rerank_dtype != "float32":
            rows, _ = build_rerank_store(data_p, n, cfg.rerank_dtype, 1,
                                         device)
        elif data_p is data:
            rows = self._dataset.device_tensor(device)
        else:
            rows = torch.from_numpy(data_p).to(device)
        if cfg.sweep_dtype == "int8":
            aug, scales, self._aug_sn = build_int8_augmented_db(
                data, n, self._measure, tile_n=pad_to, shuffle_stride=stride)
            self._aug_scales = scales.to(device)
        else:
            aug = build_augmented_db(data, n, self._measure, tile_n=pad_to,
                                     shuffle_stride=stride)
        self._state = (aug.to(device), rows, n)
        return self._state

    # -- search -----------------------------------------------------------------
    def _allow_penalty(self, allow_mask, n_pad: int) -> torch.Tensor:
        """The allowlist as the sweep's fused [N_pad/r, r] penalty stream:
        exact filter semantics at any selectivity, since denied rows never
        take their block's slot."""
        kw = {}
        if self._config.sweep_dtype == "int8":
            kw["mask_value"] = 4.0 * INT8_NORM_DIGIT_MAX * self._aug_sn
        return build_allow_penalty(allow_mask, n_pad, self._config.block_r,
                                   inv_perm=self._inv_host, **kw)

    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None,
                               allow_mask=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) for [B, D] float32
        queries on the searcher's device, -1 / inf where a result is
        missing; no host copy of the results. ``allow_mask`` ([N] bool,
        host) restricts the results to the allowed ids."""
        n = self.dataset_size()
        if n == 0:
            raise ScannError.failed_precondition("dataset is empty")
        k = min(int(k), n)
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")
        cfg = self._config
        pre_k = max(cfg.pre_reorder_k, k)
        if params is not None and \
                params.pre_reordering_num_neighbors is not None:
            pre_k = max(int(params.pre_reordering_num_neighbors), k)
        pre_eps, post_eps = epsilons(params)
        aug, db, _ = self.device_state()
        allow_pen = None
        if allow_mask is not None:
            allow_pen = self._allow_penalty(allow_mask, aug.shape[0]).to(
                aug.device)
        # one survivor per r-block (two with top2) caps usable pre_k — and
        # with it the usable k; the output pads back to the requested k
        pre_k = min(pre_k, aug.shape[0] // cfg.block_r)
        k_kern = min(k, pre_k * (2 if cfg.top2 else 1))
        queries = queries.to(aug.device).float()
        max_batch = cfg.max_batch // 2 if cfg.top2 else cfg.max_batch
        out_d, out_i = [], []
        for lo in range(0, queries.shape[0], max_batch):
            dists, idx = sweep_search(
                aug, db, queries[lo:lo + max_batch], pre_eps, post_eps,
                inv_perm=self._inv_perm, aug_scales=self._aug_scales,
                allow_pen=allow_pen, pre_k=pre_k, k=k_kern,
                measure=self._measure, r=cfg.block_r, top2=cfg.top2,
                aug_sn=self._aug_sn)
            out_d.append(dists)
            out_i.append(idx)
        return pad_results_to_k(torch.cat(out_i), torch.cat(out_d), k)

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask=None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        queries = self._validate_queries(queries)
        idx, dists = self.search_batched_tensors(
            torch.from_numpy(queries), k, params, allow_mask)
        return (idx.cpu().numpy().astype(np.int32),
                dists.cpu().numpy().astype(np.float32))
