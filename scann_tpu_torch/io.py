"""Index loading (counterpart of the ``kind == "tree_ah"``,
``"block_sweep"``, ``"hashed"``, ``"brute_force"`` and
``"scalar_quantized"`` readers of ``scann_tpu/io.py``).

The file format is the JAX package's ``save_index`` npz: every array plus a
JSON header (``__meta__``, uint8 bytes) with the config and index kind. This
module reads it with numpy and ``json`` alone, so a tree-AH, block-sweep,
asymmetric-hashing, brute-force or scalar-quantized index saved by the JAX
package serves through the port (a scalar-quantized index with its very
codes, so both packages score the same bytes). A tree-AH index carries its
whole state across: spilled (multi-assignment) CSR tables, the centres a
balanced build grew past ``num_partitions``, per-assignment codes, the
re-rank dtype and layout and the measure (a cosine index's rows were
normalized at build). Other index kinds wait for ROADMAP.md queue 1, item 9.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes.codebook import Codebook, CodebookConfig
from scann_tpu_torch.hashes.hasher import (
    AsymmetricHasher,
    AsymmetricHasherConfig,
)
from scann_tpu_torch.models.block_sweep import (
    BlockSweepConfig,
    BlockSweepSearcher,
)
from scann_tpu_torch.models.brute_force import BruteForceSearcher
from scann_tpu_torch.models.scalar_quantized import (
    ScalarQuantizedBruteForceSearcher,
    ScalarQuantizedConfig,
)
from scann_tpu_torch.models.tree_x_hybrid import (
    TreeXHybridConfig,
    TreeXHybridSearcher,
)
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.partitioning.partitioner import DatabaseTokenization
from scann_tpu_torch.partitioning.tree_partitioner import (
    TreePartitioner,
    TreePartitionerConfig,
)
from scann_tpu_torch.quantization.scalar import (
    QuantizedDataset,
    ScalarQuantizer,
    ScalarQuantizerConfig,
)
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device

_FORMAT_VERSION = 1


def _hash_config(d: dict) -> AsymmetricHasherConfig:
    """A saved hasher config; the measure is stored as its JSON string."""
    fields = {f.name for f in dataclasses.fields(AsymmetricHasherConfig)}
    d = {k: v for k, v in d.items() if k in fields}
    if "distance_measure" in d:
        d["distance_measure"] = DistanceMeasure(d["distance_measure"])
    return AsymmetricHasherConfig(**d)


def _hashed(arrays: Dict[str, np.ndarray], meta: dict,
            device: torch.device) -> AsymmetricHasher:
    """The JAX package's ``kind == "hashed"`` reader: the codebook, the
    [N, S] codes and, when the index stored it, the float32 dataset (already
    normalized for COSINE)."""
    h = AsymmetricHasher(_hash_config(meta["config"]), device=device)
    book = arrays["codebook"]
    cb = Codebook(CodebookConfig(num_codes=book.shape[1],
                                 num_subspaces=book.shape[0]), device=device)
    cb.centroids = torch.from_numpy(np.ascontiguousarray(book)).to(
        device).float()
    h.codebook = cb
    h.codes = torch.from_numpy(np.ascontiguousarray(arrays["codes"])).to(
        device).to(torch.uint8)
    h._n = len(arrays["codes"])
    h._dim = int(meta["dim"])
    if "data" in arrays:
        h._dataset = DenseDataset(arrays["data"])
    return h


def _block_sweep(arrays: Dict[str, np.ndarray], meta: dict,
                 device: torch.device) -> BlockSweepSearcher:
    """The JAX package's ``kind == "block_sweep"`` reader: the data and the
    config; the sweep copy is rebuilt from them on first search."""
    return BlockSweepSearcher(DenseDataset(arrays["data"]), BlockSweepConfig(
        distance_measure=DistanceMeasure(meta["measure"]),
        pre_reorder_k=int(meta["pre_reorder_k"]),
        block_r=int(meta["block_r"]), tile_n=int(meta["tile_n"]),
        max_batch=int(meta["max_batch"]), top2=bool(meta["top2"]),
        shuffle=bool(meta.get("shuffle", True)),
        rerank_dtype=str(meta.get("rerank_dtype", "float32")),
        sweep_dtype=str(meta.get("sweep_dtype", "bfloat16"))), device=device)


def _scalar_quantized(arrays: Dict[str, np.ndarray], meta: dict,
                      device: torch.device
                      ) -> ScalarQuantizedBruteForceSearcher:
    """The JAX package's ``kind == "scalar_quantized"`` reader: int8 / int4
    codes with their calibration (the range's top rebuilt as min + scale *
    levels), or the float32 data of a bf16 / fp8 index, re-encoded."""
    measure = DistanceMeasure(meta["measure"])
    if "codes" in arrays:
        quant = ScalarQuantizer(ScalarQuantizerConfig(bits=meta["bits"]),
                                device=device)
        quant.min_value = meta["min_value"]
        quant.scale = meta["scale"]
        quant.max_value = meta["min_value"] + meta["scale"] * quant.num_levels
        quant.inv_scale = 1.0 / meta["scale"] if meta["scale"] else 1.0
        return ScalarQuantizedBruteForceSearcher.from_quantized(
            QuantizedDataset(arrays["codes"], quant), measure, device=device)
    return ScalarQuantizedBruteForceSearcher(
        DenseDataset(arrays["data"]),
        ScalarQuantizedConfig(distance_measure=measure,
                              storage=meta["storage"]), device=device)


_READERS = {
    "block_sweep": _block_sweep,
    "hashed": _hashed,
    "brute_force": lambda arrays, meta, device: BruteForceSearcher(
        DenseDataset(arrays["data"]), DistanceMeasure(meta["measure"]),
        device=device),
    "scalar_quantized": _scalar_quantized,
}


def from_numpy_state(arrays: Dict[str, np.ndarray], meta: dict,
                     device: Union[str, torch.device] = DEFAULT_DEVICE):
    """A port searcher on ``device`` (the current CUDA device by default)
    from a saved index's arrays and its JSON header — the state
    ``scann_tpu.io.save_index`` writes: a tree-AH index (data, centers --
    as many as the build made --, primary tokens, the CSR tables csr_offsets
    and csr_points with every assignment, per-assignment codes, codebook),
    a block-sweep or
    brute-force index (data), an asymmetric-hashing index (codes, codebook,
    data when stored) or a scalar-quantized index (codes, or data)."""
    kind = meta.get("kind")
    if kind != "tree_ah" and kind not in _READERS:
        raise NotImplementedError(
            f"loading index kind {kind!r} is not ported yet (ROADMAP.md "
            f"queue 1, item 9: io)")
    device = require_device(device)
    if kind in _READERS:
        return _READERS[kind](arrays, meta, device)
    cfg = TreeXHybridConfig(
        num_partitions=int(meta["num_partitions"]),
        partitions_to_search=int(meta["partitions_to_search"]),
        hash_config=_hash_config(meta["hash_config"]),
        use_residuals=bool(meta["use_residuals"]),
        pre_reorder_multiplier=float(meta["pre_reorder_multiplier"]),
        distance_measure=DistanceMeasure(meta["measure"]),
        rerank_dtype=meta.get("rerank_dtype", "float32"),
        score_l_tile=int(meta.get("score_l_tile", 512)),
        # files saved before the adaptive q_cap / packed slab existed lack
        # these keys: they served with q_cap=8 and the unpacked slab
        group_q_cap=(int(meta["group_q_cap"])
                     if meta.get("group_q_cap") is not None
                     else None if "group_q_cap" in meta else 8),
        pack_codes=meta["pack_codes"] if "pack_codes" in meta else False,
        rerank_layout=meta.get("rerank_layout"),
    )
    s = TreeXHybridSearcher(cfg, device=device)
    s._dataset = DenseDataset(arrays["data"])

    def t(name: str) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arrays[name])).to(device)

    tp = TreePartitioner(TreePartitionerConfig(
        num_partitions=int(meta["num_partitions"])), device=device)
    tp.centers = t("centers").float()
    tp.tokenization = DatabaseTokenization.from_csr(
        t("tokens"), t("csr_offsets"), t("csr_points"))
    s.partitioner = tp
    cb = Codebook(CodebookConfig(num_codes=arrays["codebook"].shape[1],
                                 num_subspaces=arrays["codebook"].shape[0]),
                  device=device)
    cb.centroids = t("codebook").float()
    s.codebook = cb
    codes = t("codes").to(torch.uint8)
    if not meta.get("assignment_codes", False):
        # legacy per-point rows -> per-assignment CSR rows
        codes = codes[tp.tokenization.point_indices]
    s.codes = codes
    return s


def load_index(path: str, device: Union[str, torch.device] = DEFAULT_DEVICE):
    """Load a tree-AH, block-sweep, asymmetric-hashing, brute-force or
    scalar-quantized index saved by ``scann_tpu.io.save_index`` onto
    ``device`` (the current CUDA device by default)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ScannError.failed_precondition(
                f"unsupported index format {meta.get('format_version')}")
        if "sharded_kind" in meta:
            raise NotImplementedError(
                "sharded serving layouts are not ported yet (ROADMAP.md "
                "queue 1, item 11: multiple GPUs)")
        if "kind" not in meta:
            raise ScannError.failed_precondition(
                "not a save_index file: missing index kind")
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    if meta.get("facade"):
        raise NotImplementedError(
            "the Scann facade is not ported yet (ROADMAP.md queue 1, item 9)")
    return from_numpy_state(arrays, meta, device)
