"""Index save and load (counterpart of ``scann_tpu/io.py``'s
``save_index`` / ``load_index``), in both directions.

The file format is the JAX package's: one compressed ``.npz`` holding every
array plus a JSON header (``__meta__``, uint8 bytes) with the index kind and
its config, ``format_version`` 1. :func:`save_index` writes the arrays the
JAX package writes, with the same names, dtypes and header keys, so the JAX
package's ``load_index`` reads a port file; :func:`load_index` and
:func:`from_numpy_state` read a JAX file. Kinds: brute force, scalar
quantized, partitioned, hashed, tree-AH and block sweep; a ``Scann`` facade
saves its inner searcher with ``facade`` and ``scann_config`` in the
header, and loads back as that inner searcher, as in the JAX package. A
tree-AH index carries its whole state: spilled (multi-assignment) CSR
tables, the centres a balanced build grew past ``num_partitions``,
per-assignment codes, the re-rank dtype and layout and the measure (a
cosine index's rows were normalized at build). An AVQ codebook gets its
``eta`` back from the threshold in the config.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes.avq import anisotropic_eta
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
from scann_tpu_torch.models.partitioned import PartitionedSearcher
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


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def _np(x, dtype) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype=dtype)


def _ah_cfg_dict(cfg: AsymmetricHasherConfig) -> dict:
    """A hasher config as JSON (the measure as its string)."""
    d = dataclasses.asdict(cfg)
    d["distance_measure"] = cfg.distance_measure.value
    return d


def _partition_arrays(tp: TreePartitioner) -> Dict[str, np.ndarray]:
    tk = tp.tokenization
    return {"centers": _np(tp.centers, np.float32),
            "tokens": _np(tk.tokens, np.int32),
            "csr_offsets": _np(tk.offsets, np.int32),
            "csr_points": _np(tk.point_indices, np.int32)}


def _serialize(searcher) -> Tuple[Dict[str, np.ndarray], dict]:
    """(arrays, header) of one searcher, as the JAX package writes them."""
    if isinstance(searcher, BruteForceSearcher):
        return ({"data": _np(searcher.dataset.numpy(), np.float32)},
                {"kind": "brute_force",
                 "measure": searcher.distance_measure.value})
    if isinstance(searcher, ScalarQuantizedBruteForceSearcher):
        q = searcher.quantized_dataset
        meta = {"kind": "scalar_quantized",
                "measure": searcher._measure.value,
                "storage": searcher._config.storage}
        if isinstance(q, QuantizedDataset):
            meta.update(scale=float(q.quantizer.scale),
                        min_value=float(q.quantizer.min_value),
                        bits=q.quantizer.config.bits)
            return {"codes": _np(q.codes, np.uint8)}, meta
        return {"data": _np(q.to_f32(), np.float32)}, meta
    if isinstance(searcher, PartitionedSearcher):
        arrays = {"data": _np(searcher.dataset.numpy(), np.float32),
                  **_partition_arrays(searcher.partitioner)}
        return arrays, {"kind": "partitioned",
                        "measure": searcher.distance_measure.value,
                        "p": searcher._p_default}
    if isinstance(searcher, AsymmetricHasher):
        arrays = {"codes": _np(searcher.codes, np.uint8),
                  "codebook": _np(searcher.codebook.centroids, np.float32)}
        if searcher._dataset is not None:
            arrays["data"] = _np(searcher._dataset.numpy(), np.float32)
        return arrays, {"kind": "hashed", "dim": searcher._dim,
                        "config": _ah_cfg_dict(searcher.config)}
    if isinstance(searcher, TreeXHybridSearcher):
        cfg = searcher.config
        arrays = {"data": _np(searcher._dataset.numpy(), np.float32),
                  **_partition_arrays(searcher.partitioner),
                  "codes": _np(searcher.codes, np.uint8),
                  "codebook": _np(searcher.codebook.centroids, np.float32)}
        return arrays, {
            "kind": "tree_ah",
            # codes are per-assignment rows in CSR order
            "assignment_codes": True,
            "num_partitions": cfg.num_partitions,
            "partitions_to_search": cfg.partitions_to_search,
            "use_residuals": cfg.use_residuals,
            "pre_reorder_multiplier": cfg.pre_reorder_multiplier,
            "hash_config": _ah_cfg_dict(cfg.hash_config),
            "rerank_dtype": cfg.rerank_dtype,
            "score_l_tile": cfg.score_l_tile,
            "group_q_cap": cfg.group_q_cap,
            "pack_codes": cfg.pack_codes,
            "rerank_layout": cfg.rerank_layout,
            "measure": cfg.distance_measure.value}
    if isinstance(searcher, BlockSweepSearcher):
        cfg = searcher.config
        return ({"data": _np(searcher.dataset.numpy(), np.float32)},
                {"kind": "block_sweep", "measure": cfg.distance_measure.value,
                 "pre_reorder_k": cfg.pre_reorder_k, "block_r": cfg.block_r,
                 "tile_n": cfg.tile_n, "max_batch": cfg.max_batch,
                 "top2": cfg.top2, "shuffle": cfg.shuffle,
                 "rerank_dtype": cfg.rerank_dtype,
                 "sweep_dtype": cfg.sweep_dtype})
    raise ScannError.unimplemented(
        f"cannot serialize {type(searcher).__name__}")


def save_index(path: str, searcher) -> None:
    """Save a built searcher (brute force, scalar quantized, partitioned,
    hashed, tree-AH, block sweep, or a ``Scann`` facade around one) to
    ``path`` (.npz), from tensors on any device, as the JAX package's
    ``save_index`` writes it."""
    from scann_tpu_torch.models.scann import Scann

    if isinstance(searcher, Scann):
        arrays, meta = _serialize(searcher.impl)
        meta["scann_config"] = searcher.config.to_dict()
        meta["facade"] = True
    else:
        arrays, meta = _serialize(searcher)
        meta["facade"] = False
    meta["format_version"] = _FORMAT_VERSION
    np.savez_compressed(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


def _hash_config(d: dict) -> AsymmetricHasherConfig:
    """A saved hasher config; the measure is stored as its JSON string."""
    fields = {f.name for f in dataclasses.fields(AsymmetricHasherConfig)}
    d = {k: v for k, v in d.items() if k in fields}
    if "distance_measure" in d:
        d["distance_measure"] = DistanceMeasure(d["distance_measure"])
    return AsymmetricHasherConfig(**d)


def _tensor(arrays: Dict[str, np.ndarray], name: str,
            device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arrays[name])).to(device)


def _codebook(arrays: Dict[str, np.ndarray], threshold,
              device: torch.device) -> Codebook:
    """The saved [S, C, d_sub] codebook; an AVQ codebook (``threshold``
    set) gets its eta back, so later encodes stay score-aware."""
    book = arrays["codebook"]
    cb = Codebook(CodebookConfig(num_codes=book.shape[1],
                                 num_subspaces=book.shape[0]), device=device)
    cb.centroids = _tensor(arrays, "codebook", device).float()
    _restore_avq(cb, threshold)
    return cb


def _restore_avq(cb: Codebook, threshold) -> None:
    if threshold is not None:
        s, _, dsub = cb.centroids.shape
        cb.config.anisotropic_threshold = float(threshold)
        cb.eta = anisotropic_eta(float(threshold), s * dsub)


def _partitioner(arrays: Dict[str, np.ndarray], num_partitions: int,
                 measure: DistanceMeasure,
                 device: torch.device) -> TreePartitioner:
    """The saved centres and tokenization (the CSR tables when stored: they
    keep spilled multi-assignments, which primary tokens cannot encode)."""
    tp = TreePartitioner(TreePartitionerConfig(
        num_partitions=num_partitions, distance_measure=measure),
        device=device)
    tp.centers = _tensor(arrays, "centers", device).float()
    tokens = _tensor(arrays, "tokens", device)
    if "csr_offsets" in arrays:
        tp.tokenization = DatabaseTokenization.from_csr(
            tokens, _tensor(arrays, "csr_offsets", device),
            _tensor(arrays, "csr_points", device))
    else:
        tp.tokenization = DatabaseTokenization(tokens, len(arrays["centers"]))
    return tp


def _hashed(arrays: Dict[str, np.ndarray], meta: dict,
            device: torch.device) -> AsymmetricHasher:
    """The codebook, the [N, S] codes and, when the index stored it, the
    float32 dataset (already normalized for COSINE)."""
    cfg = _hash_config(meta["config"])
    h = AsymmetricHasher(cfg, device=device)
    h.codebook = _codebook(arrays, cfg.anisotropic_threshold, device)
    h.codes = _tensor(arrays, "codes", device).to(torch.uint8)
    h._n = len(arrays["codes"])
    h._dim = int(meta["dim"])
    if "data" in arrays:
        h._dataset = DenseDataset(arrays["data"])
    return h


def _block_sweep(arrays: Dict[str, np.ndarray], meta: dict,
                 device: torch.device) -> BlockSweepSearcher:
    """The data and the config; the sweep copy is rebuilt from them on
    first search."""
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
    """int8 / int4 codes with their calibration (the range's top rebuilt
    as min + scale * levels), or the float32 data of a bf16 / fp8 index,
    re-encoded."""
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


def _partitioned(arrays: Dict[str, np.ndarray], meta: dict,
                 device: torch.device) -> PartitionedSearcher:
    measure = DistanceMeasure(meta["measure"])
    return PartitionedSearcher(
        DenseDataset(arrays["data"]),
        partitioner=_partitioner(arrays, len(arrays["centers"]), measure,
                                 device),
        num_partitions_to_search=int(meta["p"]), distance_measure=measure,
        device=device)


def _tree_ah(arrays: Dict[str, np.ndarray], meta: dict,
             device: torch.device) -> TreeXHybridSearcher:
    hc = _hash_config(meta["hash_config"])
    cfg = TreeXHybridConfig(
        num_partitions=int(meta["num_partitions"]),
        partitions_to_search=int(meta["partitions_to_search"]),
        hash_config=hc,
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
    tp = _partitioner(arrays, int(meta["num_partitions"]),
                      DistanceMeasure.SQUARED_L2, device)
    s.partitioner = tp
    s.codebook = _codebook(arrays, hc.anisotropic_threshold, device)
    codes = _tensor(arrays, "codes", device).to(torch.uint8)
    if not meta.get("assignment_codes", False):
        # legacy per-point rows -> per-assignment CSR rows
        codes = codes[tp.tokenization.point_indices]
    s.codes = codes
    return s


_READERS = {
    "block_sweep": _block_sweep,
    "hashed": _hashed,
    "brute_force": lambda arrays, meta, device: BruteForceSearcher(
        DenseDataset(arrays["data"]), DistanceMeasure(meta["measure"]),
        device=device),
    "scalar_quantized": _scalar_quantized,
    "partitioned": _partitioned,
    "tree_ah": _tree_ah,
}


def from_numpy_state(arrays: Dict[str, np.ndarray], meta: dict,
                     device: Union[str, torch.device] = DEFAULT_DEVICE):
    """A port searcher on ``device`` (the current CUDA device by default)
    from a saved index's arrays and its JSON header, the state either
    package's ``save_index`` writes, of every kind: tree-AH (data, centres
    -- as many as the build made --, primary tokens, the CSR tables
    csr_offsets and csr_points with every assignment, per-assignment codes,
    codebook), partitioned (data, centres, tokens, CSR tables), block sweep
    or brute force (data), hashed (codes, codebook, data when stored) or
    scalar quantized (codes, or data)."""
    kind = meta.get("kind")
    if kind not in _READERS:
        raise ScannError.unimplemented(f"unknown index kind {kind!r}")
    return _READERS[kind](arrays, meta, require_device(device))


def load_index(path: str, device: Union[str, torch.device] = DEFAULT_DEVICE):
    """Load an index saved by either package's ``save_index`` onto
    ``device`` (the current CUDA device by default), with no retraining. A
    facade file loads as its inner searcher."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ScannError.failed_precondition(
                f"unsupported index format {meta.get('format_version')}")
        if "sharded_kind" in meta:
            raise ScannError.failed_precondition(
                "this file is a sharded serving layout (kind "
                f"{meta['sharded_kind']!r}); load it with "
                "io.load_sharded_layout / <Sharded*Searcher>.load_layout")
        if "kind" not in meta:
            raise ScannError.failed_precondition(
                "not a save_index file: missing index kind")
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return from_numpy_state(arrays, meta, device)


# ---------------------------------------------------------------------------
# sharded serving layouts (warm start)
# ---------------------------------------------------------------------------


def _dtype_safe_store(arr) -> Tuple[np.ndarray, str]:
    """(storable array, dtype tag): npz holds no bfloat16, so a bf16
    tensor travels as its uint16 bit view tagged "bfloat16", as the JAX
    package stores its ``ml_dtypes`` arrays."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            return (arr.contiguous().view(torch.int16).numpy()
                    .view(np.uint16), "bfloat16")
        arr = arr.numpy()
    return arr, str(arr.dtype)


def _dtype_safe_load(arr: np.ndarray, name: str):
    """A stored layout array: bf16 bit views back as bf16 CPU tensors,
    through torch (no ``ml_dtypes``)."""
    if str(arr.dtype) == name:
        return arr
    if name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    raise ScannError.unimplemented(
        f"sharded layout array of dtype {name!r} stored as {arr.dtype}")


def save_sharded_layout(path: str, sharded) -> None:
    """Save a sharded wrapper's per-shard serving layout and its inner
    searcher's trained artifacts to one .npz, the JAX package's file: a
    serving restart then skips the host re-layout (tree: the per-partition
    re-shard and re-rank encode; sweep: augment, shuffle and re-rank
    encode). Supports ``ShardedTreeXHybridSearcher`` and
    ``ShardedBlockSweepSearcher``."""
    from scann_tpu_torch.parallel.sharded_flagship import (
        ShardedBlockSweepSearcher,
        ShardedTreeXHybridSearcher,
        _compute_sweep_shard_layout,
        _compute_tree_shard_layout,
    )

    extra_meta = {}
    if isinstance(sharded, ShardedTreeXHybridSearcher):
        kind = "tree_ah"
        layout = _compute_tree_shard_layout(sharded._inner,
                                            sharded.mesh.shape["db"])
        keys = tuple(k for k in ("codes", "perm", "db", "sizes", "offs",
                                 "tok") if layout.get(k) is not None)
        extra_meta["layout_l_cap"] = int(layout["l_cap"])
        # the residual-anchored int8 codec's parameters (None otherwise)
        extra_meta["layout_dequant"] = layout.get("dequant")
    elif isinstance(sharded, ShardedBlockSweepSearcher):
        kind = "block_sweep"
        layout = _compute_sweep_shard_layout(sharded._inner,
                                             sharded.mesh.shape["db"])
        keys = tuple(k for k in ("aug", "rdb", "inv", "aug_scales")
                     if layout.get(k) is not None)
        extra_meta["layout_blk"] = int(layout["blk"])
        extra_meta["layout_aug_sn"] = float(layout["aug_sn"])
        extra_meta["layout_dequant"] = layout["dequant"]
        extra_meta["layout_has_inv"] = layout["inv"] is not None
    else:
        raise ScannError.unimplemented(
            "save_sharded_layout supports ShardedTreeXHybridSearcher and "
            "ShardedBlockSweepSearcher")
    inner_arrays, inner_meta = _serialize(sharded._inner)
    dtypes = {}
    arrays = {f"inner__{k}": v for k, v in inner_arrays.items()}
    for k in keys:
        arrays[f"layout__{k}"], dtypes[k] = _dtype_safe_store(layout[k])
    meta = {
        "format_version": _FORMAT_VERSION,
        "sharded_kind": kind,
        "inner": inner_meta,
        "layout_n_sh": int(layout["n_sh"]),
        "layout_dtypes": dtypes,
        **extra_meta,
    }
    np.savez_compressed(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_sharded_layout(path: str, cls=None, mesh=None, force_kernel=None,
                        device=None):
    """Restore a wrapper saved with :func:`save_sharded_layout` by either
    package: the inner searcher on ``device`` (default: the mesh's home
    device) and the per-shard slabs from disk onto the shards' devices.
    ``mesh`` defaults to the visible CUDA devices."""
    from scann_tpu_torch.parallel.mesh import make_mesh
    from scann_tpu_torch.parallel.sharded_flagship import (
        ShardedBlockSweepSearcher,
        ShardedTreeXHybridSearcher,
    )

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ScannError.failed_precondition(
                f"unsupported layout format {meta.get('format_version')}")
        arrays = {k: z[k] for k in z.files if k != "__meta__"}

    kind = meta.get("sharded_kind")
    if cls is None:
        cls = {"tree_ah": ShardedTreeXHybridSearcher,
               "block_sweep": ShardedBlockSweepSearcher}.get(kind)
        if cls is None:
            raise ScannError.unimplemented(
                f"unknown sharded layout kind {kind!r}")
    mesh = mesh or make_mesh(axis_names=("db",))
    inner = from_numpy_state(
        {k[len("inner__"):]: v for k, v in arrays.items()
         if k.startswith("inner__")}, meta["inner"],
        device if device is not None else mesh.home())
    dtypes = meta.get("layout_dtypes", {})
    layout = {}
    for k, v in arrays.items():
        if k.startswith("layout__"):
            name = k[len("layout__"):]
            layout[name] = _dtype_safe_load(v, dtypes.get(name, str(v.dtype)))
    layout["n_sh"] = meta["layout_n_sh"]
    if kind == "tree_ah":
        layout["l_cap"] = meta["layout_l_cap"]
        layout["dequant"] = meta.get("layout_dequant")
        return cls(inner, mesh, force_kernel=force_kernel, layout=layout)
    layout["blk"] = meta["layout_blk"]
    layout["aug_sn"] = meta["layout_aug_sn"]
    layout["dequant"] = meta["layout_dequant"]
    if not meta.get("layout_has_inv", False):
        layout["inv"] = None
    return cls(inner, mesh, layout=layout)
