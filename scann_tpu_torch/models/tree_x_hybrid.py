"""Tree-x-AH hybrid searcher (counterpart of
``scann_tpu/models/tree_x_hybrid.py``).

Build: k-means partitions (optionally balanced to a size cap, and spilled:
a second assignment per point by distance or by the SOAR loss); a global PQ
codebook trained on residuals (point - partition centroid) of a seeded
sample; codes per ASSIGNMENT in one partition-contiguous CSR slab, so a
spilled point's two rows each encode the residual against their own
partition's centroid.

Search, one batch of queries on the device with no host round trip, in
stages that the sharded searcher (``parallel/sharded_flagship``) runs over
each shard's slab too (:meth:`TreeXHybridSearcher.plan_request` resolves
the batch's knobs for either):

    centroid matmul -> top-p partitions                      (query_tables)
    -> LUTs: one table per query (MIPS, the partition term a bias on
       subspace 0) or per (query, partition) pair
    -> leaf scoring over the CSR slab, one of:              (leaf_scores)
         grouped: pairs grouped by partition, each slot's bf16 table row
           written from the source (CUDA kernel, ops/grouped_luts), the
           grouped scorer (CUDA kernel, ops/tree_ah_grouped) with bf16 or
           int8 tables                                 (tree_ah_search_grouped)
         per pair: every pair's float32 table over its partition's codes
           (CUDA kernel, ops/tree_ah_leaf)             (tree_ah_search)
    -> leaf-major flat scores [B, p*l_cap], allowlist mask
    -> top-pre_k (x multiplicity under spilling, then keep-best-per-id):
                                                               (preselect)
       on the card the bf16 rows go to the exact selection kernel
       (ops/topk, csrc/topk_select.cu), the int64 key's results bit for
       bit; the selection stays exact, where the JAX package's TPU path
       calls lax.approx_min_k
    -> rows from the re-rank store (utils/reordering.gather_candidates)
       -> exact re-rank -> top-k                            (exact_rerank)

Each stage runs inside a span (``utils/trace.span``) that any
``torch.profiler`` trace shows: ``tree_ah.partitions``, ``tree_ah.luts``,
``tree_ah.group``, ``tree_ah.leaf``, ``tree_ah.mask`` (restricts),
``tree_ah.preselect`` (the approximate top-pre_k) and ``tree_ah.rerank``,
under ``tree_ah.search`` around the searcher's whole search.

The searcher serves the grouped path. Measures: squared L2 (and L2-like),
COSINE (rows normalized at build, queries at search) and DOT_PRODUCT /
GENERAL_INNER_PRODUCT (-dot tables, the centroid term folded into subspace
0, partitions selected by dot product). Re-rank stores: float32, bfloat16,
int8 (residual-anchored) and int16 (residual-anchored), in id order or in
CSR order with the id in digit lanes (``rerank_layout="csr"``).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes.codebook import Codebook, CodebookConfig, lut_kernel
from scann_tpu_torch.hashes.hasher import AsymmetricHasherConfig, _normalize
from scann_tpu_torch.models.searcher import SearchParameters, Searcher, epsilons
from scann_tpu_torch.ops.distances import (
    DistanceMeasure,
    approx_to_measure_units,
    gathered_distances,
    many_to_many,
)
from scann_tpu_torch.ops.grouped_luts import (
    LutSource,
    even_first,
    expand_luts,
    grouped_luts,
)
from scann_tpu_torch.ops.topk import (
    approx_top_k_smallest,
    dedup_top_k,
    keep_best_per_id,
    top_k_smallest,
    top_k_unique,
)
from scann_tpu_torch.ops.tree_ah_grouped import (
    I16_MASK,
    fit_q_cap,
    group_pairs_by_partition,
    tree_ah_grouped_scores,
)
from scann_tpu_torch.ops.tree_ah_leaf import tree_ah_leaf_scores
from scann_tpu_torch.partitioning.tree_partitioner import (
    TreePartitioner,
    TreePartitionerConfig,
)
from scann_tpu_torch.types import (
    DEFAULT_DEVICE,
    MASKED_DISTANCE,
    align_up,
    require_device,
)
from scann_tpu_torch.utils.reordering import (
    build_csr_rerank_store,
    build_rerank_store,
    build_residual_rerank_store,
    gather_candidates,
)
from scann_tpu_torch.utils.trace import span

RERANK_DTYPES = ("float32", "bfloat16", "int8", "int16")


@dataclasses.dataclass
class TreeXHybridConfig:
    """The JAX package's ``TreeXHybridConfig`` fields the port reads, and
    ``approx_selection_min_partitions``, which it accepts and ignores: the
    port selects partitions exactly, whatever the centroid count."""

    num_partitions: int = 100
    partitions_to_search: int = 10
    hash_config: AsymmetricHasherConfig = dataclasses.field(
        default_factory=lambda: AsymmetricHasherConfig(num_codes=16,
                                                       num_subspaces=8))
    use_residuals: bool = True
    pre_reorder_multiplier: float = 3.0
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    # partition balancing cap ("auto" = 1.5 x the mean size, None = off)
    max_partition_size: Optional[object] = "auto"
    # principal-axis split of partitions the demote rounds left oversized
    split_stragglers: bool = True
    # spilling: "distance" = 2nd-nearest partition within the threshold
    # ratio; "soar" = one secondary for every point by the SOAR loss
    spilling: bool = False
    spilling_threshold: float = 0.1
    spilling_mode: str = "distance"
    soar_lambda: float = 1.0
    partition_max_iterations: int = 100
    partition_convergence_threshold: float = 1e-5
    partition_num_levels: int = 1
    partition_training_sample_size: Optional[int] = None
    # grouped-scorer shape: queries per group (None = adaptive from the pair
    # density, as in the JAX package) and the L-tile the slab is padded to
    group_q_cap: Optional[int] = None
    score_l_tile: int = 512
    # the JAX package's centroid count from which a TPU run selects the
    # top-p partitions approximately (lax.approx_min_k). Accepted and not
    # read: the port selects exactly at every count (_select_partitions),
    # as the JAX package does on the CPU
    approx_selection_min_partitions: int = 1024
    # packed int4 slab (None = pack when num_codes <= 16)
    pack_codes: Optional[bool] = None
    # spilling: keep each id's best approximate slot before the re-rank
    # gather (False = gather pre_k x multiplicity rows, dedup after)
    spill_dedup: bool = True
    # dtype of the re-rank store: float32, bfloat16, int8 or int16 (the
    # two integer codecs quantize the residual to the point's partition)
    rerank_dtype: str = "float32"
    # re-rank store layout: "id" (id order, candidates translated through
    # the CSR perm table) or "csr" (CSR row order, the id in digit lanes).
    # None = "id": the JAX package's auto picks "csr" at one assignment
    # per point, which returns the same results; the port keeps "id" until
    # a card measurement says otherwise (PERF.md)
    rerank_layout: Optional[str] = None

    def with_hash(self, cfg: AsymmetricHasherConfig) -> "TreeXHybridConfig":
        self.hash_config = cfg
        return self

    def with_residuals(self, flag: bool) -> "TreeXHybridConfig":
        self.use_residuals = flag
        return self

    def with_pre_reorder(self, multiplier: float) -> "TreeXHybridConfig":
        self.pre_reorder_multiplier = multiplier
        return self


def _check_config(cfg: TreeXHybridConfig) -> None:
    if cfg.rerank_dtype not in RERANK_DTYPES:
        raise ScannError.invalid_argument(
            f"rerank_dtype must be one of {RERANK_DTYPES}, got "
            f"{cfg.rerank_dtype!r}")
    if cfg.rerank_layout not in (None, "id", "csr"):
        raise ScannError.invalid_argument(
            f"rerank_layout must be None, 'id' or 'csr', got "
            f"{cfg.rerank_layout!r}")
    if cfg.spilling_mode not in ("distance", "soar"):
        raise ScannError.invalid_argument(
            f"spilling_mode must be 'distance' or 'soar', got "
            f"{cfg.spilling_mode!r}")


_MIPS = (DistanceMeasure.DOT_PRODUCT, DistanceMeasure.GENERAL_INNER_PRODUCT)

# build-time residual-encode chunking: elements per [chunk, D] residual block
_ENCODE_CHUNK_ELEMS = 150_000_000


# ---------------------------------------------------------------------------
# search stages
# ---------------------------------------------------------------------------


def _select_partitions(centers: torch.Tensor, queries: torch.Tensor, *,
                       p: int,
                       measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
                       ) -> torch.Tensor:
    """[B, p] selected partitions: largest dot product for MIPS measures,
    nearest centroid otherwise (cosine rows are normalized). Exact; a TPU
    run of the JAX package selects approximately past 1024 centroids, its
    CPU run exactly, like this."""
    sel = measure if measure in _MIPS else DistanceMeasure.SQUARED_L2
    return top_k_smallest(many_to_many(sel, queries, centers), p)[1]


def _lut_source(queries: torch.Tensor, centers: torch.Tensor,
                parts: torch.Tensor, codebook: torch.Tensor, *,
                use_residuals: bool,
                measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
                ) -> LutSource:
    """A batch's float32 tables before they are expanded to its (query,
    partition) pairs.

    MIPS: one [S, C] table of -dot(q_s, codebook[s][c]) per query, the
    partition's constant -dot(q, c_t) a [B, p] bias on subspace 0, so the
    sums are -dot(q, c_t + r) and compare across partitions. Squared L2
    (and cosine on normalized vectors): one table per pair, of the residual
    query q - c_t."""
    b, d = queries.shape
    p = parts.shape[1]
    if measure in _MIPS:
        s, c, dsub = codebook.shape
        qs = queries.reshape(b, s, dsub)
        tables = -torch.einsum("bsd,scd->bsc", qs, codebook)   # [B, S, C]
        bias = (-torch.einsum("bd,bpd->bp", queries, centers[parts])
                if use_residuals else None)
        return LutSource(tables, bias, per_query=True)
    if use_residuals:
        q_eff = queries[:, None, :] - centers[parts]           # [B, p, D]
    else:
        q_eff = queries[:, None, :].expand(b, p, d)
    return LutSource(lut_kernel(q_eff.reshape(b * p, d), codebook), None,
                     per_query=False)                          # [B*p, S, C]


def _residual_luts(queries: torch.Tensor, centers: torch.Tensor,
                   parts: torch.Tensor, codebook: torch.Tensor, *, s_pad: int,
                   use_residuals: bool,
                   measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
                   ) -> torch.Tensor:
    """[B*p, s_pad*C] per-(query, partition) float32 LUTs, zero rows for
    pad subspaces (pad code 0 then adds nothing): :func:`_lut_source`
    expanded to every pair."""
    return expand_luts(
        _lut_source(queries, centers, parts, codebook,
                    use_residuals=use_residuals, measure=measure),
        p=parts.shape[1], s_pad=s_pad)


def quantize_luts_int8(luts_flat: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int8 tables, lo, scale): one affine per batch over the whole padded
    table, ``clip(round((lut - lo) / scale), 0, 255) - 128`` (round half to
    even, as ``jnp.round``). Pad subspaces are zero rows, so lo <= 0 once
    S_pad > S. Divisions are tensor by tensor (a Python-scalar divisor
    would multiply by a rounded reciprocal)."""
    lo = luts_flat.min()
    span = torch.clamp_min(luts_flat.max() - lo, 1e-6)
    scale = span / torch.full_like(span, 255.0)
    q = torch.clamp(torch.round((luts_flat - lo) / scale), 0, 255)
    return (q - 128.0).to(torch.int8), lo, scale


def _group_luts(luts: Union[torch.Tensor, LutSource], parts: torch.Tensor,
                csr_offsets: torch.Tensor, part_sizes: torch.Tensor, *,
                s_pad: int, q_cap: int, packed: bool):
    """Grouped scorer inputs: (luts_grouped [NG*q_cap, S_pad*C] bf16, or
    int8 when ``luts`` is int8; grp_off [NG] i32, grp_size [NG] i32 with 0
    for unused groups, slot [B*p] row of each pair).

    ``luts`` is a :class:`LutSource` or flat [B*p, S_pad*C] tables (a
    per-pair source). Float tables go through ``ops/grouped_luts`` (on the
    card one kernel writes the bf16 rows in slot order, unused rows zero);
    int8 tables, quantized over the whole batch, are gathered into slot
    order (unused rows hold pair 0's)."""
    bp = parts.numel()
    grp_part, slot, ng = group_pairs_by_partition(
        parts, part_sizes.shape[0], q_cap)
    grp_safe = grp_part.clamp_min(0)
    grp_off = csr_offsets[grp_safe]
    grp_size = torch.where(grp_part >= 0, part_sizes[grp_safe], 0)
    if isinstance(luts, torch.Tensor) and luts.dtype == torch.int8:
        pair_of_slot = torch.zeros(ng * q_cap, dtype=torch.int64,
                                   device=luts.device)
        pair_of_slot[slot] = torch.arange(bp, device=luts.device)
        grouped = (even_first(luts, s_pad) if packed else luts)[pair_of_slot]
    else:
        if isinstance(luts, torch.Tensor):
            luts = LutSource(luts.reshape(bp, s_pad, -1), None,
                             per_query=False)
        grouped = grouped_luts(luts, slot, p=parts.shape[1], s_pad=s_pad,
                               rows=ng * q_cap, packed=packed)
    return (grouped.contiguous(), grp_off.int().contiguous(),
            grp_size.int().contiguous(), slot)


def _leaf_major(scores_g: torch.Tensor, slot: torch.Tensor, *, b: int, p: int,
                l_cap: int) -> torch.Tensor:
    """[B, p*l_cap] flat scores, leaf-major (position l*p + t holds slot l
    of the query's t-th partition) — the JAX package's layout, kept so flat
    positions match it one to one."""
    return scores_g[slot].reshape(b, p, l_cap).transpose(1, 2).reshape(
        b, p * l_cap)


def leaf_scores_grouped(luts: Union[torch.Tensor, LutSource],
                        parts: torch.Tensor, codes_csr: torch.Tensor,
                        csr_offsets: torch.Tensor, part_sizes: torch.Tensor,
                        *, p: int, l_cap: int, q_cap: int, l_tile: int,
                        packed: bool, int8_luts: bool = False
                        ) -> torch.Tensor:
    """[B, p*l_cap] leaf-major scores, ``MASKED_DISTANCE`` past each
    partition's size, from the grouped scorer over ``luts`` (flat [B*p,
    S_pad*C] tables or a :class:`LutSource`): bf16, or with ``int8_luts``
    float32 restored from the int16 sums by the batch's affine
    ``scale * (s + 128 * s_pad) + s_pad * lo`` (real units survive, so
    epsilons keep their meaning)."""
    s_pad = 2 * codes_csr.shape[0] if packed else codes_csr.shape[0]
    with span("tree_ah.group"):
        if int8_luts:
            # one affine over every pair's float32 table
            if isinstance(luts, LutSource):
                luts = expand_luts(luts, p=p, s_pad=s_pad)
            luts, lo, scale = quantize_luts_int8(luts)
        luts_grouped, grp_off, grp_size, slot = _group_luts(
            luts, parts, csr_offsets, part_sizes, s_pad=s_pad,
            q_cap=q_cap, packed=packed)
    with span("tree_ah.leaf"):
        with span("tree_ah.leaf.score"):
            scores_g = tree_ah_grouped_scores(
                luts_grouped, codes_csr, grp_off, grp_size, l_cap=l_cap,
                l_tile=l_tile, q_cap=q_cap, packed=packed)
        flat = _leaf_major(scores_g, slot, b=parts.shape[0], p=p,
                           l_cap=l_cap)
        if int8_luts:
            real = scale * (flat.float() + 128.0 * s_pad) + s_pad * lo
            flat = torch.where(flat == I16_MASK, float(MASKED_DISTANCE),
                               real)
        return flat


def leaf_scores_per_pair(luts_flat: torch.Tensor, parts: torch.Tensor,
                         codes_csr: torch.Tensor, csr_offsets: torch.Tensor,
                         part_sizes: torch.Tensor, *, p: int, l_cap: int,
                         c: int) -> torch.Tensor:
    """[B, p*l_cap] leaf-major float32 scores, ``MASKED_DISTANCE`` past
    each partition's size, one table per (query, partition) pair over the
    unpacked [S_pad, N_csr] slab (the per-pair kernel, ops/tree_ah_leaf).
    The counterpart of the JAX package's ``leaf_scores_xla``."""
    b = parts.shape[0]
    s_pad = codes_csr.shape[0]
    with span("tree_ah.leaf"):
        scores = tree_ah_leaf_scores(
            luts_flat.reshape(b, p, s_pad, c), codes_csr,
            csr_offsets[parts].int().contiguous(),
            part_sizes[parts].int().contiguous(), l_cap=l_cap)
        return scores.transpose(1, 2).reshape(b, p * l_cap)


def candidate_rows_from_positions(parts: torch.Tensor,
                                  csr_offsets: torch.Tensor, num_rows: int,
                                  pos: torch.Tensor, *, p: int
                                  ) -> torch.Tensor:
    """CSR rows of leaf-major flat positions: position l*p + t maps to
    min(csr_offsets[parts[b, t]] + l, num_rows - 1). A plain gather; the
    JAX package's one-hot contraction avoids per-element gathers on a TPU."""
    offs = csr_offsets.long()[parts]                          # [B, p]
    row0 = torch.gather(offs, 1, pos % p)
    return (row0 + pos // p).clamp_max(num_rows - 1)


def _csr_row_positions(parts: torch.Tensor, csr_offsets: torch.Tensor,
                       num_rows: int, *, p: int, l_cap: int) -> torch.Tensor:
    """[B, p*l_cap] leaf-major CSR rows of every candidate slot."""
    b = parts.shape[0]
    offs = csr_offsets.long()[parts]                          # [B, p]
    iota_l = torch.arange(l_cap, device=parts.device)
    rows = (offs[:, :, None] + iota_l).clamp_max(num_rows - 1)
    return rows.transpose(1, 2).reshape(b, p * l_cap)


def _mask_disallowed(flat_scores: torch.Tensor, allow_mask: torch.Tensor,
                     perm: torch.Tensor, parts: torch.Tensor,
                     csr_offsets: torch.Tensor, num_rows: int, *, p: int,
                     l_cap: int) -> torch.Tensor:
    """Restricts as a hard filter before selection: slots whose point id is
    not in ``allow_mask`` ([N] bool on the device) get MASKED_DISTANCE."""
    allow_csr = allow_mask[perm.clamp_min(0)]
    rows = _csr_row_positions(parts, csr_offsets, num_rows, p=p, l_cap=l_cap)
    return torch.where(allow_csr[rows], flat_scores,
                       flat_scores.new_tensor(float(MASKED_DISTANCE)))


def query_tables(centers: torch.Tensor, codebook: torch.Tensor,
                 queries: torch.Tensor, *, p: int, s_pad: int,
                 use_residuals: bool,
                 measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
                 leaf: str = "grouped"
                 ) -> Tuple[torch.Tensor, Union[torch.Tensor, LutSource]]:
    """(top-p partitions [B, p], tables): the stages a batch runs once
    whatever slab it scores. The grouped scorer takes a
    :class:`LutSource`, the per-pair one [B*p, s_pad*C] float32 tables."""
    with span("tree_ah.partitions"):
        parts = _select_partitions(centers, queries, p=p, measure=measure)
    with span("tree_ah.luts"):
        kw = dict(use_residuals=use_residuals, measure=measure)
        if leaf == "grouped":
            return parts, _lut_source(queries, centers, parts, codebook, **kw)
        return parts, _residual_luts(queries, centers, parts, codebook,
                                     s_pad=s_pad, **kw)


def leaf_scores(luts: Union[torch.Tensor, LutSource], parts: torch.Tensor,
                codes_csr: torch.Tensor, csr_offsets: torch.Tensor,
                part_sizes: torch.Tensor, perm: torch.Tensor, *, leaf: str,
                p: int, l_cap: int, q_cap: int = 8, l_tile: int = 512,
                packed: bool = False, int8_luts: bool = False,
                allow_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, p*l_cap] leaf-major scores of one slab by the ``leaf`` scorer,
    slots whose id ``allow_mask`` denies masked."""
    if leaf == "grouped":
        flat = leaf_scores_grouped(
            luts, parts, codes_csr, csr_offsets, part_sizes, p=p,
            l_cap=l_cap, q_cap=q_cap, l_tile=l_tile, packed=packed,
            int8_luts=int8_luts)
    else:
        flat = leaf_scores_per_pair(
            luts, parts, codes_csr, csr_offsets, part_sizes, p=p,
            l_cap=l_cap, c=luts.shape[-1] // codes_csr.shape[0])
    if allow_mask is None:
        return flat
    with span("tree_ah.mask"):
        return _mask_disallowed(flat, allow_mask, perm, parts, csr_offsets,
                                codes_csr.shape[1], p=p, l_cap=l_cap)


# preselected candidates, [B, C] each: flat positions and CSR rows (None
# once no store needs them), point ids (None for an id-embedded store),
# valid; ``deduped``: each id kept only its best slot; ``order``: how the
# store they are for is indexed (utils/reordering.gather_candidates)
Candidates = collections.namedtuple("Candidates",
                                    "pos rows ids valid deduped order")


def preselect(flat_scores: torch.Tensor, parts: torch.Tensor,
              csr_offsets: torch.Tensor, perm: torch.Tensor, pre_eps: float,
              *, pre_k: int, p: int, measure: DistanceMeasure,
              order: str = "id", multiplicity: int = 1,
              spill_dedup: bool = True) -> Candidates:
    """The top-pre_k (x multiplicity under spilling) of the flat scores,
    valid where real and within ``pre_eps``: CSR rows from the positions,
    ids through ``perm`` unless the store embeds them (``order="csr"``).
    ``spill_dedup`` keeps each id's best slot (:func:`keep_best_per_id`),
    its CSR row only for a store in CSR row order (``order="row"``)."""
    mult = max(int(multiplicity), 1)
    sel_k = min(pre_k * mult, flat_scores.shape[-1])
    with span("tree_ah.preselect"):
        vals, pos = approx_top_k_smallest(flat_scores, sel_k)
        rows = candidate_rows_from_positions(parts, csr_offsets,
                                             perm.shape[0], pos, p=p)
        vals = vals.float()
        pre_m = approx_to_measure_units(vals, measure)
        valid = (vals < MASKED_DISTANCE / 2) & (pre_m <= pre_eps)
        if order == "csr":
            return Candidates(pos, rows, None, valid, False, order)
        ids = perm[rows]
        if not (spill_dedup and mult > 1):
            return Candidates(pos, rows, ids, valid, False, order)
        masked = torch.where(valid, vals, float(MASKED_DISTANCE))
        kept = keep_best_per_id(masked, ids, min(pre_k, sel_k),
                                payload=rows if order == "row" else None)
        return Candidates(None, kept[2] if order == "row" else None, kept[1],
                          kept[0] < MASKED_DISTANCE / 2, True, order)


def exact_rerank(store, queries: torch.Tensor, cand: Candidates, *,
                 measure: DistanceMeasure,
                 centers: Optional[torch.Tensor] = None,
                 parts: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(exact distances [B, C], MASKED_DISTANCE where invalid; ids [B, C])
    of the candidates, their rows from ``store`` as ``cand.order`` indexes
    it (an anchored id-embedded store adds back the slot's centroid of
    ``parts``). Callers run it, and take their top-k, inside the
    ``tree_ah.rerank`` span."""
    rows, ids = gather_candidates(
        store, cand.rows, cand.ids, order=cand.order,
        slot_centers=lambda: centers[torch.gather(
            parts, 1, cand.pos % parts.shape[1])])
    norms = torch.sum(rows * rows, dim=-1)
    exact = gathered_distances(measure, queries, rows, norms)
    return torch.where(cand.valid, exact, float(MASKED_DISTANCE)), ids


def tree_ah_search(
        db, centers: torch.Tensor, codes_csr: torch.Tensor,
        csr_offsets: torch.Tensor, part_sizes: torch.Tensor,
        perm: torch.Tensor, codebook: torch.Tensor, queries: torch.Tensor,
        pre_eps: float, post_eps: float, *, p: int, pre_k: int, k: int,
        l_cap: int, use_residuals: bool,
        measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
        allow_mask: Optional[torch.Tensor] = None, reorder: bool = True,
        multiplicity: int = 1, spill_dedup: bool = True,
        csr_store: bool = False, leaf: str = "per_pair", q_cap: int = 8,
        l_tile: int = 512, packed: bool = False, int8_luts: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch of tree-x-AH search: (distances [B, k] with inf for
    missing, ids [B, k] with -1).

    Args:
        db: the re-rank store (:mod:`scann_tpu_torch.utils.reordering`): [N,
            D] float32 rows in id order, a low-precision id-order store, or
            with ``csr_store`` an id-embedded CSR-order store.
        centers: [K, D] partition centroids.
        codes_csr: [S_pad/2, N_csr] packed (``packed``) or [S_pad, N_csr] u8
            slab; the per-pair path takes the u8 slab (the JAX function
            takes its row-major transpose).
        csr_offsets / part_sizes: [K] int32, 128-aligned partition starts
            and sizes.
        perm: [N_csr] int64 CSR row -> point id.
        codebook: [S, C, d_sub] PQ centroids.
        queries: [B, D] float32 (normalized for COSINE).
        allow_mask: [N] bool on the device, or None: restricts.
        reorder: False returns the approximate scores in measure units.
        leaf: "per_pair" — float32 per-pair leaf scores from the per-pair
            kernel (the JAX package's ``tree_ah_search``); "grouped" — the
            grouped scorer (``tree_ah_search_grouped``), shaped by ``q_cap``,
            ``l_tile`` and ``packed``, with ``int8_luts`` scoring int8
            tables (one affine per batch) into int16 sums, the flat scores
            coming back in real units.
    """
    if leaf not in ("per_pair", "grouped"):
        raise ValueError(f"unknown leaf scorer {leaf!r}")
    s_pad = 2 * codes_csr.shape[0] if packed else codes_csr.shape[0]
    parts, luts = query_tables(centers, codebook, queries, p=p, s_pad=s_pad,
                               use_residuals=use_residuals, measure=measure,
                               leaf=leaf)
    flat_scores = leaf_scores(
        luts, parts, codes_csr, csr_offsets, part_sizes, perm, leaf=leaf,
        p=p, l_cap=l_cap, q_cap=q_cap, l_tile=l_tile, packed=packed,
        int8_luts=int8_luts, allow_mask=allow_mask)
    if not reorder:
        with span("tree_ah.rerank"):
            kp = min(k * max(int(multiplicity), 1), flat_scores.shape[-1])
            vals, pos = top_k_smallest(flat_scores, kp)
            rows_sel = candidate_rows_from_positions(
                parts, csr_offsets, codes_csr.shape[1], pos, p=p)
            idx = perm[rows_sel]
            if multiplicity > 1:
                vals, idx = dedup_top_k(vals, idx, k)
            else:
                vals, idx = vals[..., :k], idx[..., :k]
            vals = vals.float()
            vals_m = approx_to_measure_units(vals, measure)
            missing = (vals >= MASKED_DISTANCE / 2) | (vals_m > pre_eps)
            return (torch.where(missing, float("inf"), vals_m),
                    torch.where(missing, -1, idx))
    order = "csr" if csr_store else "id"
    cand = preselect(flat_scores, parts, csr_offsets, perm, pre_eps,
                     pre_k=pre_k, p=p, measure=measure, order=order,
                     multiplicity=multiplicity, spill_dedup=spill_dedup)
    with span("tree_ah.rerank"):
        exact, ids = exact_rerank(db, queries, cand, measure=measure,
                                  centers=centers, parts=parts)
        if multiplicity > 1 and not cand.deduped:
            vals, idx = top_k_unique(exact, ids, k, multiplicity)
        else:
            vals, pos = top_k_smallest(exact, k)
            idx = torch.gather(ids, 1, pos)
        missing = (vals >= MASKED_DISTANCE / 2) | (vals > post_eps)
        return (torch.where(missing, float("inf"), vals),
                torch.where(missing, -1, idx))


def tree_ah_search_grouped(*args, **kwargs):
    """:func:`tree_ah_search` with ``leaf="grouped"`` (the JAX package's
    name for the grouped serving path)."""
    return tree_ah_search(*args, leaf="grouped", **kwargs)


def slab_width(s: int, packed: bool) -> int:
    """Subspaces of the serving slab: 2*align_up(ceil(S/2), 8) packed,
    align_up(S, 32) unpacked."""
    return (2 * int(align_up((s + 1) // 2, 8)) if packed
            else int(align_up(s, 32)))


def serving_slab(rows: torch.Tensor, packed: bool) -> torch.Tensor:
    """The scorers' slab of [M, S] u8 codes, pad subspaces code 0: [S_pad/2,
    M] packed low-nibble-first (byte j: subspace 2j low nibble, 2j+1 high
    nibble) or [S_pad, M] u8, S_pad = :func:`slab_width`."""
    m, s = rows.shape
    padded = torch.zeros(m, slab_width(s, packed), dtype=torch.uint8,
                         device=rows.device)
    padded[:, :s] = rows
    if packed:
        padded = padded[:, 0::2] | (padded[:, 1::2] << 4)
    return padded.T.contiguous()


# a batch's knobs, resolved by TreeXHybridSearcher.plan_request
SearchRequest = collections.namedtuple(
    "SearchRequest",
    "queries k p pre_k pre_eps post_eps q_cap multiplicity allow")


# ---------------------------------------------------------------------------
# searcher
# ---------------------------------------------------------------------------


class TreeXHybridSearcher(Searcher):
    """Partitioning + residual PQ + exact re-rank, on ``device``."""

    def __init__(self, config: Optional[TreeXHybridConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config or TreeXHybridConfig()
        _check_config(self.config)
        self.device = torch.device(device)
        self.partitioner: Optional[TreePartitioner] = None
        self.codebook: Optional[Codebook] = None
        # per-assignment codes [M, S] uint8 in CSR (partition-sorted) order,
        # M = len(tokenization.point_indices) >= N under spilling
        self.codes: Optional[torch.Tensor] = None
        self._dataset: Optional[DenseDataset] = None
        self._reset_caches()

    def _reset_caches(self) -> None:
        self._csr_cache = {}          # packed -> _csr_state tuple
        self._lp_cache = None         # low-precision id-order store
        self._csr_store_cache = None  # id-embedded CSR-order store

    # -- build ----------------------------------------------------------------
    def build(self, dataset: DenseDataset) -> "TreeXHybridSearcher":
        if dataset.is_empty:
            raise ScannError.invalid_argument("Cannot build from empty dataset")
        cfg = self.config
        if cfg.distance_measure == DistanceMeasure.COSINE:
            # normalized rows: L2 selection, residual PQ and leaf scores
            # then rank as cosine (the JAX package's host normalization)
            raw = dataset.numpy()
            norms = np.sqrt(np.einsum("nd,nd->n", raw, raw))
            dataset = DenseDataset(
                (raw / np.maximum(norms, 1e-30)[:, None]).astype(np.float32),
                docids=dataset.docids)
        hc = cfg.hash_config
        seed = hc.seed if hc.seed is not None else 42
        self._dataset = dataset
        data = dataset.device_tensor(require_device(self.device))

        self.partitioner = TreePartitioner(TreePartitionerConfig(
            num_partitions=cfg.num_partitions,
            seed=seed,
            max_partition_size=cfg.max_partition_size,
            split_stragglers=cfg.split_stragglers,
            spilling=cfg.spilling,
            spilling_threshold=cfg.spilling_threshold,
            spilling_mode=cfg.spilling_mode,
            soar_lambda=cfg.soar_lambda,
            max_iterations=cfg.partition_max_iterations,
            convergence_threshold=cfg.partition_convergence_threshold,
            num_levels=cfg.partition_num_levels,
            training_sample_size=cfg.partition_training_sample_size,
        ), device=self.device).build(data, host=dataset.numpy())

        tk = self.partitioner.tokenization
        centers = self.partitioner.centers
        row_tokens = torch.repeat_interleave(
            torch.arange(tk.num_partitions, device=self.device),
            tk.partition_sizes)
        pts = tk.point_indices
        m = len(pts)

        def resid_rows(lo: int, hi: int) -> torch.Tensor:
            rows = data[pts[lo:hi]]
            return rows - centers[row_tokens[lo:hi]] if cfg.use_residuals \
                else rows

        # AVQ weighs the residual's error along the ORIGINAL point's
        # direction (the score it protects is <q, x>): the directions are
        # the raw rows, not the residuals
        avq = hc.anisotropic_threshold is not None
        if hc.training_sample_size < m:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            sel = torch.randperm(m, generator=gen, device=self.device)[
                :hc.training_sample_size]
        else:
            sel = torch.arange(m, device=self.device)
        raw = data[pts[sel]]
        sample = (raw - centers[row_tokens[sel]] if cfg.use_residuals
                  else raw)

        self.codebook = Codebook(CodebookConfig(
            num_codes=hc.num_codes,
            num_subspaces=hc.num_subspaces,
            max_iterations=hc.max_iterations,
            seed=hc.seed,
            anisotropic_threshold=hc.anisotropic_threshold,
        ), device=self.device).train(sample,
                                     directions=raw if avq else None)
        del raw

        d = data.shape[1]
        chunk = max(min(m, _ENCODE_CHUNK_ELEMS // max(d, 1)), 8192)
        codes = torch.empty(m, hc.num_subspaces, dtype=torch.uint8,
                            device=self.device)
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            codes[lo:hi] = self.codebook.encode_dataset(
                resid_rows(lo, hi),
                directions=data[pts[lo:hi]] if avq else None)
        self.codes = codes
        self._reset_caches()
        return self

    # -- metadata ---------------------------------------------------------------
    def dataset_size(self) -> int:
        return 0 if self._dataset is None else self._dataset.size

    def dimensionality(self) -> int:
        return 0 if self._dataset is None else self._dataset.dimensionality

    def _docids(self):
        return self._dataset.docids if self._dataset is not None else None

    def memory_usage(self) -> int:
        """Bytes of the serving CSR code slab, its row table, the partition
        centres and the codebook, counted as the JAX package counts them:
        partitions 128-row aligned plus l_cap rows of slack, ceil(S/2)
        bytes a row aligned to 8 for the packed slab (align_up(S, 32)
        unpacked), 4 bytes a row for the row table."""
        tk = self.partitioner.tokenization
        sizes = tk.partition_sizes.long()
        aligned_rows = int(((sizes + 127) // 128 * 128).sum())
        l_tile = max(int(self.config.score_l_tile), 128)
        aligned_rows += int(align_up(max(tk.max_partition_size, 8), l_tile))
        packed = self._pack_codes()
        s_pad = slab_width(self.codebook.centroids.shape[0], packed)
        row_bytes = s_pad // 2 if packed else s_pad
        return int(aligned_rows * row_bytes + aligned_rows * 4
                   + self.partitioner.centers.nbytes
                   + self.codebook.centroids.nbytes)

    def _pack_codes(self) -> bool:
        """Serve the packed int4 slab? (4-bit codes; config may force the
        unpacked u8 slab)."""
        if self.codebook.num_codes > 16:
            return False
        pc = self.config.pack_codes
        return True if pc is None else bool(pc)

    def _csr_layout(self):
        """(first aligned CSR row of each partition [K+1] int64, aligned CSR
        row of each assignment [M] int64, partition of each assignment [M],
        total rows, l_cap): partition starts 128-aligned, l_cap columns of
        slack after the last partition."""
        tk = self.partitioner.tokenization
        device = self.codes.device
        l_tile = max(int(self.config.score_l_tile), 128)
        l_cap = int(align_up(max(tk.max_partition_size, 8), l_tile))
        k = tk.num_partitions
        sizes = tk.partition_sizes.to(device)
        aligned = torch.zeros(k + 1, dtype=torch.int64, device=device)
        aligned[1:] = torch.cumsum((sizes + 127) // 128 * 128, 0)
        row_tok = torch.repeat_interleave(torch.arange(k, device=device),
                                          sizes)
        dest = (aligned[row_tok] + torch.arange(len(row_tok), device=device)
                - tk.offsets.to(device)[row_tok])
        return aligned, dest, row_tok, int(aligned[-1]) + l_cap, l_cap

    def _csr_state(self, packed: Optional[bool] = None):
        """Serving layout, built on the device once per slab form:
        (codes_csr, csr_offsets [K] i32 with every partition start
        128-aligned, part_sizes [K] i32, perm [N_csr] int64 row -> point id,
        l_cap). The slab is [S_pad/2, N_csr] packed low-nibble-first with
        S_pad = 2*align_up(ceil(S/2), 8), or [align_up(S, 32), N_csr] u8
        (``packed=False``, the per-pair path's slab; :func:`serving_slab`);
        ``packed=None`` takes :meth:`_pack_codes`."""
        packed = self._pack_codes() if packed is None else bool(packed)
        if packed not in self._csr_cache:
            if packed and self.codebook.num_codes > 16:
                raise ValueError("packed int4 codes need num_codes <= 16")
            tk = self.partitioner.tokenization
            device = self.codes.device
            aligned, dest, _, total, l_cap = self._csr_layout()
            codes_rows = torch.zeros(total, self.codes.shape[1],
                                     dtype=torch.uint8, device=device)
            codes_rows[dest] = self.codes
            perm = torch.zeros(total, dtype=torch.int64, device=device)
            perm[dest] = tk.point_indices.to(device)
            self._csr_cache[packed] = (
                serving_slab(codes_rows, packed), aligned[:-1].int(),
                tk.partition_sizes.to(device).int(), perm, l_cap)
        return self._csr_cache[packed]

    def effective_q_cap(self, b: int, p: int) -> int:
        """Queries per group: the config's value, or the JAX package's rule
        (16 when a partition is expected to be probed by >= 12 pairs of the
        batch, else 8) lowered by ``fit_q_cap`` until one group's bf16
        tables fit a block's shared memory (8 at S_pad 768, C 16)."""
        if self.config.group_q_cap is not None:
            return int(self.config.group_q_cap)
        kparts = max(self.partitioner.num_partitions, 1)
        rule = 16 if (b * p) / kparts >= 12.0 else 8
        return fit_q_cap(rule, slab_width(self.codebook.centroids.shape[0],
                                         self._pack_codes()),
                         self.codebook.num_codes, int8=False)

    # -- re-rank stores ---------------------------------------------------------
    def _device_state(self):
        """The id-order re-rank store on the device: the float32 rows, or
        the low-precision store of ``rerank_dtype`` built from the host rows
        once (bf16 rows; int8 / int16 quantize each row's residual to its
        primary partition's centroid)."""
        dt = self.config.rerank_dtype
        if dt == "float32":
            return self._dataset.device_tensor(self.device)
        if self._lp_cache is None:
            data = self._dataset.numpy()
            if dt in ("int8", "int16"):
                self._lp_cache, _ = build_residual_rerank_store(
                    data, len(data),
                    self.partitioner.tokenization.tokens.cpu().numpy(),
                    self.partitioner.centers.cpu().numpy(), 1, self.device,
                    levels=65535 if dt == "int16" else 255)
            else:
                self._lp_cache, _ = build_rerank_store(data, len(data), dt, 1,
                                                       self.device)
        return self._lp_cache

    def _rerank_layout(self) -> str:
        """Resolved re-rank layout: the config's, "id" when None."""
        return self.config.rerank_layout or "id"

    def _csr_store_state(self):
        """The id-embedded CSR-order re-rank store (``rerank_layout='csr'``)
        over the rows of :meth:`_csr_state`'s layout, built once with the
        id-order store's codec (anchored codecs: calibrated on the primary
        tokens' residuals, each CSR row encoded against its own
        partition)."""
        if self._csr_store_cache is None:
            perm = self._csr_state()[3].cpu().numpy()
            data = self._dataset.numpy()
            dt = self.config.rerank_dtype
            kw = {}
            if dt in ("int8", "int16"):
                _, dest, row_tok, total, _ = self._csr_layout()
                parts = torch.zeros(total, dtype=torch.int64,
                                    device=dest.device)
                parts[dest] = row_tok
                kw = dict(row_parts=parts.cpu().numpy(),
                          tokens=self.partitioner.tokenization.tokens.cpu()
                          .numpy(),
                          centers=self.partitioner.centers.cpu().numpy())
            self._csr_store_cache = build_csr_rerank_store(
                data, perm, dt, self.device, **kw)
        return self._csr_store_cache

    def with_rerank_store(self, **changes) -> "TreeXHybridSearcher":
        """A searcher serving this built index (partitions, codebook, codes)
        under another ``rerank_dtype`` and / or ``rerank_layout``; its
        serving layouts and re-rank stores are built anew, its own."""
        self._check_built()
        unknown = set(changes) - {"rerank_dtype", "rerank_layout"}
        if unknown:
            raise ScannError.invalid_argument(
                f"only the re-rank store can change, not {sorted(unknown)}")
        other = copy.copy(self)
        other.config = dataclasses.replace(self.config, **changes)
        _check_config(other.config)
        other._reset_caches()
        return other

    # -- search -----------------------------------------------------------------
    def plan_request(self, queries: torch.Tensor, k: int,
                     params: Optional[SearchParameters], allow_mask, *,
                     device: torch.device, l_cap: int, clamp_k: bool = False
                     ) -> SearchRequest:
        """A batch's :data:`SearchRequest` for a slab of this index with
        ``l_cap`` slots a partition: queries on ``device`` (normalized for
        COSINE), p / pre_k / epsilons from ``params`` or the config, pre_k
        within [k, p*l_cap], the [N] allowlist on ``device``. ``clamp_k``
        clamps k to p*l_cap too, with a warning; else the caller pads."""
        cfg = self.config
        queries = queries.to(device).float()
        if cfg.distance_measure == DistanceMeasure.COSINE:
            queries = _normalize(queries)
        n = self.dataset_size()
        k = min(int(k), n)
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")
        p = cfg.partitions_to_search
        if params is not None and params.num_leaves_to_search is not None:
            p = params.num_leaves_to_search
        p = min(int(p), self.partitioner.num_partitions)
        if (params is not None
                and params.pre_reordering_num_neighbors is not None):
            pre_k = int(params.pre_reordering_num_neighbors)
        else:
            pre_k = int(np.ceil(k * cfg.pre_reorder_multiplier))
        max_cand = p * l_cap
        if clamp_k and (pre_k > max_cand or k > max_cand):
            warnings.warn(
                f"requested pre_k={pre_k} / k={k} exceed the {max_cand} "
                f"candidates reachable with p={p}, l_cap={l_cap}; clamping "
                f"(raise partitions_to_search for more candidates)",
                stacklevel=2)
        pre_k = min(max(pre_k, k), max_cand)
        if clamp_k:
            k = min(k, max_cand)
        allow = None
        if allow_mask is not None:
            m = np.zeros(n, dtype=bool)
            a = np.asarray(allow_mask, dtype=bool).reshape(-1)[:n]
            m[:len(a)] = a
            allow = torch.from_numpy(m).to(device)
        return SearchRequest(
            queries, k, p, pre_k, *epsilons(params),
            self.effective_q_cap(queries.shape[0], p),
            self.partitioner.tokenization.max_multiplicity, allow)

    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None,
                               allow_mask=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) for [B, D] float32
        queries on the searcher's device; no host copy of the results.
        ``allow_mask`` ([N] bool, host) restricts the results to the
        allowed ids."""
        self._check_built()
        cfg = self.config
        with span("tree_ah.search"):
            codes_csr, csr_offsets, part_sizes, perm, l_cap = \
                self._csr_state()
            req = self.plan_request(queries, k, params, allow_mask,
                                    device=self.device, l_cap=l_cap,
                                    clamp_k=True)
            # restricts go through the id layout (its perm table maps slots
            # to the ids the mask is indexed by)
            csr_store = self._rerank_layout() == "csr" and allow_mask is None
            db = (self._csr_store_state() if csr_store
                  else self._device_state())
            dists, idx = tree_ah_search(
                db, self.partitioner.centers, codes_csr, csr_offsets,
                part_sizes, perm, self.codebook.centroids, req.queries,
                req.pre_eps, req.post_eps, p=req.p, pre_k=req.pre_k, k=req.k,
                l_cap=l_cap, use_residuals=cfg.use_residuals, q_cap=req.q_cap,
                l_tile=cfg.score_l_tile, packed=self._pack_codes(),
                measure=cfg.distance_measure, allow_mask=req.allow,
                multiplicity=req.multiplicity, spill_dedup=cfg.spill_dedup,
                csr_store=csr_store, leaf="grouped")
            return idx, dists

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask: Optional[np.ndarray] = None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        self._check_built()
        queries = self._validate_queries(queries)
        idx, dists = self.search_batched_tensors(
            torch.from_numpy(queries).to(require_device(self.device)), k,
            params, allow_mask)
        return (idx.cpu().numpy().astype(np.int32),
                dists.cpu().numpy().astype(np.float32))

    def _check_built(self):
        if self.codebook is None or self.partitioner is None:
            raise ScannError.failed_precondition("searcher not built")
