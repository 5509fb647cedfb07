"""Tree-x-AH hybrid searcher (counterpart of
``scann_tpu/models/tree_x_hybrid.py``).

Build: k-means partitions (optionally balanced to a size cap, and spilled:
a second assignment per point by distance or by the SOAR loss); a global PQ
codebook trained on residuals (point - partition centroid) of a seeded
sample; codes per ASSIGNMENT in one partition-contiguous CSR slab, so a
spilled point's two rows each encode the residual against their own
partition's centroid.

Search, one batch of queries on the device with no host round trip:

    centroid matmul -> top-p partitions               (_select_partitions)
    -> per-(query, partition) LUTs                     (_residual_luts)
    -> leaf scoring over the CSR slab, one of:
         grouped: pairs grouped by partition, LUT rows gathered, the
           grouped scorer (CUDA kernel, ops/tree_ah_grouped) with bf16 or
           int8 tables                                 (tree_ah_search_grouped)
         per pair: every pair's float32 table over its partition's codes
           (CUDA kernel, ops/tree_ah_leaf)             (tree_ah_search)
    -> leaf-major flat scores [B, p*l_cap], allowlist mask
    -> top-pre_k (x multiplicity under spilling, then keep-best-per-id):
       on the card the bf16 rows go to the exact selection kernel
       (ops/topk, csrc/topk_select.cu), the int64 key's results bit for
       bit; the selection stays exact, where the JAX package's TPU path
       calls lax.approx_min_k
    -> rows from the re-rank store -> exact re-rank -> top-k   (_finalize)

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
from scann_tpu_torch.ops.topk import (
    approx_top_k_smallest,
    dedup_top_k,
    keep_best_per_id,
    top_k_smallest,
    top_k_unique,
)
from scann_tpu_torch.ops.tree_ah_grouped import (
    I16_MASK,
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
    gather_csr_rerank_rows,
    gather_rerank_rows,
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


def _residual_luts(queries: torch.Tensor, centers: torch.Tensor,
                   parts: torch.Tensor, codebook: torch.Tensor, *, s_pad: int,
                   use_residuals: bool,
                   measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
                   ) -> torch.Tensor:
    """[B*p, s_pad*C] per-(query, partition) LUTs, zero rows for pad
    subspaces (pad code 0 then adds nothing).

    Squared L2 (and cosine on normalized vectors): LUTs of the residual
    queries q - c_t. MIPS: -dot(q_s, codebook[s][c]) tables with the
    partition's constant -dot(q, c_t) folded into subspace 0, so the sums
    are -dot(q, c_t + r) and compare across partitions."""
    b, d = queries.shape
    p = parts.shape[1]
    if measure in _MIPS:
        s, c, dsub = codebook.shape
        qs = queries.reshape(b, s, dsub)
        luts = -torch.einsum("bsd,scd->bsc", qs, codebook)     # [B, S, C]
        luts = luts[:, None].expand(b, p, s, c).clone()
        if use_residuals:
            bias = -torch.einsum("bd,bpd->bp", queries, centers[parts])
            luts[:, :, 0, :] += bias[:, :, None]
        luts = luts.reshape(b * p, s, c)
    else:
        if use_residuals:
            q_eff = queries[:, None, :] - centers[parts]       # [B, p, D]
        else:
            q_eff = queries[:, None, :].expand(b, p, d)
        luts = lut_kernel(q_eff.reshape(b * p, d), codebook)   # [B*p, S, C]
    s, c = luts.shape[1], luts.shape[2]
    if s_pad != s:
        luts = torch.nn.functional.pad(luts, (0, 0, 0, s_pad - s))
    return luts.reshape(b * p, s_pad * c)


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


def _group_luts(luts_flat: torch.Tensor, parts: torch.Tensor,
                csr_offsets: torch.Tensor, part_sizes: torch.Tensor, *,
                s_pad: int, q_cap: int, packed: bool):
    """Grouped scorer inputs: (luts_grouped [NG*q_cap, S_pad*C] bf16, or
    int8 when ``luts_flat`` is int8; grp_off [NG] i32, grp_size [NG] i32
    with 0 for unused groups, slot [B*p] row of each pair)."""
    bp = luts_flat.shape[0]
    grp_part, slot, ng = group_pairs_by_partition(
        parts, part_sizes.shape[0], q_cap)
    grp_safe = grp_part.clamp_min(0)
    grp_off = csr_offsets[grp_safe]
    grp_size = torch.where(grp_part >= 0, part_sizes[grp_safe], 0)
    pair_of_slot = torch.zeros(ng * q_cap, dtype=torch.int64,
                               device=luts_flat.device)
    pair_of_slot[slot] = torch.arange(bp, device=luts_flat.device)
    # bf16 before the gather: the scorer sums bf16 table entries anyway
    luts = (luts_flat if luts_flat.dtype == torch.int8
            else luts_flat.to(torch.bfloat16))
    if packed:
        # even-first subspace order, the order the nibble unpack yields
        l3 = luts.reshape(bp, s_pad, -1)
        luts = torch.cat([l3[:, 0::2], l3[:, 1::2]], dim=1).reshape(bp, -1)
    return (luts[pair_of_slot].contiguous(), grp_off.int().contiguous(),
            grp_size.int().contiguous(), slot)


def _leaf_major(scores_g: torch.Tensor, slot: torch.Tensor, *, b: int, p: int,
                l_cap: int) -> torch.Tensor:
    """[B, p*l_cap] flat scores, leaf-major (position l*p + t holds slot l
    of the query's t-th partition) — the JAX package's layout, kept so flat
    positions match it one to one."""
    return scores_g[slot].reshape(b, p, l_cap).transpose(1, 2).reshape(
        b, p * l_cap)


def leaf_scores_grouped(luts_flat: torch.Tensor, parts: torch.Tensor,
                        codes_csr: torch.Tensor, csr_offsets: torch.Tensor,
                        part_sizes: torch.Tensor, *, p: int, l_cap: int,
                        q_cap: int, l_tile: int, packed: bool,
                        int8_luts: bool = False) -> torch.Tensor:
    """[B, p*l_cap] leaf-major scores, ``MASKED_DISTANCE`` past each
    partition's size, from the grouped scorer: bf16, or with ``int8_luts``
    float32 restored from the int16 sums by the batch's affine
    ``scale * (s + 128 * s_pad) + s_pad * lo`` (real units survive, so
    epsilons keep their meaning)."""
    s_pad = 2 * codes_csr.shape[0] if packed else codes_csr.shape[0]
    with span("tree_ah.group"):
        if int8_luts:
            luts_flat, lo, scale = quantize_luts_int8(luts_flat)
        luts_grouped, grp_off, grp_size, slot = _group_luts(
            luts_flat, parts, csr_offsets, part_sizes, s_pad=s_pad,
            q_cap=q_cap, packed=packed)
    with span("tree_ah.leaf"):
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


def _finalize(db, queries: torch.Tensor, flat_scores: torch.Tensor,
              parts: torch.Tensor, csr_offsets: torch.Tensor, num_rows: int,
              perm: torch.Tensor, pre_eps: float, post_eps: float, *,
              pre_k: int, k: int, p: int, measure: DistanceMeasure,
              reorder: bool = True, multiplicity: int = 1,
              spill_dedup: bool = True, csr_store: bool = False,
              centers: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate candidate selection -> (dedup) -> exact re-rank -> top-k.
    Returns (distances [B, k] with inf for missing, ids [B, k] with -1).

    Candidate CSR rows resolve arithmetically from the flat positions;
    point ids resolve through ``perm`` for the survivors only.
    ``reorder=False`` returns the approximate scores in measure units.
    Under spilling (``multiplicity`` > 1) the approximate stage selects
    pre_k x multiplicity slots; ``spill_dedup`` keeps each id's best slot
    (:func:`keep_best_per_id`) before the gather, else every slot is
    gathered and the exact top-k dedups (:func:`top_k_unique`).
    ``csr_store``: ``db`` is an id-embedded CSR-ordered store; the gather
    takes the CSR rows directly and the ids decode from its digit lanes,
    an anchored store's residual rows getting each slot's partition
    centroid (``centers``) back; copies dedup after the exact scores."""
    if not reorder:
        with span("tree_ah.rerank"):
            kp = min(k * max(int(multiplicity), 1), flat_scores.shape[-1])
            vals, pos = top_k_smallest(flat_scores, kp)
            rows_sel = candidate_rows_from_positions(parts, csr_offsets,
                                                     num_rows, pos, p=p)
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

    mult = max(int(multiplicity), 1)
    dedup_first = spill_dedup and mult > 1 and not csr_store
    width = flat_scores.shape[-1]
    sel_k = min(pre_k * mult, width) if mult > 1 else min(pre_k, width)
    with span("tree_ah.preselect"):
        pre_vals, pre_pos = approx_top_k_smallest(flat_scores, sel_k)
        pre_rows = candidate_rows_from_positions(
            parts, csr_offsets, num_rows, pre_pos, p=p)     # [B, sel_k]
        pre_vals = pre_vals.float()
        pre_m = approx_to_measure_units(pre_vals, measure)
        pre_valid = (pre_vals < MASKED_DISTANCE / 2) & (pre_m <= pre_eps)
        if not csr_store:
            pre_cand = perm[pre_rows]
            if dedup_first:
                masked = torch.where(pre_valid, pre_vals,
                                     float(MASKED_DISTANCE))
                dvals, pre_cand = keep_best_per_id(masked, pre_cand,
                                                   min(pre_k, sel_k))
                pre_valid = dvals < MASKED_DISTANCE / 2
    with span("tree_ah.rerank"):
        if csr_store:
            rows, pre_cand = gather_csr_rerank_rows(db, pre_rows,
                                                    queries.shape[-1])
            if isinstance(db, tuple):
                # anchored store: slot j belongs to partition parts[b, j % p]
                rows = rows + centers[torch.gather(parts, 1, pre_pos % p)]
        else:
            # [B, pre_k, D]
            rows = gather_rerank_rows(db, pre_cand.clamp_min(0))
        norms = torch.sum(rows * rows, dim=-1)
        exact = gathered_distances(measure, queries, rows, norms)
        exact = torch.where(pre_valid, exact, float(MASKED_DISTANCE))
        if mult > 1 and not dedup_first:
            vals, idx = top_k_unique(exact, pre_cand, k, multiplicity)
        else:
            vals, pos = top_k_smallest(exact, k)
            idx = torch.gather(pre_cand, 1, pos)
        missing = (vals >= MASKED_DISTANCE / 2) | (vals > post_eps)
        return (torch.where(missing, float("inf"), vals),
                torch.where(missing, -1, idx))


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
    """One batch of tree-x-AH search: (distances, ids).

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
        leaf: "per_pair" — float32 per-pair leaf scores from the per-pair
            kernel (the JAX package's ``tree_ah_search``); "grouped" — the
            grouped scorer (``tree_ah_search_grouped``), shaped by ``q_cap``,
            ``l_tile`` and ``packed``, with ``int8_luts`` scoring int8
            tables (one affine per batch) into int16 sums, the flat scores
            coming back in real units.
    """
    if leaf not in ("per_pair", "grouped"):
        raise ValueError(f"unknown leaf scorer {leaf!r}")
    with span("tree_ah.partitions"):
        parts = _select_partitions(centers, queries, p=p, measure=measure)
    s_pad = 2 * codes_csr.shape[0] if packed else codes_csr.shape[0]
    with span("tree_ah.luts"):
        luts_flat = _residual_luts(queries, centers, parts, codebook,
                                   s_pad=s_pad, use_residuals=use_residuals,
                                   measure=measure)
    if leaf == "grouped":
        flat_scores = leaf_scores_grouped(
            luts_flat, parts, codes_csr, csr_offsets, part_sizes, p=p,
            l_cap=l_cap, q_cap=q_cap, l_tile=l_tile, packed=packed,
            int8_luts=int8_luts)
    else:
        flat_scores = leaf_scores_per_pair(
            luts_flat, parts, codes_csr, csr_offsets, part_sizes, p=p,
            l_cap=l_cap, c=codebook.shape[1])
    num_rows = codes_csr.shape[1]
    if allow_mask is not None:
        with span("tree_ah.mask"):
            flat_scores = _mask_disallowed(flat_scores, allow_mask, perm,
                                           parts, csr_offsets, num_rows, p=p,
                                           l_cap=l_cap)
    return _finalize(db, queries, flat_scores, parts, csr_offsets, num_rows,
                     perm, pre_eps, post_eps, pre_k=pre_k, k=k, p=p,
                     measure=measure, reorder=reorder,
                     multiplicity=multiplicity, spill_dedup=spill_dedup,
                     csr_store=csr_store, centers=centers)


def tree_ah_search_grouped(*args, **kwargs):
    """:func:`tree_ah_search` with ``leaf="grouped"`` (the JAX package's
    name for the grouped serving path)."""
    return tree_ah_search(*args, leaf="grouped", **kwargs)


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
        s = self.codes.shape[1]
        row_bytes = (int(align_up((s + 1) // 2, 8)) if self._pack_codes()
                     else int(align_up(s, 32)))
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
        (``packed=False``, the per-pair path's slab); ``packed=None`` takes
        :meth:`_pack_codes`."""
        packed = self._pack_codes() if packed is None else bool(packed)
        if packed not in self._csr_cache:
            if packed and self.codebook.num_codes > 16:
                raise ValueError("packed int4 codes need num_codes <= 16")
            tk = self.partitioner.tokenization
            device = self.codes.device
            aligned, dest, _, total, l_cap = self._csr_layout()
            m, s = self.codes.shape
            s_pad = (2 * int(align_up((s + 1) // 2, 8)) if packed
                     else int(align_up(s, 32)))
            codes_aligned = torch.zeros(total, s_pad, dtype=torch.uint8,
                                        device=device)
            codes_aligned[dest, :s] = self.codes
            perm = torch.zeros(total, dtype=torch.int64, device=device)
            perm[dest] = tk.point_indices.to(device)
            if packed:
                # byte j: subspace 2j low nibble, 2j+1 high nibble
                slab = codes_aligned[:, 0::2] | (codes_aligned[:, 1::2] << 4)
            else:
                slab = codes_aligned
            self._csr_cache[packed] = (
                slab.T.contiguous(), aligned[:-1].int(),
                tk.partition_sizes.to(device).int(), perm, l_cap)
        return self._csr_cache[packed]

    def effective_q_cap(self, b: int, p: int) -> int:
        """Queries per group: the config's value, or 16 when a partition is
        expected to be probed by >= 12 pairs of the batch, else 8 (the JAX
        package's rule)."""
        if self.config.group_q_cap is not None:
            return int(self.config.group_q_cap)
        kparts = max(self.partitioner.num_partitions, 1)
        return 16 if (b * p) / kparts >= 12.0 else 8

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

    def _allow_tensor(self, allow_mask) -> torch.Tensor:
        """[N] bool allowlist on the device (ids past the mask: denied)."""
        n = self.dataset_size()
        m = np.zeros(n, dtype=bool)
        a = np.asarray(allow_mask, dtype=bool).reshape(-1)[:n]
        m[:len(a)] = a
        return torch.from_numpy(m).to(self.device)

    # -- search -----------------------------------------------------------------
    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None,
                               allow_mask=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) for [B, D] float32
        queries on the searcher's device; no host copy of the results.
        ``allow_mask`` ([N] bool, host) restricts the results to the
        allowed ids."""
        with span("tree_ah.search"):
            return self._search(queries, k, params, allow_mask)

    def _search(self, queries: torch.Tensor, k: int,
                params: Optional[SearchParameters], allow_mask
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        self._check_built()
        cfg = self.config
        queries = queries.to(self.device).float()
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
        pre_eps, post_eps = epsilons(params)

        codes_csr, csr_offsets, part_sizes, perm, l_cap = self._csr_state()
        # restricts go through the id layout (its perm table maps slots to
        # the ids the mask is indexed by)
        csr_store = self._rerank_layout() == "csr" and allow_mask is None
        db = self._csr_store_state() if csr_store else self._device_state()
        max_cand = p * l_cap
        if pre_k > max_cand or k > max_cand:
            warnings.warn(
                f"requested pre_k={pre_k} / k={k} exceed the {max_cand} "
                f"candidates reachable with p={p}, l_cap={l_cap}; clamping "
                f"(raise partitions_to_search for more candidates)",
                stacklevel=2)
        pre_k = min(max(pre_k, k), max_cand)
        k_eff = min(k, max_cand)

        dists, idx = tree_ah_search(
            db, self.partitioner.centers, codes_csr, csr_offsets, part_sizes,
            perm, self.codebook.centroids, queries, pre_eps, post_eps,
            p=p, pre_k=pre_k, k=k_eff, l_cap=l_cap,
            use_residuals=cfg.use_residuals,
            q_cap=self.effective_q_cap(queries.shape[0], p),
            l_tile=cfg.score_l_tile, packed=self._pack_codes(),
            measure=cfg.distance_measure,
            allow_mask=(None if allow_mask is None
                        else self._allow_tensor(allow_mask)),
            multiplicity=self.partitioner.tokenization.max_multiplicity,
            spill_dedup=cfg.spill_dedup, csr_store=csr_store, leaf="grouped")
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
