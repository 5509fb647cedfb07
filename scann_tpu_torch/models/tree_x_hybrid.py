"""Tree-x-AH hybrid searcher (counterpart of
``scann_tpu/models/tree_x_hybrid.py``).

Build: k-means partitions; a global PQ codebook trained on residuals
(point - partition centroid) of a seeded sample; codes per assignment in
one partition-contiguous CSR slab.

Search, one batch of queries on the device with no host round trip:

    centroid matmul -> top-p partitions               (_select_partitions)
    -> per-(query, partition) residual LUTs           (_residual_luts)
    -> pairs grouped by partition, LUT rows gathered  (_group_luts)
    -> grouped leaf scoring over the CSR slab          (CUDA kernel,
                                                        ops/tree_ah_grouped)
    -> leaf-major flat scores [B, p*l_cap]             (_leaf_major)
    -> top-pre_k -> rows -> exact re-rank -> top-k     (_finalize)

This slice serves one assignment per point, squared L2, residual PQ with
packed int4 codes (or the unpacked u8 slab), and an exact float32 re-rank
over the id-ordered store. Balancing, spilling/SOAR, the id-embedded CSR
store, low-precision re-rank stores, non-L2 measures, restricts and int8
LUTs raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes.codebook import Codebook, CodebookConfig, lut_kernel
from scann_tpu_torch.hashes.hasher import AsymmetricHasherConfig
from scann_tpu_torch.models.searcher import SearchParameters, Searcher, epsilons
from scann_tpu_torch.ops.distances import (
    DistanceMeasure,
    approx_to_measure_units,
    gathered_distances,
    many_to_many,
)
from scann_tpu_torch.ops.topk import approx_top_k_smallest, top_k_smallest
from scann_tpu_torch.ops.tree_ah_grouped import (
    group_pairs_by_partition,
    tree_ah_grouped_scores,
)
from scann_tpu_torch.partitioning.tree_partitioner import (
    TreePartitioner,
    TreePartitionerConfig,
    check_flat_partitioning,
)
from scann_tpu_torch.types import (
    DEFAULT_DEVICE,
    MASKED_DISTANCE,
    align_up,
    require_device,
)


@dataclasses.dataclass
class TreeXHybridConfig:
    """The JAX package's ``TreeXHybridConfig`` fields this slice reads.
    ``max_partition_size`` defaults to None here (balancing is not ported);
    the JAX package's default is "auto"."""

    num_partitions: int = 100
    partitions_to_search: int = 10
    hash_config: AsymmetricHasherConfig = dataclasses.field(
        default_factory=lambda: AsymmetricHasherConfig(num_codes=16,
                                                       num_subspaces=8))
    use_residuals: bool = True
    pre_reorder_multiplier: float = 3.0
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    max_partition_size: Optional[object] = None
    spilling: bool = False
    partition_max_iterations: int = 100
    partition_convergence_threshold: float = 1e-5
    partition_num_levels: int = 1
    partition_training_sample_size: Optional[int] = None
    # grouped-scorer shape: queries per group (None = adaptive from the pair
    # density, as in the JAX package) and the L-tile the slab is padded to
    group_q_cap: Optional[int] = None
    score_l_tile: int = 512
    # packed int4 slab (None = pack when num_codes <= 16)
    pack_codes: Optional[bool] = None
    rerank_dtype: str = "float32"
    # rerank store layout: None or "id" (the id-ordered store; the JAX
    # package's auto choice "csr" returns identical results)
    rerank_layout: Optional[str] = None


def _check_config(cfg: TreeXHybridConfig) -> None:
    check_flat_partitioning(TreePartitionerConfig(
        max_partition_size=cfg.max_partition_size, spilling=cfg.spilling,
        num_levels=cfg.partition_num_levels,
        distance_measure=cfg.distance_measure))
    if cfg.rerank_dtype != "float32":
        raise NotImplementedError(
            f"rerank_dtype={cfg.rerank_dtype!r} is not ported yet "
            f"(ROADMAP.md queue 1, item 3: rerank dtypes)")
    if cfg.rerank_layout == "csr":
        raise NotImplementedError(
            "the id-embedded CSR rerank store is not ported yet (ROADMAP.md "
            "queue 1, item 3: id-embedded CSR store)")
    if cfg.rerank_layout not in (None, "id"):
        raise ScannError.invalid_argument(
            f"rerank_layout must be None, 'id' or 'csr', got "
            f"{cfg.rerank_layout!r}")


# build-time residual-encode chunking: elements per [chunk, D] residual block
_ENCODE_CHUNK_ELEMS = 150_000_000


# ---------------------------------------------------------------------------
# search stages
# ---------------------------------------------------------------------------


def _select_partitions(centers: torch.Tensor, queries: torch.Tensor, *,
                       p: int) -> torch.Tensor:
    """[B, p] nearest centroids, exact (a TPU run of the JAX package selects
    approximately past 1024 centroids; its CPU run is exact, like this)."""
    cd = many_to_many(DistanceMeasure.SQUARED_L2, queries, centers)
    return top_k_smallest(cd, p)[1]


def _residual_luts(queries: torch.Tensor, centers: torch.Tensor,
                   parts: torch.Tensor, codebook: torch.Tensor, *, s_pad: int,
                   use_residuals: bool) -> torch.Tensor:
    """[B*p, s_pad*C] squared-L2 LUTs of the residual queries q - c_t, zero
    rows for pad subspaces (pad code 0 then adds nothing)."""
    b, d = queries.shape
    p = parts.shape[1]
    if use_residuals:
        q_eff = queries[:, None, :] - centers[parts]           # [B, p, D]
    else:
        q_eff = queries[:, None, :].expand(b, p, d)
    luts = lut_kernel(q_eff.reshape(b * p, d), codebook)       # [B*p, S, C]
    s, c = luts.shape[1], luts.shape[2]
    if s_pad != s:
        luts = torch.nn.functional.pad(luts, (0, 0, 0, s_pad - s))
    return luts.reshape(b * p, s_pad * c)


def _group_luts(luts_flat: torch.Tensor, parts: torch.Tensor,
                csr_offsets: torch.Tensor, part_sizes: torch.Tensor, *,
                s_pad: int, q_cap: int, packed: bool):
    """Grouped scorer inputs: (luts_grouped [NG*q_cap, S_pad*C] bf16,
    grp_off [NG] i32, grp_size [NG] i32 with 0 for unused groups,
    slot [B*p] row of each pair)."""
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
    luts = luts_flat.to(torch.bfloat16)
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
                        q_cap: int, l_tile: int, packed: bool
                        ) -> torch.Tensor:
    """[B, p*l_cap] leaf-major bf16 scores, ``MASKED_DISTANCE`` past each
    partition's size, from the grouped scorer."""
    s_pad = 2 * codes_csr.shape[0] if packed else codes_csr.shape[0]
    luts_grouped, grp_off, grp_size, slot = _group_luts(
        luts_flat, parts, csr_offsets, part_sizes, s_pad=s_pad, q_cap=q_cap,
        packed=packed)
    scores_g = tree_ah_grouped_scores(
        luts_grouped, codes_csr, grp_off, grp_size, l_cap=l_cap,
        l_tile=l_tile, q_cap=q_cap, packed=packed)
    return _leaf_major(scores_g, slot, b=parts.shape[0], p=p, l_cap=l_cap)


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


def _finalize(db: torch.Tensor, queries: torch.Tensor,
              flat_scores: torch.Tensor, parts: torch.Tensor,
              csr_offsets: torch.Tensor, num_rows: int, perm: torch.Tensor,
              pre_eps: float, post_eps: float, *, pre_k: int, k: int, p: int,
              measure: DistanceMeasure
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-pre_k candidates -> point ids through ``perm`` -> exact re-rank
    against the id-ordered float32 rows -> top-k. Returns (distances [B, k]
    with inf for missing, ids [B, k] with -1 for missing)."""
    pre_k = min(pre_k, flat_scores.shape[-1])
    pre_vals, pre_pos = approx_top_k_smallest(flat_scores, pre_k)
    pre_rows = candidate_rows_from_positions(
        parts, csr_offsets, num_rows, pre_pos, p=p)         # [B, pre_k]
    pre_vals = pre_vals.float()
    pre_m = approx_to_measure_units(pre_vals, measure)
    pre_valid = (pre_vals < MASKED_DISTANCE / 2) & (pre_m <= pre_eps)
    pre_cand = perm[pre_rows]
    rows = db[pre_cand.clamp_min(0)]                        # [B, pre_k, D]
    exact = gathered_distances(measure, queries, rows)
    exact = torch.where(pre_valid, exact, float(MASKED_DISTANCE))
    vals, pos = top_k_smallest(exact, k)
    idx = torch.gather(pre_cand, 1, pos)
    missing = (vals >= MASKED_DISTANCE / 2) | (vals > post_eps)
    return (torch.where(missing, float("inf"), vals),
            torch.where(missing, -1, idx))


def tree_ah_search_grouped(
        db: torch.Tensor, centers: torch.Tensor, codes_csr: torch.Tensor,
        csr_offsets: torch.Tensor, part_sizes: torch.Tensor,
        perm: torch.Tensor, codebook: torch.Tensor, queries: torch.Tensor,
        pre_eps: float, post_eps: float, *, p: int, pre_k: int, k: int,
        l_cap: int, use_residuals: bool, q_cap: int, l_tile: int,
        packed: bool,
        measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch through the grouped serving path: (distances, ids).

    Args:
        db: [N, D] float32 rows in id order (the re-rank store).
        centers: [K, D] partition centroids.
        codes_csr: [S_pad/2, N_csr] packed (or [S_pad, N_csr] u8) slab.
        csr_offsets / part_sizes: [K] int32, 128-aligned partition starts
            and sizes.
        perm: [N_csr] int64 CSR row -> point id.
        codebook: [S, C, d_sub] PQ centroids.
        queries: [B, D] float32.
    """
    if measure != DistanceMeasure.SQUARED_L2:
        raise NotImplementedError(
            f"tree-AH search under {measure} is not ported yet (ROADMAP.md "
            f"queue 1, item 3: non-L2 measures)")
    parts = _select_partitions(centers, queries, p=p)
    s_pad = 2 * codes_csr.shape[0] if packed else codes_csr.shape[0]
    luts_flat = _residual_luts(queries, centers, parts, codebook, s_pad=s_pad,
                               use_residuals=use_residuals)
    flat_scores = leaf_scores_grouped(
        luts_flat, parts, codes_csr, csr_offsets, part_sizes, p=p,
        l_cap=l_cap, q_cap=q_cap, l_tile=l_tile, packed=packed)
    return _finalize(db, queries, flat_scores, parts, csr_offsets,
                     codes_csr.shape[1], perm, pre_eps, post_eps,
                     pre_k=pre_k, k=k, p=p, measure=measure)


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
        # per-assignment codes [M, S] uint8 in CSR (partition-sorted) order
        self.codes: Optional[torch.Tensor] = None
        self._dataset: Optional[DenseDataset] = None
        self._csr_cache = None

    # -- build ----------------------------------------------------------------
    def build(self, dataset: DenseDataset) -> "TreeXHybridSearcher":
        if dataset.is_empty:
            raise ScannError.invalid_argument("Cannot build from empty dataset")
        cfg = self.config
        hc = cfg.hash_config
        seed = hc.seed if hc.seed is not None else 42
        self._dataset = dataset
        data = dataset.device_tensor(require_device(self.device))

        self.partitioner = TreePartitioner(TreePartitionerConfig(
            num_partitions=cfg.num_partitions,
            seed=seed,
            max_partition_size=cfg.max_partition_size,
            spilling=cfg.spilling,
            max_iterations=cfg.partition_max_iterations,
            convergence_threshold=cfg.partition_convergence_threshold,
            num_levels=cfg.partition_num_levels,
            training_sample_size=cfg.partition_training_sample_size,
        ), device=self.device).build(data)

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

        if hc.training_sample_size < m:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            sel = torch.randperm(m, generator=gen, device=self.device)[
                :hc.training_sample_size]
            sample = data[pts[sel]]
            if cfg.use_residuals:
                sample = sample - centers[row_tokens[sel]]
        else:
            sample = resid_rows(0, m)

        self.codebook = Codebook(CodebookConfig(
            num_codes=hc.num_codes,
            num_subspaces=hc.num_subspaces,
            max_iterations=hc.max_iterations,
            seed=hc.seed,
            anisotropic_threshold=hc.anisotropic_threshold,
        ), device=self.device).train(sample)

        d = data.shape[1]
        chunk = max(min(m, _ENCODE_CHUNK_ELEMS // max(d, 1)), 8192)
        codes = torch.empty(m, hc.num_subspaces, dtype=torch.uint8,
                            device=self.device)
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            codes[lo:hi] = self.codebook.encode_dataset(resid_rows(lo, hi))
        self.codes = codes
        self._csr_cache = None
        return self

    # -- metadata ---------------------------------------------------------------
    def dataset_size(self) -> int:
        return 0 if self._dataset is None else self._dataset.size

    def dimensionality(self) -> int:
        return 0 if self._dataset is None else self._dataset.dimensionality

    def _pack_codes(self) -> bool:
        """Serve the packed int4 slab? (4-bit codes; config may force the
        unpacked u8 slab)."""
        if self.codebook.num_codes > 16:
            return False
        pc = self.config.pack_codes
        return True if pc is None else bool(pc)

    def _csr_state(self):
        """Serving layout, built on the device once: (codes_csr, csr_offsets
        [K] i32 with every partition start 128-aligned, part_sizes [K] i32,
        perm [N_csr] int64 row -> point id, l_cap). The slab is
        [S_pad/2, N_csr] packed low-nibble-first with
        S_pad = 2*align_up(ceil(S/2), 8), or [align_up(S, 32), N_csr] u8;
        N_csr leaves l_cap columns of slack after the last partition."""
        if self._csr_cache is None:
            tk = self.partitioner.tokenization
            device = self.codes.device
            l_tile = max(int(self.config.score_l_tile), 128)
            l_cap = int(align_up(max(tk.max_partition_size, 8), l_tile))
            k = tk.num_partitions
            sizes = tk.partition_sizes.to(device)
            aligned = torch.zeros(k + 1, dtype=torch.int64, device=device)
            aligned[1:] = torch.cumsum((sizes + 127) // 128 * 128, 0)
            total = int(aligned[-1]) + l_cap
            m, s = self.codes.shape
            packed = self._pack_codes()
            s_pad = (2 * int(align_up((s + 1) // 2, 8)) if packed
                     else int(align_up(s, 32)))
            row_tok = torch.repeat_interleave(
                torch.arange(k, device=device), sizes)
            dest = (aligned[row_tok] + torch.arange(m, device=device)
                    - tk.offsets.to(device)[row_tok])
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
            self._csr_cache = (slab.T.contiguous(), aligned[:-1].int(),
                               sizes.int(), perm, l_cap)
        return self._csr_cache

    def effective_q_cap(self, b: int, p: int) -> int:
        """Queries per group: the config's value, or 16 when a partition is
        expected to be probed by >= 12 pairs of the batch, else 8 (the JAX
        package's rule)."""
        if self.config.group_q_cap is not None:
            return int(self.config.group_q_cap)
        kparts = max(self.partitioner.num_partitions, 1)
        return 16 if (b * p) / kparts >= 12.0 else 8

    # -- search -----------------------------------------------------------------
    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) for [B, D] float32
        queries on the searcher's device; no host copy of the results."""
        self._check_built()
        cfg = self.config
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
        max_cand = p * l_cap
        if pre_k > max_cand or k > max_cand:
            warnings.warn(
                f"requested pre_k={pre_k} / k={k} exceed the {max_cand} "
                f"candidates reachable with p={p}, l_cap={l_cap}; clamping "
                f"(raise partitions_to_search for more candidates)",
                stacklevel=2)
        pre_k = min(max(pre_k, k), max_cand)
        k_eff = min(k, max_cand)

        dists, idx = tree_ah_search_grouped(
            self._dataset.device_tensor(self.device),
            self.partitioner.centers, codes_csr, csr_offsets, part_sizes,
            perm, self.codebook.centroids, queries.float(), pre_eps, post_eps,
            p=p, pre_k=pre_k, k=k_eff, l_cap=l_cap,
            use_residuals=cfg.use_residuals,
            q_cap=self.effective_q_cap(queries.shape[0], p),
            l_tile=cfg.score_l_tile, packed=self._pack_codes(),
            measure=cfg.distance_measure)
        return idx, dists

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask: Optional[np.ndarray] = None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        if allow_mask is not None:
            raise NotImplementedError(
                "restricts (allow_mask) are not ported yet (ROADMAP.md "
                "queue 1, item 3: restricts)")
        self._check_built()
        queries = self._validate_queries(queries)
        idx, dists = self.search_batched_tensors(
            torch.from_numpy(queries).to(require_device(self.device)), k,
            params)
        return (idx.cpu().numpy().astype(np.int32),
                dists.cpu().numpy().astype(np.float32))

    def _check_built(self):
        if self.codebook is None or self.partitioner is None:
            raise ScannError.failed_precondition("searcher not built")
