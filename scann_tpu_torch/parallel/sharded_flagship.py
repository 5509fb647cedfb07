"""Database sharding for the flagship searchers (counterpart of
``scann_tpu/parallel/sharded_flagship.py``): the asymmetric hasher, tree-x-AH
and the block sweep, served over a :class:`~scann_tpu_torch.parallel.mesh.
Mesh`, and the sharded tree-x-AH build.

Database rows never move: each shard scores its own block with the same
kernel the single-device searcher uses — the fused LUT16 sweep
(``ops/scoring_kernels``, #7), the grouped tree-x-AH leaf scorer
(``ops/tree_ah_grouped``, #1; the per-pair scorer ``ops/tree_ah_leaf``
under ``force_kernel="xla"``) and the block-min sweep (``ops/sweep``, #5 or
the form ``sweep_plan`` routes to) — re-ranks its own candidates against its
own rows and keeps a local top-k; only the [B, k] exact partials move to
the mesh's home device (``all_gather`` across processes) and merge. Every
shard keeps a full local pre_k, so recall is at least the single-device
searcher's at equal knobs.

The searcher's distance measure reaches every stage (cosine queries are
normalized as the single-device searchers normalize them, MIPS takes -dot
tables), restrict allowlists fuse into scoring as masks, and pre / post
epsilons compare in the measure's own units.

Tree-x-AH shards by partition ownership: partitions are bin-packed onto
shards by size; a shard holds its partitions' codes and re-rank rows in one
local CSR order (so the exact re-rank gathers locally), and the partitions
it does not own have size 0 there. Centroids and codebooks replicate.
Shards on one device compute the partition selection and the tables once.

The per-shard layouts (:func:`_compute_tree_shard_layout`,
:func:`_compute_sweep_shard_layout`) are the JAX package's, array for
array: they are the file format of ``save_layout``
(:func:`scann_tpu_torch.io.save_sharded_layout`), which either package
reads. Their arrays are numpy, except bfloat16 ones, which are torch CPU
tensors (numpy has no bfloat16).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.models.searcher import (
    SearchParameters,
    Searcher,
    epsilons,
    pad_results_to_k,
)
from scann_tpu_torch.models.tree_x_hybrid import (
    exact_rerank,
    leaf_scores,
    preselect,
    query_tables,
    serving_slab,
)
from scann_tpu_torch.ops.distances import (
    DistanceMeasure,
    approx_to_measure_units,
)
from scann_tpu_torch.ops.topk import (
    approx_top_k_smallest,
    merge_top_k,
    top_k_smallest,
    top_k_unique,
)
from scann_tpu_torch.parallel.mesh import (
    Mesh,
    gather_columns,
    make_mesh,
    replicate,
)
from scann_tpu_torch.types import MASKED_DISTANCE, align_up, cdiv
from scann_tpu_torch.utils.reordering import (
    encode_rerank_rows,
    rerank_codec,
)
from scann_tpu_torch.utils.trace import span

INF = float("inf")


def _merge_partials(mesh: Mesh, vals: List[Optional[torch.Tensor]],
                    idx: List[Optional[torch.Tensor]], k: int,
                    multiplicity: int, post_eps: float,
                    db_axis: str = "db") -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the per-shard [B, k_local] exact partials on the mesh's home
    device and merge to the global top-k (unique ids under spilling), with
    the post-reordering threshold: (distances, ids), inf / -1 where
    missing."""
    all_vals = gather_columns(mesh, vals, db_axis)
    all_idx = gather_columns(mesh, idx, db_axis)
    if multiplicity > 1:
        out_vals, out_idx = top_k_unique(all_vals, all_idx, k, multiplicity)
    else:
        out_vals, out_idx = merge_top_k(all_vals, all_idx, k)
    missing = (out_vals >= MASKED_DISTANCE / 2) | (out_vals > post_eps)
    return (torch.where(missing, INF, out_vals),
            torch.where(missing, -1, out_idx))


def _per_device(fn: Callable[[torch.device], object]):
    """``fn(device)`` computed once a device: shards on one device share
    the replicated stages of a batch."""
    cache: Dict[torch.device, object] = {}

    def get(dev: torch.device):
        if dev not in cache:
            cache[dev] = fn(dev)
        return cache[dev]

    return get


def _to_host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _shard_store(rows, dequant, dev: torch.device, tok=None, centers=None):
    """One shard's re-rank store on ``dev``, in the form
    :func:`~scann_tpu_torch.utils.reordering.gather_rerank_rows` reads:
    float32 or bf16 rows, ``(u8 codes, scale, mn)`` for the int8 codec, or
    ``(u8 codes, scale, mn, tokens, centers)`` when each row's residual is
    anchored on a partition centroid."""
    t = rows if isinstance(rows, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(rows))
    t = t.to(dev)
    if dequant is None:
        return t
    sc = torch.from_numpy(np.asarray(dequant[0], np.float32)).to(dev)
    mn = torch.from_numpy(np.asarray(dequant[1], np.float32)).to(dev)
    if tok is None:
        return (t, sc, mn)
    return (t, sc, mn,
            torch.from_numpy(np.asarray(tok, np.int64)).to(dev),
            centers.to(dev))


def _dequant_arrays(dequant):
    if dequant is None:
        return None
    return (np.asarray(dequant[0], np.float32),
            np.asarray(dequant[1], np.float32))


def _check_layout_shards(layout: dict, n_sh: int) -> None:
    if int(layout["n_sh"]) != n_sh:
        raise ScannError.invalid_argument(
            f"saved layout was computed for {layout['n_sh']} shards, "
            f"mesh has {n_sh}")


# ---------------------------------------------------------------------------
# sharded LUT16 sweep (AsymmetricHasher scale-out)
# ---------------------------------------------------------------------------


def sharded_ah_sweep_kernel(mesh: Mesh, *, pre_k: int, k: int,
                            measure: DistanceMeasure, kernel: str = "xla",
                            with_mask: bool = False, r: int = 32,
                            db_axis: str = "db"):
    """``fn(centroids, codes, db, n_valid, queries, allow_mask=None,
    pre_eps=inf, post_eps=inf) -> (dists, idx)``: the per-shard body of the
    sharded hasher. ``centroids`` is replicated (:func:`replicate`), the
    others are per-shard lists over ``db_axis``: ``db`` the shards'
    re-rank stores ([blk] rows each), ``allow_mask`` [blk] bool.

    kernel="xla": ``codes`` [blk, S] u8, the plain score path
        (:func:`~scann_tpu_torch.ops.lut16_scoring.lut_score`) — the only
        one that takes ``allow_mask`` (the fused sweep's in-kernel r:1
        block minimum cannot mask a row).
    kernel="fused": ``codes`` [S_pad/2, blk] packed nibbles; the fused
        LUT16 sweep of the single-device hasher (#7) runs on each shard.

    Per shard: local approximate top-pre_k -> local exact re-rank -> local
    top-k; the partials merge on the home device."""
    from scann_tpu_torch.hashes.hasher import (
        _ah_luts,
        fused_candidates,
        quantized_tables,
        rerank_exact,
    )
    from scann_tpu_torch.ops.lut16_scoring import lut_score
    from scann_tpu_torch.ops.scoring_kernels import lut16_fused_sweep
    from scann_tpu_torch.utils.reordering import rerank_store_rows

    if kernel not in ("xla", "fused"):
        raise ScannError.invalid_argument(
            f"kernel must be 'xla' or 'fused', got {kernel!r}")
    if kernel == "fused" and with_mask:
        raise ScannError.invalid_argument(
            "fused sweep cannot apply allow masks; use kernel='xla'")

    def fn(centroids, codes, db, n_valid: int, queries: torch.Tensor,
           allow_mask=None, pre_eps: float = INF, post_eps: float = INF):
        local_q = _per_device(lambda dev: queries.to(dev))
        luts_of = _per_device(
            lambda dev: _ah_luts(local_q(dev), centroids[dev], measure))
        tables_of = _per_device(lambda dev: quantized_tables(luts_of(dev)))
        vals_l, idx_l, k_local = [], [], 1
        for i, (codes_s, db_s) in enumerate(zip(codes, db)):
            if db_s is None:
                vals_l.append(None)
                idx_l.append(None)
                continue
            blk = rerank_store_rows(db_s)
            row0 = i * blk
            nv_loc = min(max(int(n_valid) - row0, 0), blk)
            dev = codes_s.device
            q = local_q(dev)
            s_real = centroids[dev].shape[0]
            if kernel == "fused":
                luts_i8, mult, bias = tables_of(dev)
                comb = lut16_fused_sweep(luts_i8, codes_s, nv_loc, r=r)
                pk = min(pre_k, blk // r)
                cand, pre_valid = fused_candidates(
                    comb, mult, bias, s_real, pre_k=pk, r=r,
                    measure=measure, pre_eps=pre_eps)
            else:
                approx = lut_score(luts_of(dev), codes_s)      # [B, blk]
                ok = torch.arange(blk, device=dev) < nv_loc
                if allow_mask is not None:
                    ok = ok & allow_mask[i].to(dev)
                approx = torch.where(ok[None, :], approx,
                                     approx.new_tensor(float(MASKED_DISTANCE)))
                pk = min(pre_k, blk)
                avals, cand = approx_top_k_smallest(approx, pk)
                approx = avals.float()
                pre_valid = approx < MASKED_DISTANCE / 2
                approx_m = approx_to_measure_units(approx, measure)
                pre_valid = pre_valid & (approx_m <= pre_eps)
            pre_valid = pre_valid & (cand < nv_loc)
            exact = rerank_exact(db_s, q, cand, pre_valid, measure)
            # local partials may be narrower than k (pk = blk when k > blk);
            # the gather supplies n_sh * k_local >= k candidates
            k_local = min(k, pk)
            vals, pos = top_k_smallest(exact, k_local)
            idx = torch.gather(cand, 1, pos) + row0
            vals_l.append(vals)
            idx_l.append(torch.where(vals < MASKED_DISTANCE / 2, idx, -1))
        return _merge_partials(mesh, vals_l, idx_l, k, 1, post_eps, db_axis)

    return fn


class ShardedAsymmetricHasher(Searcher):
    """LUT16 / PQ sweep with codes and re-rank rows sharded over a mesh."""

    FUSED_TILE_N = 1024
    FUSED_R = 32

    def __init__(self, hasher, mesh: Optional[Mesh] = None,
                 force_kernel: Optional[str] = None,
                 fused_r: Optional[int] = None):
        """Wrap a built single-device ``AsymmetricHasher`` (trained once,
        served sharded). ``force_kernel`` ("xla" | "fused") overrides the
        choice, which is the fused sweep for 16-code books as in the
        single-device hasher; ``fused_r`` overrides the block-min reduction
        factor (a smaller r keeps more candidates a shard)."""
        if hasher.codebook is None or hasher._dataset is None:
            raise ScannError.failed_precondition(
                "hasher must be built with store_dataset=True")
        if force_kernel not in (None, "xla", "fused"):
            raise ScannError.invalid_argument(
                f"force_kernel must be 'xla' or 'fused', got "
                f"{force_kernel!r}")
        if fused_r is not None:
            self.FUSED_R = int(fused_r)
        self._inner = hasher
        self._measure = hasher.config.distance_measure
        self.mesh = mesh or make_mesh(axis_names=("db",))
        n_sh = self.mesh.shape["db"]
        n = hasher.dataset_size()
        # per-shard blocks tile-aligned so the fused sweep grids evenly
        blk = int(align_up(cdiv(n, n_sh), self.FUSED_TILE_N))
        n_pad = n_sh * blk
        self._blk = blk
        self._n = n
        devs = self.mesh.axis_devices("db")
        local = self.mesh.axis_local("db")

        # cosine: the inner hasher normalized its stored dataset at build
        data = hasher._dataset.numpy()
        codes_np = _to_host(hasher.codes).astype(np.uint8)
        codes = np.zeros((n_pad, codes_np.shape[1]), np.uint8)
        codes[:n] = codes_np
        # row-major codes serve only the plain path (masked queries, pre_k
        # too deep for the fused block minimum): they go to the devices on
        # the first such query, so fused serving never holds them
        self._codes_host = codes
        self._codes = None
        rdt = getattr(hasher.config, "rerank_dtype", "float32")
        db_dt, encode, dequant = rerank_codec(data, n, rdt)
        if db_dt == torch.bfloat16:
            rdb = torch.zeros(n_pad, data.shape[1], dtype=torch.bfloat16)
        else:
            rdb = np.zeros((n_pad, data.shape[1]),
                           np.uint8 if rdt == "int8" else np.float32)
        encode_rerank_rows(rdb, data, n, encode)
        self._db = [
            _shard_store(rdb[i * blk:(i + 1) * blk], dequant, devs[i])
            if local[i] else None for i in range(n_sh)]
        self._cent = replicate(self.mesh, hasher.codebook.centroids.float())
        self._kernels = {}
        if force_kernel is not None:
            self._fused_ok = force_kernel == "fused"
        else:
            self._fused_ok = hasher.codebook.num_codes <= 16
        self._codes_packed = None
        if self._fused_ok:
            from scann_tpu_torch.hashes.lut16 import pack_codes_4bit

            packed = pack_codes_4bit(codes)               # [N_pad, S_pad/2]
            self._codes_packed = [
                torch.from_numpy(np.ascontiguousarray(
                    packed[i * blk:(i + 1) * blk].T)).to(devs[i])
                if local[i] else None for i in range(n_sh)]

    def dataset_size(self) -> int:
        return self._n

    def dimensionality(self) -> int:
        return self._inner.dimensionality()

    def _docids(self):
        return self._inner._docids()

    def _use_fused(self, pre_k: int, with_mask: bool) -> bool:
        """The single-device hasher's block-count guard: one candidate per
        r-block must not starve pre_k on any shard."""
        return (self._fused_ok and not with_mask
                and self._blk // self.FUSED_R >= 2 * pre_k)

    def _codes_rows(self):
        """Row-major u8 codes a shard, moved to the devices on the first
        plain-path query and kept; the host copy is then released."""
        if self._codes is None:
            devs = self.mesh.axis_devices("db")
            local = self.mesh.axis_local("db")
            blk = self._blk
            self._codes = [
                torch.from_numpy(self._codes_host[i * blk:(i + 1) * blk])
                .to(devs[i]) if local[i] else None
                for i in range(len(devs))]
            self._codes_host = None
        return self._codes

    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None,
                               allow_mask: Optional[np.ndarray] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) on the mesh's home
        device, -1 / inf where missing. ``allow_mask`` ([N] bool, host)
        restricts the results (the plain score path)."""
        from scann_tpu_torch.hashes.hasher import _normalize

        q = queries.to(self.mesh.home()).float()
        if self._measure == DistanceMeasure.COSINE:
            q = _normalize(q)
        k = min(int(k), self._n)
        if k <= 0:
            raise ScannError.invalid_argument("k must be positive")
        pre_k = 3 * k
        if params is not None and \
                params.pre_reordering_num_neighbors is not None:
            pre_k = int(params.pre_reordering_num_neighbors)
        pre_eps, post_eps = epsilons(params)
        pre_k = min(max(pre_k, k), self._blk)
        with_mask = allow_mask is not None
        kernel = "fused" if self._use_fused(pre_k, with_mask) else "xla"
        key = (pre_k, k, kernel, with_mask)
        if key not in self._kernels:
            self._kernels[key] = sharded_ah_sweep_kernel(
                self.mesh, pre_k=pre_k, k=k, measure=self._measure,
                kernel=kernel, with_mask=with_mask, r=self.FUSED_R)
        codes = (self._codes_packed if kernel == "fused"
                 else self._codes_rows())
        masks = None
        if with_mask:
            m = np.zeros(self._blk * len(self._db), dtype=bool)
            a = np.asarray(allow_mask, dtype=bool).reshape(-1)[:self._n]
            m[:len(a)] = a
            blk = self._blk
            masks = [None if c is None else
                     torch.from_numpy(m[i * blk:(i + 1) * blk]).to(c.device)
                     for i, c in enumerate(codes)]
        dists, idx = self._kernels[key](self._cent, codes, self._db, self._n,
                                        q, masks, pre_eps, post_eps)
        return idx, dists

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask: Optional[np.ndarray] = None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        queries = self._validate_queries(queries)
        idx, dists = self.search_batched_tensors(
            torch.from_numpy(queries), k, params, allow_mask)
        return (idx.cpu().numpy().astype(np.int32),
                dists.cpu().numpy().astype(np.float32))


# ---------------------------------------------------------------------------
# sharded tree-x-AH (partition-ownership sharding)
# ---------------------------------------------------------------------------


def sharded_tree_ah_kernel(mesh: Mesh, *, p: int, pre_k: int, k: int,
                           l_cap: int, use_residuals: bool,
                           measure: DistanceMeasure, multiplicity: int = 1,
                           use_grouped: bool = True, q_cap: int = 8,
                           l_tile: int = 512, packed: bool = False,
                           spill_dedup: bool = True, db_axis: str = "db"):
    """``fn(centers, codebook, codes, offsets, sizes, perm, db, queries,
    allow_mask=None, pre_eps=inf, post_eps=inf) -> (dists, idx)``: the
    per-shard body of sharded tree-x-AH. ``centers``, ``codebook`` and
    ``allow_mask`` ([N] bool) are replicated (:func:`replicate`); the rest
    are per-shard lists: ``codes`` the shard's slab — [S_pad/2, L_sh]
    packed or [S_pad, L_sh] u8 for the grouped scorer (#1), [S_pad, L_sh]
    u8 for the per-pair scorer (``use_grouped=False``) — ``offsets`` /
    ``sizes`` [K] int32 (0 for partitions the shard does not own),
    ``perm`` [L_sh] local CSR row -> point id, ``db`` the re-rank store in
    the same local CSR order.

    Every shard selects the same partitions (replicated centroids), then
    runs the single-device searcher's stages over its own slab
    (``models/tree_x_hybrid``: :func:`leaf_scores`, :func:`preselect`,
    :func:`exact_rerank`) and keeps a local top-k; under spilling each id
    keeps its best slot on the shard before the gather (``spill_dedup``),
    and the merge drops copies that other shards hold."""
    n_sh = mesh.shape[db_axis]
    mult = max(int(multiplicity), 1)
    leaf = "grouped" if use_grouped else "per_pair"

    def fn(centers, codebook, codes, offsets, sizes, perm, db,
           queries: torch.Tensor, allow_mask=None, pre_eps: float = INF,
           post_eps: float = INF):
        first = next(c for c in codes if c is not None)
        s_pad = 2 * first.shape[0] if packed else first.shape[0]
        local_q = _per_device(lambda dev: queries.to(dev))
        tables_of = _per_device(lambda dev: query_tables(
            centers[dev], codebook[dev], local_q(dev), p=p, s_pad=s_pad,
            use_residuals=use_residuals, measure=measure, leaf=leaf))
        vals_l, idx_l, k_local = [], [], 1
        for i, codes_s in enumerate(codes):
            if codes_s is None:
                vals_l.append(None)
                idx_l.append(None)
                continue
            dev = codes_s.device
            parts, luts = tables_of(dev)
            flat = leaf_scores(
                luts, parts, codes_s, offsets[i], sizes[i], perm[i],
                leaf=leaf, p=p, l_cap=l_cap, q_cap=q_cap, l_tile=l_tile,
                packed=packed,
                allow_mask=None if allow_mask is None else allow_mask[dev])
            cand = preselect(flat, parts, offsets[i], perm[i], pre_eps,
                             pre_k=pre_k, p=p, measure=measure, order="row",
                             multiplicity=mult, spill_dedup=spill_dedup)
            # undeduped copies each keep an exact slot until the merge
            k_local = min(k if cand.deduped else k * mult,
                          cand.ids.shape[1])
            with span("tree_ah.rerank"):
                exact, ids = exact_rerank(db[i], local_q(dev), cand,
                                          measure=measure)
                vals, pos = top_k_smallest(exact, k_local)
                idx = torch.gather(ids, 1, pos)
            vals_l.append(vals)
            idx_l.append(torch.where(vals < MASKED_DISTANCE / 2, idx, -1))
        # n_sh * k_local candidates reach the merge; past that ceiling the
        # wrapper pads back to [B, k]
        k_merge = min(k, n_sh * k_local)
        return _merge_partials(mesh, vals_l, idx_l, k_merge, multiplicity,
                               post_eps, db_axis)

    return fn


def _shard_rows_of(fn, data_sh) -> List[Optional[object]]:
    """``fn(shard_index, shard)`` over the local row shards."""
    return [None if x is None else fn(i, x) for i, x in enumerate(data_sh)]


def _host_rows(parts: List[torch.Tensor], n: int) -> np.ndarray:
    """The per-shard outputs concatenated on the host, padding cut off."""
    return np.concatenate([_to_host(t) for t in parts])[:n]


def _chunked(x: torch.Tensor, n_centers: int, fn) -> list:
    """``fn`` over row chunks of ``x`` whose [chunk, K] distance block
    stays bounded."""
    from scann_tpu_torch.trees.kmeans import adaptive_row_chunk

    chunk = adaptive_row_chunk(65536, x.shape[0], n_centers)
    return [fn(x[lo:lo + chunk]) for lo in range(0, x.shape[0], chunk)]


def sharded_topr_kernel(mesh: Mesh, *, r: int, measure: DistanceMeasure):
    """``fn(data_shards, centers) -> [(dists [blk, r] ascending, choices
    [blk, r])]`` a shard: each shard's top-r nearest centres a row (the
    balance cap's candidate table)."""
    from scann_tpu_torch.partitioning.tree_partitioner import (
        select_partitions,
    )

    def fn(data_sh, centers: torch.Tensor):
        def one(i, x):
            cent = centers.to(x.device)
            outs = _chunked(x, cent.shape[0], lambda xc: select_partitions(
                cent, xc, measure=measure, p=r))
            return (torch.cat([o[0] for o in outs]),
                    torch.cat([o[1] for o in outs]))

        return _shard_rows_of(one, data_sh)

    return fn


def sharded_assign_kernel(mesh: Mesh):
    """``fn(data_shards, centers) -> [tokens [blk] int64]``: each shard
    assigns its own rows (``trees/kmeans.assign_clusters``)."""
    from scann_tpu_torch.trees.kmeans import assign_clusters

    def fn(data_sh, centers: torch.Tensor):
        return _shard_rows_of(lambda i, x: assign_clusters(
            x, centers.to(x.device))[0], data_sh)

    return fn


def sharded_residual_encode_kernel(mesh: Mesh):
    """``fn(data_shards, centers, token_shards, codebook) -> [codes [blk,
    S] u8]``: each shard PQ-encodes its rows' residuals against their
    token's centroid; the whole residual tensor never exists anywhere."""
    from scann_tpu_torch.hashes.codebook import encode_kernel

    def fn(data_sh, centers, tokens_sh, codebook):
        return _shard_rows_of(lambda i, x: encode_kernel(
            x - centers.to(x.device)[tokens_sh[i]],
            codebook.to(x.device)).to(torch.uint8), data_sh)

    return fn


def sharded_soar_select_kernel(mesh: Mesh, *, r: int, lam: float):
    """``fn(data_shards, centers, primary_shards) -> [secondary tokens
    [blk]]``: each shard runs the SOAR selection on its own rows
    (``partitioning/tree_partitioner.soar_select``)."""
    from scann_tpu_torch.partitioning.tree_partitioner import soar_select

    def fn(data_sh, centers: torch.Tensor, prim_sh):
        def one(i, x):
            cent = centers.to(x.device)
            prim = prim_sh[i]
            out, lo = [], 0
            for xc in _chunked(x, cent.shape[0], lambda xc: xc):
                out.append(soar_select(cent, xc, prim[lo:lo + len(xc)], lam,
                                       r=r))
                lo += len(xc)
            return torch.cat(out)

        return _shard_rows_of(one, data_sh)

    return fn


def sharded_avq_encode_kernel(mesh: Mesh, *, eta: float):
    """AVQ per-shard residual encode: as
    :func:`sharded_residual_encode_kernel`, through the anisotropic
    coordinate-descent assignment (``hashes/avq.avq_encode``) with the
    shard's RAW rows as the protected directions."""
    from scann_tpu_torch.hashes.avq import avq_encode, unit_directions

    def fn(data_sh, centers, tokens_sh, codebook):
        return _shard_rows_of(lambda i, x: avq_encode(
            x - centers.to(x.device)[tokens_sh[i]], unit_directions(x),
            codebook.to(x.device), float(eta)).to(torch.uint8), data_sh)

    return fn


def sharded_tree_ah_build(dataset, config, mesh: Optional[Mesh] = None,
                          force_kernel: Optional[str] = None,
                          verbose: bool = False):
    """Build tree-x-AH with the database only ever row-sharded over
    ``mesh``: no device holds all the rows, so an N-device mesh can build
    what it serves.

      1. k-means init on a host sample (``trees/kmeans.KMeans``, k-means++;
         a k-means tree's leaves when ``partition_num_levels`` > 1);
      2. Lloyd refinement over the full sharded data
         (:func:`~scann_tpu_torch.parallel.sharded.sharded_kmeans_step`),
         empty clusters reseeded from random rows;
      3. per-shard assignment, then the LBG balance rounds (the shared
         ``lbg_grow_centers`` splitting, sharded Lloyd refinement,
         re-assignment) and the shared hard demote over per-shard top-r
         tables; the straggler split stays single-device only;
      4. spilling (distance rule over the per-shard top-2) or SOAR
         secondaries, per shard, capped as the single-device build caps
         them;
      5. the PQ codebook on a host residual sample;
      6. per-shard residual encode (AVQ when the codebook is anisotropic),
         a spilled copy against ITS partition's centroid.

    Host draws are ``np.random.default_rng(seed)`` in the JAX package's
    order; the k-means init draws from the port's ``torch.Generator``, so
    builds agree with the JAX package in quality, not in centroid bits. The
    trained artifacts (partitioner, codebook, per-assignment codes) go into
    a single-device ``TreeXHybridSearcher`` on the mesh's home device,
    which the returned :class:`ShardedTreeXHybridSearcher` wraps. One
    process: the host steps read every shard."""
    from scann_tpu_torch.data.dataset import DenseDataset
    from scann_tpu_torch.hashes.codebook import Codebook, CodebookConfig
    from scann_tpu_torch.models.tree_x_hybrid import TreeXHybridSearcher
    from scann_tpu_torch.parallel.mesh import shard_rows
    from scann_tpu_torch.parallel.sharded import sharded_kmeans_step
    from scann_tpu_torch.partitioning.partitioner import DatabaseTokenization
    from scann_tpu_torch.partitioning.tree_partitioner import (
        TreePartitioner,
        TreePartitionerConfig,
        demote_to_cap,
        lbg_grow_centers,
    )
    from scann_tpu_torch.trees.kmeans import KMeans, KMeansConfig, KMeansInit

    cfg = config
    mesh = mesh or make_mesh(axis_names=("db",))
    if mesh.multiprocess:
        raise ScannError.unimplemented(
            "the sharded build runs in one process")
    if dataset.is_empty:
        raise ScannError.invalid_argument("Cannot build from empty dataset")
    if cfg.distance_measure == DistanceMeasure.COSINE:
        raw = dataset.numpy()
        norms = np.sqrt(np.einsum("nd,nd->n", raw, raw))
        dataset = DenseDataset(
            (raw / np.maximum(norms, 1e-30)[:, None]).astype(np.float32),
            docids=dataset.docids)
    data = dataset.numpy()
    n, d = data.shape
    home = mesh.home()
    kparts = min(cfg.num_partitions, n)
    seed = cfg.hash_config.seed if cfg.hash_config.seed is not None else 42
    rng = np.random.default_rng(seed)

    # 1. init centres from a host sample (sample-Lloyd is the init)
    sample_n = cfg.partition_training_sample_size or min(
        n, max(100 * kparts, 10_000))
    sample_idx = (rng.choice(n, sample_n, replace=False) if sample_n < n
                  else np.arange(n))
    sample = torch.from_numpy(np.ascontiguousarray(data[sample_idx])).to(home)
    if cfg.partition_num_levels > 1:
        from scann_tpu_torch.trees.kmeans_tree import (
            KMeansTree,
            KMeansTreeConfig,
        )

        fan = max(int(np.ceil(kparts ** (1.0 / cfg.partition_num_levels))),
                  2)
        tree = KMeansTree(KMeansTreeConfig(
            num_children=fan, max_depth=cfg.partition_num_levels,
            max_iterations=cfg.partition_max_iterations,
            seed=seed), device=home).build(sample)
        cent_dev = tree.leaf_centers().float()
        kparts = cent_dev.shape[0]
    else:
        cent_dev = KMeans(KMeansConfig(
            num_clusters=kparts,
            max_iterations=cfg.partition_max_iterations,
            convergence_threshold=cfg.partition_convergence_threshold,
            init_method=KMeansInit.KMEANS_PLUS_PLUS, seed=seed),
            device=home).fit(sample).centers.float()
    del sample

    # 2. Lloyd refinement over the full sharded data
    data_sh, n_real = shard_rows(mesh, data)
    step = sharded_kmeans_step(mesh, k=kparts)
    prev_inertia = np.inf
    for it in range(max(int(cfg.partition_max_iterations), 1)):
        cent_dev, counts, inertia = step(data_sh, cent_dev, n_real)
        empties = np.nonzero(_to_host(counts) == 0)[0]
        if len(empties):
            # reseed empty clusters from random rows
            cent_np = _to_host(cent_dev).copy()
            cent_np[empties] = data[rng.integers(0, n, len(empties))]
            cent_dev = torch.from_numpy(cent_np).to(home)
        inertia = float(inertia)
        if verbose:
            print(f"sharded-build lloyd it={it} inertia={inertia:.4g}")
        if np.isfinite(prev_inertia) and (prev_inertia - inertia) <= \
                abs(prev_inertia) * cfg.partition_convergence_threshold:
            break
        prev_inertia = inertia
    centers = _to_host(cent_dev)

    # 3. per-shard assignment, LBG balance rounds, hard demote
    assign = sharded_assign_kernel(mesh)
    tokens = _host_rows(assign(data_sh, cent_dev), n)
    if cfg.max_partition_size is not None:
        cap = cfg.max_partition_size
        if cap == "auto":
            cap = max(int(1.5 * n / max(min(kparts, n), 1)), 8)
        cap = int(cap)
        steps_by_k = {}
        for _ in range(4):  # TreePartitionerConfig.balance_rounds default
            grown = lbg_grow_centers(data, tokens, centers, cap, rng)
            if grown is None:
                break
            cent_dev = torch.from_numpy(grown.astype(np.float32)).to(home)
            k_pad = grown.shape[0]
            if k_pad not in steps_by_k:
                steps_by_k[k_pad] = sharded_kmeans_step(mesh, k=k_pad)
            for _ in range(3):
                cent_dev, _, _ = steps_by_k[k_pad](data_sh, cent_dev, n_real)
            centers = _to_host(cent_dev)
            tokens = _host_rows(assign(data_sh, cent_dev), n)
        kparts = centers.shape[0]
        sizes_now = np.bincount(tokens, minlength=kparts)
        if sizes_now.max() > cap:
            r = min(12, kparts)
            outs = sharded_topr_kernel(
                mesh, r=r, measure=cfg.distance_measure)(data_sh, cent_dev)
            tokens = demote_to_cap(_host_rows([o[0] for o in outs], n),
                                   _host_rows([o[1] for o in outs], n),
                                   cap, rounds=12)

    def to_shards(host_vec: np.ndarray) -> list:
        """A host [N] vector padded and split like the data rows."""
        full = np.zeros(len(data_sh) * data_sh.blk, np.int64)
        full[:n] = host_vec
        return [None if x is None else torch.from_numpy(
            full[i * data_sh.blk:(i + 1) * data_sh.blk]).to(x.device)
            for i, x in enumerate(data_sh)]

    # 4. secondary assignments (spilling / SOAR), per shard
    cent_dev = torch.from_numpy(np.ascontiguousarray(centers,
                                                     np.float32)).to(home)
    sec_full = None
    extra = None
    if cfg.spilling:
        if cfg.spilling_mode == "soar":
            soar = sharded_soar_select_kernel(
                mesh, r=min(8, kparts), lam=float(cfg.soar_lambda))
            sec_full = _host_rows(soar(data_sh, cent_dev, to_shards(tokens)),
                                  n)
            extra = np.stack(
                [np.arange(n, dtype=np.int64), sec_full.astype(np.int64)],
                axis=1)
        else:
            # distance rule: 2nd-nearest within the ratio threshold
            outs = sharded_topr_kernel(
                mesh, r=2, measure=cfg.distance_measure)(data_sh, cent_dev)
            d2 = _host_rows([o[0] for o in outs], n)
            t2 = _host_rows([o[1] for o in outs], n)
            ok = d2[:, 1] <= d2[:, 0] * (1.0 + cfg.spilling_threshold)
            sec_full = np.where(ok, t2[:, 1], -1).astype(np.int64)
            pts = np.nonzero(ok)[0]
            extra = np.stack([pts, t2[ok, 1].astype(np.int64)], axis=1)

    # the partitioner config mirrors the single-device build's, so the
    # shared helpers (the secondaries' cap) compute the same bounds
    tp = TreePartitioner(TreePartitionerConfig(
        num_partitions=cfg.num_partitions, seed=seed,
        distance_measure=cfg.distance_measure,
        spilling=cfg.spilling, spilling_threshold=cfg.spilling_threshold,
        spilling_mode=cfg.spilling_mode, soar_lambda=cfg.soar_lambda,
        max_partition_size=cfg.max_partition_size), device=home)
    tp.centers = cent_dev
    if extra is not None and cfg.max_partition_size is not None:
        extra = tp._cap_secondaries(extra, tokens, n)
    tp.tokenization = DatabaseTokenization(
        torch.from_numpy(tokens.astype(np.int64)).to(home), kparts,
        extra_pairs=(None if extra is None
                     else torch.from_numpy(extra.astype(np.int64)).to(home)))

    # 5. PQ codebook on a host residual sample
    hc = cfg.hash_config
    hs = min(hc.training_sample_size, n)
    h_idx = (rng.choice(n, hs, replace=False) if hs < n else np.arange(n))
    resid_sample = (data[h_idx] - centers[tokens[h_idx]]
                    if cfg.use_residuals else data[h_idx])
    codebook = Codebook(CodebookConfig(
        num_codes=hc.num_codes, num_subspaces=hc.num_subspaces,
        max_iterations=hc.max_iterations, seed=hc.seed,
        anisotropic_threshold=hc.anisotropic_threshold,
    ), device=home).train(
        torch.from_numpy(np.ascontiguousarray(resid_sample, np.float32)),
        directions=(torch.from_numpy(np.ascontiguousarray(data[h_idx]))
                    if hc.anisotropic_threshold is not None else None))

    # 6. per-shard encode: AVQ's coordinate descent for an anisotropic
    # codebook (plain L2 argmin would not match its trained loss)
    if codebook.eta is not None:
        enc_fn = sharded_avq_encode_kernel(mesh, eta=float(codebook.eta))
    else:
        enc_fn = sharded_residual_encode_kernel(mesh)
    cb_dev = codebook.centroids_device()
    zero_cent = torch.zeros_like(cent_dev)

    def encode_vs(tokens_np: np.ndarray) -> np.ndarray:
        """[N, S] u8 codes of every row's residual against tokens_np's
        centroid (the raw rows when use_residuals is off)."""
        toks = to_shards(tokens_np if cfg.use_residuals
                         else np.zeros_like(tokens_np))
        e_cent = cent_dev if cfg.use_residuals else zero_cent
        return _host_rows(enc_fn(data_sh, e_cent, toks, cb_dev),
                          n).astype(np.uint8)

    primary_codes = encode_vs(tokens)

    inner = TreeXHybridSearcher(cfg, device=home)
    inner._dataset = dataset
    inner.partitioner = tp
    inner.codebook = codebook
    # per-assignment CSR rows: a spilled point's secondary row encodes the
    # residual against ITS partition's centroid
    tk = tp.tokenization
    pts = _to_host(tk.point_indices)
    if cfg.spilling and sec_full is not None and cfg.use_residuals:
        secondary_codes = encode_vs(np.maximum(sec_full, 0))
        row_tokens = np.repeat(np.arange(kparts),
                               _to_host(tk.partition_sizes))
        is_primary = row_tokens == tokens[pts]
        codes = np.where(is_primary[:, None], primary_codes[pts],
                         secondary_codes[pts])
    else:
        codes = primary_codes[pts]
    inner.codes = torch.from_numpy(np.ascontiguousarray(codes)).to(home)
    inner._reset_caches()
    del data_sh
    return ShardedTreeXHybridSearcher(inner, mesh, force_kernel=force_kernel)


def _bin_pack_partitions(sizes: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy largest-first bin packing; returns shard id per partition
    (a stable sort, so equal sizes keep their partition order)."""
    order = np.argsort(-np.asarray(sizes).astype(np.int64), kind="stable")
    load = np.zeros(n_shards, dtype=np.int64)
    owner = np.zeros(len(sizes), dtype=np.int32)
    for t in order:
        s = int(np.argmin(load))
        owner[t] = s
        load[s] += int(sizes[t]) + 8  # +alignment slop
    return owner


def _compute_tree_shard_layout(searcher, n_sh: int) -> dict:
    """Per-shard host CSR layout of :class:`ShardedTreeXHybridSearcher`,
    the JAX package's array for array: partitions bin-packed by size, each
    shard's codes and re-rank rows in one local CSR order with every
    partition start aligned to 128 rows and l_cap rows of slack. The code
    slab is UNPACKED row-major [Sh, L_sh, S] (packing and transposition
    happen at upload), so a saved layout serves every scorer.

    The re-rank rows take the searcher's ``rerank_dtype``; int8 is the
    residual-anchored per-dimension codec of the JAX sharded layout: each
    CSR row quantizes its residual against ITS OWN partition's centroid,
    over the exact min / max of those residuals (no sigma clip), and a
    per-row token table ``tok`` carries the anchor. The single-device int8
    store anchors every row on its point's PRIMARY token with clipped
    statistics; the two differ for spilled copies (ROADMAP.md)."""
    tk = searcher.partitioner.tokenization
    data = searcher._dataset.numpy()
    kparts = tk.num_partitions
    sizes = _to_host(tk.partition_sizes).astype(np.int64)
    csr_off = _to_host(tk.offsets).astype(np.int64)
    point_idx = _to_host(tk.point_indices).astype(np.int64)
    all_codes = _to_host(searcher.codes).astype(np.uint8)
    owner = _bin_pack_partitions(sizes, n_sh)

    l_tile = max(int(searcher.config.score_l_tile), 128)
    l_cap = int(align_up(max(tk.max_partition_size, 8), l_tile))
    s = all_codes.shape[1]
    d = data.shape[1]

    per_shard = []
    for sh in range(n_sh):
        mine = np.nonzero(owner == sh)[0]
        off_local = np.zeros(kparts, np.int32)
        aligned = 0
        for t in mine:
            off_local[t] = aligned
            aligned += int(align_up(max(int(sizes[t]), 1), 128))
        per_shard.append((mine, off_local, aligned))
    l_sh = int(align_up(max(a for _, _, a in per_shard) + l_cap, 8))

    rdt = getattr(searcher.config, "rerank_dtype", "float32")
    residual = rdt == "int8"
    tok_sh = None
    if residual:
        centers = _to_host(searcher.partitioner.centers).astype(np.float32)
        row_tokens = np.repeat(np.arange(kparts, dtype=np.int32), sizes)
        # chunked residual min / max over every assignment
        r_mn = np.full(d, np.inf, np.float32)
        r_mx = np.full(d, -np.inf, np.float32)
        cs = max(1, (1 << 22) // max(d, 1))
        for lo in range(0, len(point_idx), cs):
            r = (data[point_idx[lo:lo + cs]]
                 - centers[row_tokens[lo:lo + cs]])
            r_mn = np.minimum(r_mn, r.min(axis=0))
            r_mx = np.maximum(r_mx, r.max(axis=0))
        r_scale = np.maximum((r_mx - r_mn) / 255.0, 1e-30).astype(np.float32)
        r_mn = r_mn.astype(np.float32)

        def enc_r(rows, t):
            r = rows - centers[t]
            return np.clip(np.rint((r - r_mn) / r_scale), 0,
                           255).astype(np.uint8)

        db_sh = np.zeros((n_sh, l_sh, d), np.uint8)
        tok_sh = np.zeros((n_sh, l_sh), np.int32)
    else:
        db_dt, encode, _ = rerank_codec(data, len(data), rdt)
        if db_dt == torch.bfloat16:
            db_sh = torch.zeros(n_sh, l_sh, d, dtype=torch.bfloat16)
        else:
            db_sh = np.zeros((n_sh, l_sh, d), np.float32)

    codes_sh = np.zeros((n_sh, l_sh, s), np.uint8)
    perm_sh = np.zeros((n_sh, l_sh), np.int32)
    sizes_sh = np.zeros((n_sh, kparts), np.int32)
    offs_sh = np.zeros((n_sh, kparts), np.int32)
    for sh, (blocks, off_local, _) in enumerate(per_shard):
        offs_sh[sh] = off_local
        for t in blocks:
            lo, sz = int(off_local[t]), int(sizes[t])
            sizes_sh[sh, t] = sz
            c0 = int(csr_off[t])
            codes_sh[sh, lo:lo + sz] = all_codes[c0:c0 + sz]
            ids = point_idx[c0:c0 + sz]
            perm_sh[sh, lo:lo + sz] = ids
            if residual:
                db_sh[sh, lo:lo + sz] = enc_r(data[ids], t)
                tok_sh[sh, lo:lo + sz] = t
            else:
                db_sh[sh, lo:lo + sz] = encode(data[ids])
    out = {"codes": codes_sh, "perm": perm_sh, "db": db_sh,
           "sizes": sizes_sh, "offs": offs_sh, "l_cap": l_cap, "n_sh": n_sh}
    if residual:
        out["tok"] = tok_sh
        out["dequant"] = (r_scale.tolist(), r_mn.tolist())
    return out


class ShardedTreeXHybridSearcher(Searcher):
    """Tree-x-AH served with partitions bin-packed across a mesh."""

    def __init__(self, searcher, mesh: Optional[Mesh] = None,
                 force_kernel: Optional[str] = None,
                 layout: Optional[dict] = None):
        """Wrap a built single-device ``TreeXHybridSearcher``.

        ``force_kernel``: "grouped" (the default, the single-device
        searcher's path: the grouped leaf scorer, #1) or "xla" (the
        per-pair float32 scorer, the JAX package's CPU path).
        ``layout``: a precomputed per-shard host layout (``load_layout``'s
        warm start), which skips the re-shard and the re-rank encode."""
        if searcher.codebook is None:
            raise ScannError.failed_precondition("searcher not built")
        if force_kernel not in (None, "grouped", "xla"):
            raise ScannError.invalid_argument(
                f"force_kernel must be 'grouped' or 'xla', got "
                f"{force_kernel!r}")
        self._inner = searcher
        self.mesh = mesh or make_mesh(axis_names=("db",))
        n_sh = self.mesh.shape["db"]
        self._use_grouped = force_kernel != "xla"
        # the packed int4 slab of the single-device searcher's grouped path
        self._packed = self._use_grouped and searcher._pack_codes()

        if layout is None:
            layout = _compute_tree_shard_layout(searcher, n_sh)
        else:
            _check_layout_shards(layout, n_sh)
        self._dequant = _dequant_arrays(layout.get("dequant"))
        self._l_cap = int(layout["l_cap"])
        codes_sh = np.asarray(layout["codes"], np.uint8)
        devs = self.mesh.axis_devices("db")
        local = self.mesh.axis_local("db")
        cent = searcher.partitioner.centers.float()
        self._codes, self._perm, self._db = [], [], []
        self._sizes, self._offs = [], []
        tok = layout.get("tok")
        for i in range(n_sh):
            if not local[i]:
                for lst in (self._codes, self._perm, self._db, self._sizes,
                            self._offs):
                    lst.append(None)
                continue
            dev = devs[i]
            # the single-device searcher's slab, packed for #1
            self._codes.append(serving_slab(
                torch.from_numpy(codes_sh[i]), self._packed).to(dev))
            self._perm.append(torch.from_numpy(
                np.asarray(layout["perm"][i], np.int64)).to(dev))
            self._sizes.append(torch.from_numpy(
                np.asarray(layout["sizes"][i], np.int32)).to(dev))
            self._offs.append(torch.from_numpy(
                np.asarray(layout["offs"][i], np.int32)).to(dev))
            self._db.append(_shard_store(
                layout["db"][i], self._dequant, dev,
                tok=None if tok is None else tok[i], centers=cent))
        self._cent = replicate(self.mesh, cent)
        self._cb = replicate(self.mesh, searcher.codebook.centroids.float())
        self._kernels = {}

    def save_layout(self, path: str) -> None:
        """Save the per-shard serving layout and the inner searcher's
        trained artifacts to one .npz (the JAX package's format); a serving
        restart then skips the re-shard and the re-rank encode
        (:meth:`load_layout`)."""
        from scann_tpu_torch.io import save_sharded_layout

        save_sharded_layout(path, self)

    @classmethod
    def load_layout(cls, path: str, mesh: Optional[Mesh] = None,
                    force_kernel: Optional[str] = None, device=None):
        """Restore a wrapper saved with :meth:`save_layout` (by either
        package): the per-shard slabs go from disk to the shards'
        devices."""
        from scann_tpu_torch.io import load_sharded_layout

        return load_sharded_layout(path, cls, mesh=mesh,
                                   force_kernel=force_kernel, device=device)

    @classmethod
    def build(cls, dataset, config, mesh: Optional[Mesh] = None,
              force_kernel: Optional[str] = None, verbose: bool = False):
        """Build with the database only ever row-sharded over ``mesh`` (see
        :func:`sharded_tree_ah_build`)."""
        return sharded_tree_ah_build(dataset, config, mesh,
                                     force_kernel=force_kernel,
                                     verbose=verbose)

    def dataset_size(self) -> int:
        return self._inner.dataset_size()

    def dimensionality(self) -> int:
        return self._inner.dimensionality()

    def _docids(self):
        return self._inner._docids()

    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None,
                               allow_mask: Optional[np.ndarray] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) on the mesh's home
        device, -1 / inf where missing; ``allow_mask`` ([N] bool, host)
        restricts the results."""
        cfg = self._inner.config
        req = self._inner.plan_request(queries, k, params, allow_mask,
                                       device=self.mesh.home(),
                                       l_cap=self._l_cap)
        # no pre_k inflation: the body over-selects by the multiplicity and
        # dedups before the gather (unless spill_dedup is off)
        key = (req.p, req.pre_k, req.k, req.q_cap, cfg.spill_dedup)
        if key not in self._kernels:
            self._kernels[key] = sharded_tree_ah_kernel(
                self.mesh, p=req.p, pre_k=req.pre_k, k=req.k,
                l_cap=self._l_cap, use_residuals=cfg.use_residuals,
                measure=cfg.distance_measure, multiplicity=req.multiplicity,
                use_grouped=self._use_grouped, q_cap=req.q_cap,
                l_tile=cfg.score_l_tile, packed=self._packed,
                spill_dedup=cfg.spill_dedup)
        allow = None if req.allow is None else replicate(self.mesh, req.allow)
        dists, idx = self._kernels[key](
            self._cent, self._cb, self._codes, self._offs, self._sizes,
            self._perm, self._db, req.queries, allow, req.pre_eps,
            req.post_eps)
        # per-shard candidate ceilings can merge fewer than k columns
        return pad_results_to_k(idx, dists, req.k)

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask: Optional[np.ndarray] = None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        queries = self._validate_queries(queries)
        idx, dists = self.search_batched_tensors(
            torch.from_numpy(queries), k, params, allow_mask)
        return (idx.cpu().numpy().astype(np.int32),
                dists.cpu().numpy().astype(np.float32))


# ---------------------------------------------------------------------------
# sharded block-min sweep (BlockSweepSearcher scale-out)
# ---------------------------------------------------------------------------


def sharded_block_sweep_kernel(mesh: Mesh, *, pre_k: int, k: int,
                               measure: DistanceMeasure, r: int,
                               top2: bool = False, db_axis: str = "db"):
    """``fn(aug, rdb, queries, aug_scales=None, aug_sn=0.0,
    allow_pen=None, pre_eps=inf, post_eps=inf) -> (dists, idx)``: the
    per-shard body of the sharded block sweep, ``idx`` in the PERMUTED
    (stored) global row order, which the wrapper maps through the inverse
    permutation. Per-shard lists: ``aug`` [blk, D1] bf16 or int8 sweep rows,
    ``rdb`` the re-rank stores in the same stored order, ``allow_pen`` the
    allowlist penalty [blk/r, r]; ``aug_scales`` replicated (int8 rows).

    Per shard: block-min sweep over the local block (the kernel form
    ``ops/sweep.block_minima`` picks, as for one device) -> local
    approximate top-pre_k -> local exact re-rank -> local top-k."""
    from scann_tpu_torch.ops.sweep import (
        augment_for_sweep,
        rerank_candidates,
        sweep_block_candidates,
    )

    def fn(aug, rdb, queries: torch.Tensor, aug_scales=None,
           aug_sn: float = 0.0, allow_pen=None, pre_eps: float = INF,
           post_eps: float = INF):
        local_q = _per_device(lambda dev: queries.to(dev))
        first = next(a for a in aug if a is not None)
        q_aug_of = _per_device(lambda dev: augment_for_sweep(
            local_q(dev), first, measure,
            None if aug_scales is None else aug_scales[dev], aug_sn))
        vals_l, idx_l, width = [], [], 0
        for i, aug_s in enumerate(aug):
            if aug_s is None:
                vals_l.append(None)
                idx_l.append(None)
                continue
            dev = aug_s.device
            q = local_q(dev)
            q_aug, mask_cut = q_aug_of(dev)
            blk = aug_s.shape[0]
            pk = min(pre_k, blk // r)
            pv, cand = sweep_block_candidates(
                q_aug, aug_s, pre_k=pk, r=r,
                penalty=None if allow_pen is None else allow_pen[i],
                top2=top2)
            exact = rerank_candidates(rdb[i], q, pv, cand, measure, pre_eps,
                                      mask_cut)
            width = min(k, pk * (2 if top2 else 1))
            vals, pos = top_k_smallest(exact, width)
            idx = torch.gather(cand, 1, pos) + i * blk
            vals_l.append(vals)
            idx_l.append(torch.where(vals < MASKED_DISTANCE / 2, idx, -1))
        k_merge = min(k, mesh.shape[db_axis] * width)
        return _merge_partials(mesh, vals_l, idx_l, k_merge, 1, post_eps,
                               db_axis)

    return fn


def _compute_sweep_shard_layout(sweep, n_sh: int) -> dict:
    """Per-shard host layout of :class:`ShardedBlockSweepSearcher`, the
    JAX package's array for array: the augmented sweep copy (bf16 or int8)
    and the re-rank rows in the same stride-shuffled order, padded to
    ``n_sh`` blocks of ``blk`` rows (a tile_n multiple that covers the
    q-major step, so each shard runs the kernel one device would)."""
    from scann_tpu_torch.ops.sweep import (
        build_augmented_db,
        build_int8_augmented_db,
        qmajor_step_rows,
        shuffle_stride_for,
    )

    cfg = sweep.config
    data = sweep.dataset.numpy()
    n = sweep.dataset_size()
    unit = cfg.tile_n * cdiv(qmajor_step_rows(cfg.block_r), cfg.tile_n)
    blk = int(align_up(cdiv(n, n_sh), unit))
    n_pad = n_sh * blk

    if cfg.shuffle and n > 1:
        stride = shuffle_stride_for(n)
        pos = (np.arange(n, dtype=np.int64) * stride) % n
        inv = np.empty(n, np.int32)
        inv[pos] = np.arange(n, dtype=np.int32)
    else:
        stride, inv = 0, None

    out = {"blk": blk, "n_sh": n_sh, "inv": inv, "aug_sn": 0.0,
           "dequant": None}
    if cfg.sweep_dtype == "int8":
        aug, scales, sn = build_int8_augmented_db(
            data, n, cfg.distance_measure, tile_n=blk, shuffle_stride=stride,
            pad_rows_to=n_pad)
        out["aug"] = aug.numpy()
        out["aug_scales"] = scales.numpy()
        out["aug_sn"] = float(sn)
    else:
        out["aug"] = build_augmented_db(
            data, n, cfg.distance_measure, tile_n=blk, shuffle_stride=stride,
            pad_rows_to=n_pad)

    # re-rank rows in the SAME stored order as the sweep copy, so each
    # shard re-ranks its own candidates
    data_perm = data if inv is None else data[inv]
    db_dt, encode, dequant = rerank_codec(data_perm, n, cfg.rerank_dtype)
    if dequant is not None:
        out["dequant"] = (np.asarray(dequant[0]).tolist(),
                          np.asarray(dequant[1]).tolist())
    if db_dt == torch.bfloat16:
        rdb = torch.zeros(n_pad, data.shape[1], dtype=torch.bfloat16)
    else:
        rdb = np.zeros((n_pad, data.shape[1]),
                       np.uint8 if db_dt == torch.uint8 else np.float32)
    encode_rerank_rows(rdb, data_perm, n, encode)
    out["rdb"] = rdb
    return out


class ShardedBlockSweepSearcher(Searcher):
    """Block-min sweep with the augmented copy and the re-rank rows
    row-sharded over a mesh: N shards hold N times the rows. Wraps a
    single-device ``BlockSweepSearcher``'s config and dataset."""

    def __init__(self, sweep, mesh: Optional[Mesh] = None,
                 layout: Optional[dict] = None):
        from scann_tpu_torch.models.block_sweep import BlockSweepSearcher

        if not isinstance(sweep, BlockSweepSearcher):
            raise ScannError.invalid_argument(
                "ShardedBlockSweepSearcher wraps a BlockSweepSearcher")
        cfg = sweep.config
        self._cfg = cfg
        self._measure = cfg.distance_measure
        self._inner = sweep
        self.mesh = mesh or make_mesh(axis_names=("db",))
        n_sh = self.mesh.shape["db"]
        self._n = sweep.dataset_size()
        if layout is None:
            layout = _compute_sweep_shard_layout(sweep, n_sh)
        else:
            _check_layout_shards(layout, n_sh)
        self._blk = blk = int(layout["blk"])
        inv = layout.get("inv")
        self._inv_host = None if inv is None else np.asarray(inv, np.int64)
        self._aug_sn = float(layout.get("aug_sn", 0.0))
        self._dequant = _dequant_arrays(layout.get("dequant"))
        devs = self.mesh.axis_devices("db")
        local = self.mesh.axis_local("db")
        aug = layout["aug"]
        if not isinstance(aug, torch.Tensor):
            aug = torch.from_numpy(np.ascontiguousarray(aug))
        rdb = layout["rdb"]
        self._aug = [aug[i * blk:(i + 1) * blk].contiguous().to(devs[i])
                     if local[i] else None for i in range(n_sh)]
        self._rdb = [_shard_store(rdb[i * blk:(i + 1) * blk], self._dequant,
                                  devs[i]) if local[i] else None
                     for i in range(n_sh)]
        self._aug_scales = None
        if cfg.sweep_dtype == "int8":
            self._aug_scales = replicate(
                self.mesh, np.asarray(layout["aug_scales"], np.float32))
        self._inv = (None if self._inv_host is None else
                     torch.from_numpy(self._inv_host).to(self.mesh.home()))
        self._kernels = {}

    def save_layout(self, path: str) -> None:
        """Save the per-shard layout (sweep copy, stored-order re-rank
        rows) and the inner searcher to one .npz, so a restart skips the
        host rebuild."""
        from scann_tpu_torch.io import save_sharded_layout

        save_sharded_layout(path, self)

    @classmethod
    def load_layout(cls, path: str, mesh: Optional[Mesh] = None,
                    device=None):
        from scann_tpu_torch.io import load_sharded_layout

        return load_sharded_layout(path, cls, mesh=mesh, device=device)

    def dataset_size(self) -> int:
        return self._n

    def dimensionality(self) -> int:
        return self._inner.dimensionality()

    def _docids(self):
        return self._inner._docids()

    def _allow_penalty(self, allow_mask) -> list:
        """The allowlist as each shard's fused [blk/r, r] penalty stream,
        in the stored row order (so a shard's slice is its own)."""
        from scann_tpu_torch.ops.sweep import (
            INT8_NORM_DIGIT_MAX,
            build_allow_penalty,
        )

        cfg = self._cfg
        kw = {}
        if cfg.sweep_dtype == "int8":
            kw["mask_value"] = 4.0 * INT8_NORM_DIGIT_MAX * self._aug_sn
        n_pad = self._blk * len(self._aug)
        pen = build_allow_penalty(allow_mask, n_pad, cfg.block_r,
                                  inv_perm=self._inv_host, **kw)
        per = self._blk // cfg.block_r
        return [None if a is None else
                pen[i * per:(i + 1) * per].contiguous().to(a.device)
                for i, a in enumerate(self._aug)]

    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None,
                               allow_mask=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) on the mesh's home
        device, -1 / inf where missing; ``allow_mask`` ([N] bool, host)
        restricts the results."""
        k = min(int(k), self._n)
        if k <= 0:
            raise ScannError.invalid_argument("k must be positive")
        cfg = self._cfg
        pre_k = max(cfg.pre_reorder_k, k)
        if params is not None and \
                params.pre_reordering_num_neighbors is not None:
            pre_k = max(int(params.pre_reordering_num_neighbors), k)
        pre_k = min(pre_k, self._blk // cfg.block_r)
        pre_eps, post_eps = epsilons(params)
        key = (pre_k, k)
        if key not in self._kernels:
            self._kernels[key] = sharded_block_sweep_kernel(
                self.mesh, pre_k=pre_k, k=k, measure=self._measure,
                r=cfg.block_r, top2=cfg.top2)
        pen = None if allow_mask is None else self._allow_penalty(allow_mask)
        q = queries.to(self.mesh.home()).float()
        # queries a sweep program, as the single-device searcher (half of
        # it for the top-2 tournament)
        max_batch = cfg.max_batch // 2 if cfg.top2 else cfg.max_batch
        out_d, out_i = [], []
        for lo in range(0, q.shape[0], max_batch):
            dists, idx = self._kernels[key](
                self._aug, self._rdb, q[lo:lo + max_batch], self._aug_scales,
                self._aug_sn, pen, pre_eps, post_eps)
            out_d.append(dists)
            out_i.append(idx)
        dists, idx = torch.cat(out_d), torch.cat(out_i)
        if self._inv is not None:
            idx = torch.where(
                idx >= 0, self._inv[idx.clamp(0, self._n - 1)], -1)
        return pad_results_to_k(idx, dists, k)

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None,
                              allow_mask=None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        queries = self._validate_queries(queries)
        idx, dists = self.search_batched_tensors(
            torch.from_numpy(queries), k, params, allow_mask)
        return (idx.cpu().numpy().astype(np.int32),
                dists.cpu().numpy().astype(np.float32))
