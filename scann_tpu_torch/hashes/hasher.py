"""Asymmetric hasher: PQ-encoded database + per-query LUT scoring
(counterpart of ``scann_tpu/hashes/hasher.py``).

A search builds per-query [B, S, C] lookup tables, scores every database
code against them, keeps the best candidates and, when asked, re-ranks
those exactly in float32. Three pipelines, dispatched as in the JAX package
(``C <= 16`` takes the LUT16 kernels; the JAX package's TPU-only condition
becomes "always", because on CPU tensors the kernel wrappers take their
plain twins):

  - :func:`ah_search` — approximate only: scores [B, N] (float32, the
    :func:`~scann_tpu_torch.ops.scoring_kernels.lut16_score` kernel for
    C <= 16, :func:`~scann_tpu_torch.ops.lut16_scoring.lut_score` above) ->
    top-k;
  - :func:`ah_search_reorder` — scores (bf16 from the kernel) -> top-pre_k
    -> exact re-rank -> top-k;
  - :func:`ah_search_fused` — the main path: u8-quantized tables ->
    the fused int8 sweep over packed nibbles with the r:1 block minimum in
    the kernel -> top-pre_k over the block minima -> decode -> exact
    re-rank -> top-k. Taken when the padded corpus has at least 2*pre_k
    blocks of ``FUSED_R`` rows, so one candidate per block cannot starve
    pre_k.

SQUARED_L2, COSINE (rows normalized at build, queries at search; the L2
tables then rank as cosine) and DOT_PRODUCT / GENERAL_INNER_PRODUCT (-dot
tables). The re-rank store is the float32 dataset, or for ``rerank_dtype``
bfloat16 / int8 a low-precision store (``utils/reordering``). With
``anisotropic_threshold`` set the codebook trains and encodes by the
score-aware anisotropic loss (``hashes/avq.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes.codebook import (
    Codebook,
    CodebookConfig,
    lut_kernel,
)
from scann_tpu_torch.hashes.lut import (
    luts_i8_evenfirst,
    quantize_luts_u8_device,
)
from scann_tpu_torch.hashes.lut16 import pack_codes_4bit_device
from scann_tpu_torch.models.searcher import (
    SearchParameters,
    Searcher,
    epsilons,
)
from scann_tpu_torch.ops.distances import (
    DistanceMeasure,
    approx_to_measure_units,
    gathered_distances,
)
from scann_tpu_torch.ops.lut16_scoring import lut_score
from scann_tpu_torch.ops.scoring_kernels import (
    INVALID_COMBINED,
    lut16_fused_sweep,
    lut16_score,
)
from scann_tpu_torch.ops.sweep import finalize_results
from scann_tpu_torch.ops.topk import approx_top_k_smallest, top_k_smallest
from scann_tpu_torch.types import (
    DEFAULT_DEVICE,
    MASKED_DISTANCE,
    align_up,
    require_device,
)
from scann_tpu_torch.utils.reordering import (
    build_rerank_store,
    gather_rerank_rows,
    rerank_store_rows,
)


@dataclasses.dataclass
class AsymmetricHasherConfig:
    """The JAX package's ``AsymmetricHasherConfig``, field for field."""

    num_codes: int = 256
    num_subspaces: int = 8
    seed: Optional[int] = None
    max_iterations: int = 25
    training_sample_size: int = 100_000
    # keep the float32 rows for the exact re-rank
    store_dataset: bool = True
    # COSINE normalizes rows at build and queries at search; DOT_PRODUCT and
    # GENERAL_INNER_PRODUCT use -dot tables
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    # score-aware anisotropic (AVQ) codebook training, e.g. 0.2 for MIPS /
    # cosine; None = plain reconstruction-loss PQ
    anisotropic_threshold: Optional[float] = None
    # dtype of the re-rank store: "float32", "bfloat16" or "int8" (the
    # per-dimension affine codec)
    rerank_dtype: str = "float32"


_AH_MIPS = (DistanceMeasure.DOT_PRODUCT, DistanceMeasure.GENERAL_INNER_PRODUCT)
_AH_MEASURES = (DistanceMeasure.SQUARED_L2, DistanceMeasure.COSINE) + _AH_MIPS


def _ah_luts(queries: torch.Tensor, centroids: torch.Tensor,
             measure: DistanceMeasure) -> torch.Tensor:
    """[B, S, C] tables in the searcher's measure: squared-L2 tables (also
    for cosine, on normalized vectors) or -dot tables for MIPS."""
    if measure in _AH_MIPS:
        b = queries.shape[0]
        s, c, dsub = centroids.shape
        qs = queries.float().reshape(b, s, dsub)
        return -torch.einsum("bsd,scd->bsc", qs, centroids)
    return lut_kernel(queries, centroids)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm (zero rows stay zero)."""
    norms = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / norms.clamp_min(1e-30)


def rerank_exact(db, queries: torch.Tensor,
                 cand: torch.Tensor, pre_valid: torch.Tensor,
                 measure: DistanceMeasure) -> torch.Tensor:
    """[B, C] exact float32 distances of the candidates from the re-rank
    store ``db`` (float32 rows or a low-precision store), MASKED_DISTANCE
    where not ``pre_valid``."""
    safe = cand.clamp(0, rerank_store_rows(db) - 1)
    rows = gather_rerank_rows(db, safe)                       # [B, C, D]
    norms = torch.sum(rows * rows, dim=-1)
    exact = gathered_distances(measure, queries, rows, norms)
    return torch.where(pre_valid, exact, float(MASKED_DISTANCE))


def quantized_tables(luts: torch.Tensor):
    """[B, S, C] float32 tables -> (even-first int8 tables [B, S_pad*C],
    multiplier [B], bias [B]) for the fused sweep."""
    q_u8, mult, bias = quantize_luts_u8_device(luts)
    return luts_i8_evenfirst(q_u8), mult, bias


def fused_candidates(comb: torch.Tensor, mult: torch.Tensor,
                     bias: torch.Tensor, s_real: int, *, pre_k: int, r: int,
                     measure: DistanceMeasure,
                     pre_eps: float = float("inf")
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-pre_k over the [N/r, B] combined block minima, decoded: (cand
    [B, pre_k] int64 point ids ``block*r + sum % r``, pre_valid [B, pre_k]:
    a real block whose dequantized sum passes ``pre_eps``)."""
    vals, blk = approx_top_k_smallest(comb.T, pre_k)              # [B, pre_k]
    iv = vals.to(torch.int32)
    sumq = iv // r
    approx = sumq.float() * mult[:, None] + bias[:, None] * s_real
    approx = approx_to_measure_units(approx, measure)
    cand = blk * r + (iv % r).long()
    return cand, (vals < INVALID_COMBINED / 2) & (approx <= pre_eps)


def ah_search(centroids: torch.Tensor, codes: torch.Tensor, n_valid: int,
              queries: torch.Tensor, *, k: int, codes_transposed: bool = False,
              measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate-only search: tables -> scores -> top-k. ``codes`` is
    [S, N] for the LUT16 kernel (``codes_transposed``) or [N, S] for
    :func:`lut_score`. Returns (distances [B, k] in the measure's units,
    ids [B, k] int64)."""
    luts = _ah_luts(queries, centroids, measure)
    if codes_transposed:
        dists = lut16_score(luts, codes)
    else:
        dists = lut_score(luts, codes)
    dists = approx_to_measure_units(dists, measure)
    col = torch.arange(dists.shape[1], device=dists.device)
    dists = torch.where(col < n_valid, dists, float(MASKED_DISTANCE))
    return top_k_smallest(dists, k)


def ah_search_reorder(centroids: torch.Tensor, codes: torch.Tensor,
                      db: torch.Tensor, n_valid: int, queries: torch.Tensor,
                      pre_eps: float = float("inf"),
                      post_eps: float = float("inf"), *, pre_k: int, k: int,
                      measure: DistanceMeasure, codes_transposed: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-pre_k, then exact re-rank to top-k. With
    ``codes_transposed`` the kernel writes bf16 scores (half the score
    matrix's bytes; the exact re-rank absorbs the rounding). ``db`` is the
    float32 re-rank store [N, D]; the JAX package's ``db_sq_norms`` argument
    is dropped, since the norms are recomputed from the gathered rows there
    too. Returns (distances [B, k], ids [B, k])."""
    luts = _ah_luts(queries, centroids, measure)
    if codes_transposed:
        approx = lut16_score(luts, codes, out_dtype=torch.bfloat16)
    else:
        approx = lut_score(luts, codes)
    col = torch.arange(approx.shape[1], device=approx.device)
    approx = torch.where(col < n_valid, approx,
                         approx.new_tensor(float(MASKED_DISTANCE)))
    pre_vals, cand = approx_top_k_smallest(approx, pre_k)          # [B, pre_k]
    pre_m = approx_to_measure_units(pre_vals.float(), measure)
    valid = (cand < n_valid) & (pre_m <= pre_eps)
    exact = rerank_exact(db, queries, cand, valid, measure)
    return finalize_results(exact, cand, k, post_eps)


def ah_search_fused(centroids: torch.Tensor, packed_codes_t: torch.Tensor,
                    db: torch.Tensor, n_valid: int, queries: torch.Tensor,
                    pre_eps: float = float("inf"),
                    post_eps: float = float("inf"), *, pre_k: int, k: int,
                    measure: DistanceMeasure, r: int = 32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused int8 LUT16 pipeline; the [B, N] score matrix never exists.

    tables -> u8 quantization (one global range per query) -> even-first
    int8 tables -> fused sweep over packed nibbles with the r:1 block
    minimum -> top-pre_k over the [B, N/r] minima -> decode (sum, row) ->
    exact re-rank -> top-k. ``packed_codes_t`` is [S_pad/2, N_pad] uint8
    with N_pad a multiple of r. Returns (distances [B, k], ids [B, k])."""
    luts = _ah_luts(queries, centroids, measure)                  # [B, S, C]
    luts_i8, mult, bias = quantized_tables(luts)
    comb = lut16_fused_sweep(luts_i8, packed_codes_t, n_valid, r=r)
    cand, pre_valid = fused_candidates(comb, mult, bias, centroids.shape[0],
                                       pre_k=pre_k, r=r, measure=measure,
                                       pre_eps=pre_eps)
    exact = rerank_exact(db, queries, cand, pre_valid, measure)
    return finalize_results(exact, cand, k, post_eps)


class AsymmetricHasher(Searcher):
    """PQ hashing searcher on ``device`` (the current CUDA device unless the
    caller names another)."""

    # the fused sweep: rows of the padded corpus per tile, rows per block
    FUSED_TILE_N = 1024
    FUSED_R = 32
    # queries per pipeline call
    QUERY_CHUNK = 1024

    def __init__(self, config: Optional[AsymmetricHasherConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config or AsymmetricHasherConfig()
        if self.config.rerank_dtype not in ("float32", "bfloat16", "int8"):
            raise ScannError.invalid_argument(
                f"rerank_dtype must be float32, bfloat16 or int8, got "
                f"{self.config.rerank_dtype!r}")
        self.device = torch.device(device)
        self.codebook: Optional[Codebook] = None
        self.codes: Optional[torch.Tensor] = None     # [N, S] uint8
        self._dataset: Optional[DenseDataset] = None
        self._n = 0
        self._dim = 0
        self._codes_t: Optional[torch.Tensor] = None
        self._codes_packed_t: Optional[torch.Tensor] = None
        self._rerank_store = None

    # -- build ----------------------------------------------------------------
    def build(self, dataset: DenseDataset) -> "AsymmetricHasher":
        """Train the codebook on a sample of ``dataset`` and encode every
        row, on the searcher's device. COSINE rows are normalized first
        (on the host, as the JAX package does)."""
        if dataset.is_empty:
            raise ScannError.invalid_argument(
                "Cannot build from empty dataset")
        cfg = self.config
        if cfg.distance_measure not in _AH_MEASURES:
            raise ScannError.invalid_argument(
                f"AsymmetricHasher does not support {cfg.distance_measure}")
        device = require_device(self.device)
        if cfg.distance_measure == DistanceMeasure.COSINE:
            raw = dataset.numpy()
            nr = np.sqrt(np.einsum("nd,nd->n", raw, raw))
            dataset = DenseDataset(
                (raw / np.maximum(nr, 1e-30)[:, None]).astype(np.float32),
                docids=dataset.docids)
        data = dataset.numpy()
        self._n, self._dim = data.shape
        train = data
        if cfg.training_sample_size < len(data):
            # the JAX package's sample: the same rows from the same seed
            rng = np.random.default_rng(cfg.seed if cfg.seed is not None
                                        else 42)
            train = data[rng.choice(len(data), cfg.training_sample_size,
                                    replace=False)]
        self.codebook = Codebook(CodebookConfig(
            num_codes=cfg.num_codes,
            num_subspaces=cfg.num_subspaces,
            max_iterations=cfg.max_iterations,
            seed=cfg.seed,
            anisotropic_threshold=cfg.anisotropic_threshold,
        ), device=device).train(train)
        self.codes = self.codebook.encode_dataset(
            dataset.device_tensor(device))
        self._dataset = dataset if cfg.store_dataset else None
        self._codes_t = None
        self._codes_packed_t = None
        self._rerank_store = None
        return self

    # -- device layouts -------------------------------------------------------
    def _device_codes_t(self) -> torch.Tensor:
        """[S, N] uint8 codes for the LUT16 score kernel (no padding: the
        kernel takes any N; columns past N are never read)."""
        if self._codes_t is None:
            self._codes_t = self.codes.T.contiguous()
        return self._codes_t

    def _device_codes_packed_t(self) -> torch.Tensor:
        """[S_pad/2, N_pad] uint8 packed nibbles for the fused sweep, half
        the bytes of the unpacked layout; N_pad = N rounded up to
        ``FUSED_TILE_N``, the padded columns zero (masked by n_valid)."""
        if self._codes_packed_t is None:
            packed = pack_codes_4bit_device(self.codes)            # [N, sh]
            n_pad = align_up(max(self._n, 1), self.FUSED_TILE_N)
            full = packed.new_zeros(n_pad, packed.shape[1])
            full[:self._n] = packed
            self._codes_packed_t = full.T.contiguous()
        return self._codes_packed_t

    # -- metadata -------------------------------------------------------------
    def dataset_size(self) -> int:
        return self._n

    def dimensionality(self) -> int:
        return self._dim

    def _docids(self):
        return self._dataset.docids if self._dataset is not None else None

    def memory_usage(self) -> int:
        """Code bytes: packed, ceil(S/2) per row, when the codes are 4-bit."""
        if self.codes is None:
            return 0
        n, s = self.codes.shape
        return n * ((s + 1) // 2) if self.codebook.num_codes <= 16 else n * s

    # -- dispatch -------------------------------------------------------------
    def _use_kernels(self) -> bool:
        """The LUT16 kernels score 16-entry tables (C <= 16)."""
        return self.codebook.num_codes <= 16

    def _use_fused(self, pre_k: int) -> bool:
        """The fused sweep needs enough blocks that one candidate per block
        cannot starve pre_k."""
        n_blocks = align_up(max(self._n, 1), self.FUSED_TILE_N) // self.FUSED_R
        return self._use_kernels() and n_blocks >= 2 * pre_k

    # -- search ---------------------------------------------------------------
    def search_batched_tensors(self, queries: torch.Tensor, k: int,
                               params: Optional[SearchParameters] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, k] int64, distances [B, k] float32) for [B, D] float32
        queries, on the searcher's device, -1 / inf where a result is
        missing; no host copy of the results.

        With ``pre_reordering_num_neighbors`` above k the candidates are
        re-ranked exactly (the fused sweep or the score-then-select path);
        otherwise the approximate distances are the results and the tighter
        of the two epsilons applies to them."""
        self._check_built()
        q = queries.to(self.codes.device).float()
        if q.dim() == 1:
            q = q[None, :]
        if q.dim() != 2 or q.shape[1] != self._dim:
            raise ScannError.invalid_argument(
                f"queries must be [B, {self._dim}], got {tuple(q.shape)}")
        if self.config.distance_measure == DistanceMeasure.COSINE:
            q = _normalize(q)
        k = min(int(k), self._n)
        if k <= 0:
            raise ScannError.invalid_argument(f"k must be positive, got {k}")
        pre_k = None
        if params is not None and \
                params.pre_reordering_num_neighbors is not None:
            pre_k = min(int(params.pre_reordering_num_neighbors), self._n)
        pre_eps, post_eps = epsilons(params)
        if pre_k is not None and pre_k > k:
            return self._search_reorder(q, k, pre_k, pre_eps, post_eps)

        transposed = self._use_kernels()
        codes = self._device_codes_t() if transposed else self.codes
        cent = self.codebook.centroids
        out_d, out_i = [], []
        for lo in range(0, q.shape[0], self.QUERY_CHUNK):
            dists, idx = ah_search(
                cent, codes, self._n, q[lo:lo + self.QUERY_CHUNK], k=k,
                codes_transposed=transposed,
                measure=self.config.distance_measure)
            out_d.append(dists)
            out_i.append(idx)
        dists, idx = torch.cat(out_d), torch.cat(out_i)
        if params is not None:
            # approximate only: the search is both stages
            eps = params.effective_epsilon()
            if np.isfinite(eps):
                over = dists > eps
                dists = torch.where(over, float("inf"), dists)
                idx = torch.where(over, -1, idx)
        return idx, dists

    def search_batched_arrays(self, queries: np.ndarray, k: int,
                              params: Optional[SearchParameters] = None):
        """(indices [B, k] int32, distances [B, k] float32) as numpy."""
        self._check_built()
        queries = self._validate_queries(queries)
        idx, dists = self.search_batched_tensors(torch.from_numpy(queries), k,
                                                 params)
        return (idx.cpu().numpy().astype(np.int32),
                dists.cpu().numpy().astype(np.float32))

    def search_with_reordering(self, query, k: int, pre_reorder_k: int):
        """One query, approximate top-``pre_reorder_k`` re-ranked exactly to
        top-k: (ids [<= k] int32, distances float32) as numpy, missing
        results dropped. The port has no per-query result objects."""
        self._check_built()
        q = torch.from_numpy(self._validate_queries(np.asarray(query))).to(
            self.codes.device)
        if self.config.distance_measure == DistanceMeasure.COSINE:
            q = _normalize(q)
        k_c = min(int(k), self._n)
        # the exact stage's top-k is at most as wide as its candidate list
        pre_c = min(max(int(pre_reorder_k), k_c), self._n)
        idx, dist = self._search_reorder(q, k_c, pre_c)
        keep = idx[0] >= 0
        return (idx[0][keep].cpu().numpy().astype(np.int32),
                dist[0][keep].cpu().numpy().astype(np.float32))

    def _search_reorder(self, q: torch.Tensor, k: int, pre_k: int,
                        pre_eps: float = float("inf"),
                        post_eps: float = float("inf")
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        db = self._rerank_state()
        cent = self.codebook.centroids
        measure = self.config.distance_measure
        fused = self._use_fused(pre_k)
        if fused:
            codes = self._device_codes_packed_t()
        else:
            transposed = self._use_kernels()
            codes = self._device_codes_t() if transposed else self.codes
        out_d, out_i = [], []
        for lo in range(0, q.shape[0], self.QUERY_CHUNK):
            qc = q[lo:lo + self.QUERY_CHUNK]
            if fused:
                dists, idx = ah_search_fused(
                    cent, codes, db, self._n, qc, pre_eps, post_eps,
                    pre_k=pre_k, k=k, measure=measure, r=self.FUSED_R)
            else:
                dists, idx = ah_search_reorder(
                    cent, codes, db, self._n, qc, pre_eps, post_eps,
                    pre_k=pre_k, k=k, measure=measure,
                    codes_transposed=transposed)
            out_d.append(dists)
            out_i.append(idx)
        return torch.cat(out_i), torch.cat(out_d)

    def _rerank_state(self):
        """The re-rank store on the codes' device: the float32 rows, or the
        ``rerank_dtype`` store encoded on the host and uploaded once."""
        if self._dataset is None:
            raise ScannError.failed_precondition("Dataset not stored")
        device = self.codes.device
        if self.config.rerank_dtype == "float32":
            return self._dataset.device_tensor(device)
        if self._rerank_store is None:
            data = self._dataset.numpy()
            self._rerank_store, _ = build_rerank_store(
                data, len(data), self.config.rerank_dtype, 1, device)
        return self._rerank_store

    def _check_built(self):
        if self.codebook is None:
            raise ScannError.failed_precondition("hasher not built")
