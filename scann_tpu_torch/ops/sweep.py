"""Fused bf16 block-min sweep (counterpart of
``scann_tpu/ops/sweep_pallas.py``; the name drops "pallas" because the
kernels here are CUDA).

The database is stored once as bf16 rows augmented with their squared norm,
so a query's whole first-pass distance is one product:

    row   = [x, ||x||^2, 0...]          (bf16, built once at index time)
    q'    = [-2q, 1, 0...]              (squared-L2)
    score = row . q' = ||x||^2 - 2 q.x  (rank-equivalent to squared-L2)

Each contiguous block of ``r`` rows is reduced to its minimum and argmin
per query, so the [N, B] score matrix never reaches device memory. The
[N/r, B] block minima feed a top-pre_k, and an exact float32 re-rank of the
pre_k survivors restores full-precision distances. Invalid and padded rows
carry a huge value in the norm slot, so masking costs nothing in the
product.

Four forms of the reduction, each with a plain PyTorch twin beside it:

  - :func:`block_min_sweep`: row-major [N/r, B] float32 minima + int32
    offsets (TPU kernel ``_block_min_kernel``, #3);
  - :func:`block_min_sweep_qmajor`: query-major [B, N/r] float32 + int32
    (``_block_min_qmajor_kernel``, #4), or with ``compact=True`` bf16 +
    uint8 (``_block_min_qmajor_compact_kernel``, #5);
  - :func:`block_min2_sweep`: the two smallest per block by the JAX
    package's tournament, row-major (``_block_min2_kernel``, #6).

Two CUDA kernels serve them. ``csrc/block_min_compact.cu`` (wgmma with the
queries in registers, the rows by TMA, a persistent grid; the epilogue a
template parameter) takes every form's calls for bf16 rows, D1 <= 256 and
8 <= r <= 256, and the float32 q-major form's up to r = 512 (a block over
four 128-row tiles). ``csrc/block_min_sweep.cu`` (mma.sync, one instance a
form) takes the rest: int8 rows, r < 8, r > 256 (r > 512 q-major), wider
rows. :func:`sweep_plan` decides from the arguments alone.

CPU tensors take the twins; CUDA tensors launch a kernel or raise. Each
kernel launch adds one to its form's entry in :data:`LAUNCHES` and to the
entry of the kernel that served it in :data:`LAUNCHES_BY_KERNEL`
(:data:`COMPACT_LAUNCHES` is the compact form's).

:func:`block_minima` keeps the JAX package's dispatch rule
(``sweep_block_candidates``): the tournament for top2; the row-major form
on the CPU (the JAX package's interpret branch); on the card the q-major
form where :func:`qmajor_supported` holds (compact for r <= 256); else the
row-major form. :func:`sweep_search` is the whole pipeline, the counterpart
of ``sweep_search_kernel``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from scann_tpu_torch.ops.distances import DistanceMeasure, gathered_distances
from scann_tpu_torch.ops.topk import approx_top_k_smallest, top_k_smallest
from scann_tpu_torch.types import (
    MASKED_DISTANCE,
    MAX_SHARED_MEMORY,
    align_up,
    on_card,
)
from scann_tpu_torch.utils.reordering import (
    gather_rerank_rows,
    rerank_store_rows,
)

# Sentinel carried in the augmented norm column of invalid rows. bf16-exact
# (a power of two) and far above any real score, far below bf16 max.
BLOCK_MASK_VALUE = float(2.0 ** 30)

# int8 sweep: the squared norm is carried as THREE base-128 digits in the
# row's padding lanes (digits in [-64, 63], slot multipliers sn * (1, 128,
# 16384) with sn a power of two — every multiplier and digit is exact in
# bf16, so the decoded norm is exact to sn/2). Max encodable magnitude:
INT8_NORM_DIGIT_MAX = 63 + 63 * 128 + 63 * 16384  # 1,040,319
# real norms are scaled to stay below this, leaving >2x margin to the mask
INT8_NORM_REAL_MAX = 400_000

# Kernel launches since the last reset, one entry per form of the kernel.
# Only a launch of the CUDA kernel counts, never a call of a plain twin; a
# run reads these to show that its main path went through the kernels.
LAUNCHES: Dict[str, int] = {"block_min": 0, "block_min_qmajor": 0,
                            "block_min_qmajor_compact": 0, "block_min2": 0}

# Each form's launches by the kernel that served them: the wgmma kernel of
# csrc/block_min_compact.cu or the mma.sync kernel of block_min_sweep.cu.
LAUNCHES_BY_KERNEL: Dict[str, Dict[str, int]] = {
    name: {"block_min_compact": 0, "block_min_sweep": 0}
    for name in LAUNCHES}
COMPACT_LAUNCHES = LAUNCHES_BY_KERNEL["block_min_qmajor_compact"]

# the JAX package pads a search batch to this many queries (its bf16
# sublane count) before the dispatch reads the batch size
_BATCH_ALIGN = 16
# the CUDA kernel's tiles: rows per tile, queries per block, and the
# deepest tournament stack across tiles (r <= 128 * 2**6)
_TILE_ROWS, _TILE_Q, _MAX_R = 128, 128, 8192
# elements of the [rows, B] float32 score slab one step of a twin holds
_TWIN_SCORE_ELEMS = 1 << 26

_fn = None


def reset_launches() -> None:
    for counts in (LAUNCHES, *LAUNCHES_BY_KERNEL.values()):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# host builders (numpy, as in the JAX package, so the bits agree)
# ---------------------------------------------------------------------------


def augmented_dim(d: int) -> int:
    """Minor dim of the augmented row: original + norm slot, 8-aligned."""
    return align_up(d + 1, 8)


def shuffle_stride_for(n: int) -> int:
    """A multiplicative stride coprime with n, near the golden ratio of n —
    the seedless analog of a random row shuffle. ``i -> (i * s) % n``
    spreads any cluster-sorted input across the whole array, so the best
    blocks of a query do not crowd into neighbouring block-minima columns.
    Positions are computed in int64: ``pos * s`` overflows int32 past
    ~2**31, which collapsed recall at 1.18M rows in the JAX package."""
    s = max(int(0.6180339887 * n) | 1, 1)
    while math.gcd(s, n) != 1:
        s += 2
    return s


def _to_bf16(a: np.ndarray) -> torch.Tensor:
    """float32 array -> bf16 tensor, round to nearest even (the rounding
    of ``astype(bfloat16)`` in the JAX package)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)


def build_augmented_db(db: np.ndarray, n_valid: int, measure: DistanceMeasure,
                       tile_n: int = 2048, shuffle_stride: int = 0,
                       pad_rows_to: int = 0) -> torch.Tensor:
    """[N_pad, D1] bf16 augmented rows (a CPU tensor, built once at index
    time).

    The norm slot holds ||x||^2 for SQUARED_L2, 0 for DOT_PRODUCT/COSINE
    (cosine rows are L2-normalized here so the sweep scores -cos
    similarity), and BLOCK_MASK_VALUE for padded rows. ``shuffle_stride``
    > 0 stores row i at position (i*s) % n_valid (:func:`shuffle_stride_for`).
    """
    db = np.asarray(db, dtype=np.float32)
    n, d = db.shape
    d1 = augmented_dim(d)
    n_pad = max(align_up(max(n_valid, 1), tile_n), pad_rows_to)
    out = np.zeros((n_pad, d1), dtype=np.float32)
    rows = db
    if measure == DistanceMeasure.COSINE:
        norms = np.sqrt(np.einsum("nd,nd->n", db, db))
        rows = db / np.maximum(norms, 1e-30)[:, None]
    if shuffle_stride:
        pos = (np.arange(n, dtype=np.int64) * shuffle_stride) % max(n_valid, 1)
        out[pos[:n_valid], :d] = rows[:n_valid]
    else:
        out[:n, :d] = rows
    if measure == DistanceMeasure.SQUARED_L2:
        sq = np.einsum("nd,nd->n", db, db)
        if shuffle_stride:
            out[pos[:n_valid], d] = sq[:n_valid]
        else:
            out[:n, d] = sq
    out[n_valid:, d] = BLOCK_MASK_VALUE
    return _to_bf16(out)


def _encode_norm_digits(m: np.ndarray):
    """Non-negative ints -> three balanced base-128 digits in [-64, 63]."""
    d0 = ((m + 64) % 128) - 64
    c = (m - d0) // 128
    d1 = ((c + 64) % 128) - 64
    d2 = (c - d1) // 128
    return d0, d1, d2


def build_int8_augmented_db(db: np.ndarray, n_valid: int,
                            measure: DistanceMeasure, tile_n: int = 2048,
                            shuffle_stride: int = 0, pad_rows_to: int = 0):
    """int8 sweep storage, half the bf16 stream bytes.

    Returns ``(codes int8 [N_pad, D1], scales f32 [d], sn: float)`` as CPU
    tensors and a float:

    - ``codes[:, :d]``: per-dimension symmetric int8 (scale
      ``s_j = max|x_j| / 127``, folded into the query head at search time);
    - ``codes[:, d:d+3]``: the squared norm as base-128 digits for
      SQUARED_L2 (see INT8_NORM_DIGIT_MAX), zeros for dot/cosine;
    - padded rows carry the all-63 mask digits (decoded magnitude
      INT8_NORM_DIGIT_MAX * sn, above any real score).
    """
    db = np.asarray(db, dtype=np.float32)
    n, d = db.shape
    d1 = align_up(d + 3, 8)
    n_pad = max(align_up(max(n_valid, 1), tile_n), pad_rows_to)
    rows = db
    if measure == DistanceMeasure.COSINE:
        norms = np.sqrt(np.einsum("nd,nd->n", db, db))
        rows = db / np.maximum(norms, 1e-30)[:, None]
    scales = np.abs(rows[:n_valid]).max(axis=0) / 127.0
    scales = np.maximum(scales, 1e-30).astype(np.float32)
    codes = np.zeros((n_pad, d1), dtype=np.int8)
    q = np.clip(np.rint(rows[:n_valid] / scales), -127, 127).astype(np.int8)
    if measure == DistanceMeasure.SQUARED_L2:
        sq = np.einsum("nd,nd->n", db[:n_valid], db[:n_valid])
        sn = float(2.0 ** np.ceil(np.log2(
            max(float(sq.max()), 1e-30) / INT8_NORM_REAL_MAX)))
        m = np.rint(sq / sn).astype(np.int64)
    else:
        # digits are zero for real rows; sn only scales the mask sentinel.
        # 512 puts the mask at ~5.3e8, the bf16 layout's 2^30-class margin.
        sn = 512.0
        m = np.zeros(n_valid, dtype=np.int64)
    g0, g1, g2 = _encode_norm_digits(m)
    if shuffle_stride:
        pos = (np.arange(n_valid, dtype=np.int64) * shuffle_stride) \
            % max(n_valid, 1)
    else:
        pos = np.arange(n_valid, dtype=np.int64)
    codes[pos, :d] = q
    codes[pos, d] = g0.astype(np.int8)
    codes[pos, d + 1] = g1.astype(np.int8)
    codes[pos, d + 2] = g2.astype(np.int8)
    mask_rows = np.ones(n_pad, dtype=bool)
    mask_rows[pos] = False
    codes[mask_rows, d:d + 3] = 63
    return torch.from_numpy(codes), torch.from_numpy(scales), sn


def int8_mask_cut(sn: float) -> float:
    """Validity threshold for int8-sweep block minima (mask sentinel / 2)."""
    return INT8_NORM_DIGIT_MAX * sn * 0.5


def _query_head(q: torch.Tensor, measure: DistanceMeasure) -> torch.Tensor:
    """The query part of the augmented row, before any int8 scales."""
    if measure == DistanceMeasure.SQUARED_L2:
        return -2.0 * q
    if measure == DistanceMeasure.COSINE:
        nq = torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))
        return -(q / nq.clamp_min(1e-30))
    if measure in (DistanceMeasure.DOT_PRODUCT,
                   DistanceMeasure.GENERAL_INNER_PRODUCT):
        return -q
    raise ValueError(f"unsupported sweep measure {measure}")


def _augment_queries_int8(queries: torch.Tensor, measure: DistanceMeasure,
                          scales: torch.Tensor, sn: float,
                          d1: int) -> torch.Tensor:
    """[B, D1] bf16 query block matching ``build_int8_augmented_db``: the
    per-dim scales fold into the head; the three norm slots carry the
    base-128 multipliers (powers of two x sn, exact in bf16)."""
    q = queries.float()
    b, d = q.shape
    out = torch.zeros(b, d1, dtype=torch.float32, device=q.device)
    out[:, :d] = _query_head(q, measure) * scales.to(q.device)
    out[:, d] = sn
    out[:, d + 1] = 128.0 * sn
    out[:, d + 2] = 16384.0 * sn
    return out.to(torch.bfloat16)


def _augment_queries(queries: torch.Tensor, measure: DistanceMeasure,
                     d1: int) -> torch.Tensor:
    """[B, D1] bf16 query block matching ``build_augmented_db``'s layout."""
    q = queries.float()
    b, d = q.shape
    out = torch.zeros(b, d1, dtype=torch.float32, device=q.device)
    out[:, :d] = _query_head(q, measure)
    out[:, d] = 1.0  # picks up the norm slot / mask sentinel
    return out.to(torch.bfloat16)


def qmajor_step_rows(r: int) -> int:
    """Rows per q-major grid step of the TPU kernel: the minima block's lane
    dim is a 128-multiple, so each step covers 128 blocks = 128*r rows."""
    return 128 * r


# The JAX package's cap on the q-major kernel's scores + iota intermediates
# per step (b * step * 8 bytes), a TPU VMEM budget. It has no meaning on the
# GPU; the port keeps it so the dispatch matches the JAX package's, until a
# measurement on the card decides the rule (ROADMAP.md, open questions).
_QMAJOR_VMEM_BYTES = 80 * 1024 * 1024


def qmajor_supported(n_rows: int, b: int, r: int) -> bool:
    step = qmajor_step_rows(r)
    return n_rows % step == 0 and b * step * 8 <= _QMAJOR_VMEM_BYTES


def build_allow_penalty(mask, n_pad: int, r: int, inv_perm=None,
                        mask_value: float = 4 * BLOCK_MASK_VALUE
                        ) -> torch.Tensor:
    """Restrict allowlist -> [N_pad/r, r] bf16 additive penalty (a CPU
    tensor): 0 for allowed rows, ``mask_value`` for denied ones, in the
    sweep's STORED row order. ``inv_perm`` maps stored position -> original
    point id (None = identity). Padding rows get 0: their augmented norm
    slot already carries the mask sentinel.

    ``mask_value`` defaults to 4x the bf16 layout's sentinel so a denied
    row's penalized score clears the validity cut even if its raw score is
    strongly negative; int8-layout callers pass 4 * INT8_NORM_DIGIT_MAX *
    sn."""
    mask = np.asarray(mask, dtype=bool)
    n = mask.shape[0]
    pen = np.zeros(n_pad, np.float32)
    stored = mask if inv_perm is None else mask[np.asarray(inv_perm)]
    pen[:n] = np.where(stored, 0.0, mask_value)
    return _to_bf16(pen.reshape(n_pad // r, r))


# ---------------------------------------------------------------------------
# plain PyTorch twins of the kernel
# ---------------------------------------------------------------------------


def _block_scores(q_aug: torch.Tensor, db_aug: torch.Tensor, r: int,
                  penalty: Optional[torch.Tensor], absolute: bool = False):
    """Yields (first block, [rows/r, r, B] float32 scores) over row slabs:
    bf16 (or int8) rows times bf16 queries, exact products summed in
    float32, plus the penalty; with ``absolute`` the sums of the terms'
    magnitudes instead. The float32 product must not run in TF32."""
    if q_aug.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the sweep twin needs float32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    q = q_aug.float().abs() if absolute else q_aug.float()
    b = q.shape[0]
    n = db_aug.shape[0]
    step = max(r, _TWIN_SCORE_ELEMS // max(b, 1) // r * r)
    for lo in range(0, n, step):
        rows = db_aug[lo:lo + step].float()
        s3 = ((rows.abs() if absolute else rows) @ q.T).view(-1, r, b)
        if penalty is not None:
            pen = penalty[lo // r:(lo + step) // r].float()[:, :, None]
            s3 = s3 + (pen.abs() if absolute else pen)
        yield lo // r, s3


def _check_twin_args(q_aug, db_aug, r, penalty):
    n = db_aug.shape[0]
    if r <= 0 or n % r:
        raise ValueError(f"{n} rows are not a multiple of block_r={r}")
    if q_aug.shape[1] != db_aug.shape[1]:
        raise ValueError(f"query width {q_aug.shape[1]} != row width "
                         f"{db_aug.shape[1]}")
    if penalty is not None and tuple(penalty.shape) != (n // r, r):
        raise ValueError(f"penalty must be [{n // r}, {r}], got "
                         f"{tuple(penalty.shape)}")


def block_min_sweep_reference(q_aug: torch.Tensor, db_aug: torch.Tensor, *,
                              r: int = 32,
                              penalty: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of the row-major kernel: (vals [N/r, B] float32, locs [N/r, B]
    int32 offsets within the block, lowest offset first on ties)."""
    _check_twin_args(q_aug, db_aug, r, penalty)
    nb, b = db_aug.shape[0] // r, q_aug.shape[0]
    vals = torch.empty(nb, b, dtype=torch.float32, device=db_aug.device)
    locs = torch.empty(nb, b, dtype=torch.int32, device=db_aug.device)
    for g0, s3 in _block_scores(q_aug, db_aug, r, penalty):
        v, i = torch.min(s3, dim=1)
        vals[g0:g0 + len(v)] = v
        locs[g0:g0 + len(v)] = i.int()
    return vals, locs


def block_min_sweep_qmajor_reference(
        q_aug: torch.Tensor, db_aug: torch.Tensor, *, r: int = 32,
        compact: bool = False, penalty: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of the q-major kernels: (vals [B, N/r], locs [B, N/r]) as
    float32 + int32, or with ``compact`` bf16 (rounded to nearest even) +
    uint8."""
    if compact and r > 256:
        raise ValueError(f"compact q-major minima need r <= 256, got {r}")
    vals, locs = block_min_sweep_reference(q_aug, db_aug, r=r,
                                           penalty=penalty)
    vals, locs = vals.T.contiguous(), locs.T.contiguous()
    if compact:
        return vals.to(torch.bfloat16), locs.to(torch.uint8)
    return vals, locs


def _tournament2(s3: torch.Tensor):
    """Two smallest of each [., r, .] block by the JAX package's tournament
    (contiguous pairs, then merges of (first, second) runs), which breaks
    ties its own way: for [1, 1, 5, 1] the second minimum is offset 3."""
    iota = torch.arange(s3.shape[1], dtype=torch.int32,
                        device=s3.device).view(1, -1, 1).expand_as(s3)
    a, bb = s3[:, 0::2], s3[:, 1::2]
    ia, ib = iota[:, 0::2], iota[:, 1::2]
    ta = a <= bb
    m1, l1 = torch.where(ta, a, bb), torch.where(ta, ia, ib)
    m2, l2 = torch.where(ta, bb, a), torch.where(ta, ib, ia)
    while m1.shape[1] > 1:
        m1a, m1b = m1[:, 0::2], m1[:, 1::2]
        l1a, l1b = l1[:, 0::2], l1[:, 1::2]
        m2a, m2b = m2[:, 0::2], m2[:, 1::2]
        l2a, l2b = l2[:, 0::2], l2[:, 1::2]
        ta = m1a <= m1b
        m1, l1 = torch.where(ta, m1a, m1b), torch.where(ta, l1a, l1b)
        mo, lo = torch.where(ta, m1b, m1a), torch.where(ta, l1b, l1a)
        t2 = m2a <= m2b
        c2, lc2 = torch.where(t2, m2a, m2b), torch.where(t2, l2a, l2b)
        to = mo <= c2
        m2, l2 = torch.where(to, mo, c2), torch.where(to, lo, lc2)
    return m1[:, 0], l1[:, 0], m2[:, 0], l2[:, 0]


def block_min2_sweep_reference(q_aug: torch.Tensor, db_aug: torch.Tensor, *,
                               r: int = 32,
                               penalty: Optional[torch.Tensor] = None):
    """Twin of the tournament kernel: (v1, l1, v2, l2), each [N/r, B]
    (float32 values, int32 offsets). ``r`` must be a power of two >= 2."""
    if r < 2 or r & (r - 1):
        raise ValueError(f"the top-2 tournament needs r a power of two >= 2, "
                         f"got {r}")
    _check_twin_args(q_aug, db_aug, r, penalty)
    nb, b = db_aug.shape[0] // r, q_aug.shape[0]
    dev = db_aug.device
    outs = (torch.empty(nb, b, dtype=torch.float32, device=dev),
            torch.empty(nb, b, dtype=torch.int32, device=dev),
            torch.empty(nb, b, dtype=torch.float32, device=dev),
            torch.empty(nb, b, dtype=torch.int32, device=dev))
    for g0, s3 in _block_scores(q_aug, db_aug, r, penalty):
        for out, part in zip(outs, _tournament2(s3)):
            out[g0:g0 + len(part)] = part
    return outs


def _bf16_order(x: torch.Tensor) -> torch.Tensor:
    """bf16 values -> int32 keys whose differences count bf16 ulps."""
    bits = x.contiguous().view(torch.int16).int()
    mag = bits & 0x7FFF
    return torch.where(bits < 0, -mag, mag)


def check_against_twin(form: str, got, q_aug: torch.Tensor,
                       db_aug: torch.Tensor, *, r: int,
                       penalty: Optional[torch.Tensor] = None) -> dict:
    """Holds a kernel's block minima against the twin's arithmetic on the
    same inputs, block slab by block slab, and raises AssertionError past
    the tolerance. ``form``: "rowmajor", "qmajor", "compact" or "top2";
    ``got``: the kernel's outputs.

    - values: |kernel - twin| <= 1e-5 * S + 1e-5, S the block's largest sum
      of term magnitudes: only the float32 summation order differs;
    - compact values: at most 1 bf16 ulp from the twin's rounded minimum,
      or, near 0 where a bf16 ulp is smaller than the float32 tolerance,
      within that tolerance plus half a bf16 spacing of the twin's float32
      minimum (the kernel's own minimum, rounded); such values are counted;
    - offsets: compared by the twin score they achieve (within the value
      tolerance of the twin's minimum), as tests/test_block_sweep.py does;
      the share of bit-identical offsets is reported.

    Returns {"max_abs_err", "max_ulp", "ulp_over_1", "loc_equal",
    "checked"}."""
    top2 = form == "top2"
    qmajor = form in ("qmajor", "compact")
    got = [t.T if qmajor else t for t in got]      # -> [N/r, B]
    max_err, max_ulp, over, same, total = 0.0, 0, 0, 0, 0
    abs_slabs = _block_scores(q_aug, db_aug, r, penalty, absolute=True)
    for g0, s3 in _block_scores(q_aug, db_aug, r, penalty):
        _, a3 = next(abs_slabs)
        tol = 1e-5 * a3.max(dim=1).values + 1e-5           # [G, B]
        g1 = g0 + s3.shape[0]
        if top2:
            m1, l1, m2, l2 = _tournament2(s3)
            pairs = ((m1, l1, got[0], got[1]), (m2, l2, got[2], got[3]))
            if bool((got[1][g0:g1] == got[3][g0:g1]).any()):
                raise AssertionError("top-2 offsets repeat within a block")
        else:
            m1, l1 = torch.min(s3, dim=1)
            pairs = ((m1, l1, got[0], got[1]),)
        for want_v, want_l, got_v, got_l in pairs:
            gv, gl = got_v[g0:g1], got_l[g0:g1].long()
            if form == "compact":
                # 1 bf16 ulp from the twin's rounded minimum, or, where the
                # minimum is near 0 and a ulp is tiny, the kernel's float32
                # minimum (within tol of the twin's) rounded: tol + spacing/2
                want_c = want_v.to(torch.bfloat16)
                ulp = (_bf16_order(gv) - _bf16_order(want_c)).abs()
                spacing = torch.ldexp(torch.ones_like(want_v),
                                      torch.frexp(gv.float())[1] - 8)
                bad = (ulp > 1) & ((gv.float() - want_v).abs()
                                   > tol + spacing / 2)
                if bool(bad.any()):
                    i = bad.nonzero()[0]
                    raise AssertionError(
                        f"compact value {float(gv[tuple(i)])} against the "
                        f"twin's {float(want_v[tuple(i)])} (tolerance "
                        f"{float(tol[tuple(i)])} + half a bf16 spacing)")
                max_ulp = max(max_ulp, int(ulp.max()))
                over += int((ulp > 1).sum())
                err = (gv.float() - want_c.float()).abs()
            else:
                err = (gv.float() - want_v).abs()
                if bool((err > tol).any()):
                    raise AssertionError(
                        f"{form} values differ from the twin by up to "
                        f"{float((err - tol).max()):.3g} past tolerance")
            max_err = max(max_err, float(err.max()))
            if bool(((gl < 0) | (gl >= r)).any()):
                raise AssertionError(f"{form} offsets outside [0, {r})")
            achieved = torch.gather(s3, 1, gl[:, None, :])[:, 0]
            if bool(((achieved - want_v).abs() > tol).any()):
                raise AssertionError(
                    f"{form} offsets do not achieve the block minimum")
            same += int((gl == want_l.long()).sum())
            total += gl.numel()
    return {"max_abs_err": max_err, "max_ulp": max_ulp, "ulp_over_1": over,
            "loc_equal": same / max(total, 1), "checked": total}


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _kernel_fn():
    global _fn
    if _fn is None:
        from scann_tpu_torch import native

        fn = native.load("block_min_sweep").block_min_sweep
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, i32,
                       i32, i32, i32, i32, i32, i32, vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def kernel_smem_bytes(d1: int, int8_rows: bool, top2: bool) -> int:
    """Shared memory of one CTA of the kernel, as the C launcher asks for
    it: the query tile, two row tiles, the cross-warp exchange and the
    staged block results."""
    q_bytes = align_up(_TILE_Q * d1 * 2, 16)
    return (q_bytes + 2 * _TILE_ROWS * d1 * (1 if int8_rows else 2)
            + 2 * _TILE_Q * 16 + _TILE_ROWS // 8 * _TILE_Q * (12 if top2 else 8))


# -- the wgmma kernel (csrc/block_min_compact.cu) ------------------------------

# rows and queries of a tile (the wgmma N and two warpgroups' M); bf16
# columns of one 128-byte swizzled TMA box of rows; boxes a row tile may
# span (D1 <= 256); ring stages; blocks a query of a run
COMPACT_TILE_ROWS, COMPACT_TILE_Q, COMPACT_BOX_COLS = 128, 128, 64
_COMPACT_MAX_BOXES, _COMPACT_MAX_STAGES, _COMPACT_RUN_BLOCKS = 4, 8, 64
# streaming multiprocessors of an H100 SXM: sweep_plan's default grid width
H100_SMS = 132
# the kernel's epilogues, in the order of its kCompact, kRowMajor, kTop2,
# kQMajor
SWEEP_FORMS = ("compact", "rowmajor", "top2", "qmajor")
# the largest block each form takes: r = 512 spans four 128-row tiles, a
# carry the q-major form keeps in registers; the others keep r <= 256
_SWEEP_MAX_R = {"compact": 256, "rowmajor": 256, "top2": 256, "qmajor": 512}

_compact_fn = None


class CompactPlan(NamedTuple):
    """Launch plan of ``block_min_compact.cu``: ``nks`` k16 steps a tile (4
    a TMA box of 64 columns), ``stages`` in the TMA ring, ``cluster`` CTAs
    sharing each row tile (each loads 128 / cluster of its rows into all),
    ``run_tiles`` row tiles a work unit, ``units`` = ``runs`` x
    ceil(``q_tiles`` / cluster) work units of a cluster, ``smem_bytes`` a
    CTA."""
    nks: int
    stages: int
    cluster: int
    run_tiles: int
    runs: int
    q_tiles: int
    units: int
    smem_bytes: int


def compact_smem_bytes(d1: int, r: int, stages: int, run_tiles: int) -> int:
    """Shared memory of one CTA of the compact form (csrc/
    block_min_compact.cu sweep_layout): the ring's stages of ceil(D1 / 64)
    TMA boxes of 128 rows x 128 bytes, the run's staged bf16 minima and u8
    offsets (rows padded to 16 bytes, plus 16), the barriers, 1 KB of
    alignment."""
    return sweep_smem_bytes("compact", d1, r, stages, run_tiles)


def sweep_smem_bytes(form: str, d1: int, r: int, stages: int,
                     run_tiles: int) -> int:
    """Shared memory of one CTA of ``form``: as
    :func:`compact_smem_bytes`; the row-major and q-major float32 forms
    store from registers and stage nothing."""
    blocks = run_tiles * COMPACT_TILE_ROWS // r
    stage = -(-d1 // COMPACT_BOX_COLS) * COMPACT_TILE_ROWS * 128
    staging = COMPACT_TILE_Q * (align_up(2 * blocks, 16) + 16
                                + align_up(blocks, 16) + 16)
    return (1024 + stages * stage + 16 * stages
            + (staging if form == "compact" else 0))


def compact_plan(n: int, b: int, d1: int, r: int, int8_rows: bool,
                 sms: int = H100_SMS) -> Optional[CompactPlan]:
    """:func:`sweep_plan` of the compact form."""
    return sweep_plan("compact", n, b, d1, r, int8_rows, sms)


@functools.lru_cache(maxsize=256)
def sweep_plan(form: str, n: int, b: int, d1: int, r: int, int8_rows: bool,
               sms: int = H100_SMS) -> Optional[CompactPlan]:
    """The plan of ``block_min_compact.cu`` for a call of ``form`` (one of
    :data:`SWEEP_FORMS`), or None where the call stays with
    ``block_min_sweep.cu``: int8 rows, r outside [8, 256] ([8, 512] for the
    q-major float32 form), D1 past 256 or not a multiple of 8, 2**31 rows
    or more.

    Clusters of 2 CTAs where there are 2 query tiles or more, so each row
    tile leaves L2 once for 2 query tiles (clusters of 4 fit 120 of the
    H100's 132 SMs and ran slower). A run is r / 2 tiles (64 blocks a
    query), halved while the units would not fill ``sms`` CTAs, and a
    multiple of r / 128 tiles where a block spans several. The q-major
    float32 form stages nothing, so its run is free: the one whose busiest
    cluster walks the fewest tiles (:func:`busiest_cluster_tiles`), the
    longest of those. The ring takes up to eight stages that fit in shared
    memory beside the compact form's staging, at least two. Plans are
    cached: a search batch asks for the same one each call."""
    if form not in SWEEP_FORMS:
        raise ValueError(f"form must be one of {SWEEP_FORMS}, got {form!r}")
    if (int8_rows or r < 8 or r > _SWEEP_MAX_R[form] or r & (r - 1)
            or d1 <= 0 or d1 % 8 or n <= 0 or b <= 0 or n % r
            or n >= 1 << 31):
        return None
    boxes = -(-d1 // COMPACT_BOX_COLS)
    if boxes > _COMPACT_MAX_BOXES:
        return None
    n_tiles = -(-n // COMPACT_TILE_ROWS)
    q_tiles = -(-b // COMPACT_TILE_Q)
    cluster = 2 if q_tiles >= 2 else 1
    q_groups = -(-q_tiles // cluster)
    least = max(1, r // COMPACT_TILE_ROWS)
    run_tiles = _COMPACT_RUN_BLOCKS * r // COMPACT_TILE_ROWS
    if form == "qmajor":
        run_tiles = min(range(least, run_tiles + 1, least), key=lambda rt: (
            busiest_cluster_tiles(n_tiles, rt, q_groups, sms // cluster),
            -rt))
    else:
        while (run_tiles > least
               and -(-n_tiles // run_tiles) * q_groups * cluster < sms):
            run_tiles //= 2
    for stages in range(_COMPACT_MAX_STAGES, 1, -1):
        smem = sweep_smem_bytes(form, d1, r, stages, run_tiles)
        if smem <= MAX_SHARED_MEMORY:
            runs = -(-n_tiles // run_tiles)
            return CompactPlan(4 * boxes, stages, cluster, run_tiles, runs,
                               q_tiles, runs * q_groups, smem)
    return None


def busiest_cluster_tiles(n_tiles: int, run_tiles: int, q_groups: int,
                          clusters: int) -> int:
    """Row tiles the busiest cluster of the persistent grid walks: runs of
    ``run_tiles`` (the last one short) x ``q_groups`` work units, unit u
    on cluster u % G of G = min(units, ``clusters``) (:func:`compact_unit`
    orders them)."""
    runs = -(-n_tiles // run_tiles)
    tiles = np.minimum(run_tiles, n_tiles - np.arange(runs) * run_tiles)
    per_unit = np.repeat(tiles, q_groups)
    grid = max(1, min(per_unit.size, clusters))
    return int(np.bincount(np.arange(per_unit.size) % grid,
                           weights=per_unit).max())


def compact_unit(plan: CompactPlan, u: int) -> Tuple[int, int]:
    """(run, first query tile) of work unit ``u``: by run, the group of
    ``plan.cluster`` query tiles fastest, so the clusters of the persistent
    grid (cluster c takes units c, c + clusters, ...) read a run at about
    the same time; CTA k of the cluster takes query tile first + k."""
    q_groups = -(-plan.q_tiles // plan.cluster)
    return u // q_groups, u % q_groups * plan.cluster


def block_min_compact_query_image(q_aug: torch.Tensor) -> torch.Tensor:
    """The A fragments of ``block_min_compact.cu``, flat uint8: per tile of
    128 queries, per warpgroup (64 queries), per k16 step (4 a 64-column
    box), 16 bytes for each of the warpgroup's 128 threads. Thread (warp w,
    lane 4g + t) holds in register i the bf16 pair of query 16w + g + 8 *
    (i & 1) at dimensions 16 ks + 2t + 8 * (i >> 1) + {0, 1}, the low half
    first. Zero past B and D1. The kernel loads these registers straight
    from the [B, D1] queries at each work unit; this image is the model of
    those loads that the CPU tests hold against wgmma's fragment map."""
    b, d1 = q_aug.shape
    nks = 4 * -(-d1 // COMPACT_BOX_COLS)
    qt = -(-b // COMPACT_TILE_Q)
    q = torch.nn.functional.pad(q_aug.to(torch.bfloat16),
                                (0, nks * 16 - d1, 0, qt * COMPACT_TILE_Q - b))
    # [qt, wg, w, h, g, ks, kh, t, e] -> [qt, wg, ks, w, g, t, kh, h, e]
    img = q.view(qt, COMPACT_TILE_Q // 64, 4, 2, 8, nks, 2, 4, 2).permute(
        0, 1, 5, 2, 4, 7, 6, 3, 8)
    return img.contiguous().view(torch.uint8).reshape(-1)


def _compact_kernel_fn():
    global _compact_fn
    if _compact_fn is None:
        from scann_tpu_torch import native

        fn = native.load("block_min_compact").block_min_compact
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, i32, i32, i32,
                       i32, i32, i32, i32, vp, vp, vp]
        fn.restype = ctypes.c_int
        _compact_fn = fn
    return _compact_fn


def _launch(name: str, q_aug, db_aug, r: int, penalty, *, qmajor: bool,
            compact: bool, top2: bool, mma_sync: bool = False):
    """Checks the arguments, allocates the outputs and launches the
    kernel on the current stream of the tensors' device: a call that
    :func:`sweep_plan` accepts for its form goes to
    ``block_min_compact.cu`` unless ``mma_sync`` (the old kernel, kept as a
    same-run yardstick), every other call to ``block_min_sweep.cu``."""
    device = q_aug.device
    for label, t in (("db_aug", db_aug), ("penalty", penalty)):
        if t is not None and t.device != device:
            raise ValueError(f"{label} is on {t.device}, q_aug on {device}")
    if q_aug.dtype != torch.bfloat16:
        raise ValueError(f"q_aug must be bfloat16, got {q_aug.dtype}")
    if db_aug.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"db_aug must be bfloat16 or int8, got "
                         f"{db_aug.dtype}")
    if q_aug.dim() != 2 or db_aug.dim() != 2:
        raise ValueError("q_aug and db_aug must be 2-D")
    n, d1 = db_aug.shape
    b = q_aug.shape[0]
    if q_aug.shape[1] != d1 or d1 % 8:
        raise ValueError(f"row width {d1} must equal the query width "
                         f"{q_aug.shape[1]} and be a multiple of 8")
    if r < 1 or r & (r - 1) or r > _MAX_R or (top2 and r < 2):
        raise ValueError(f"the CUDA kernel takes block_r a power of two in "
                         f"[{2 if top2 else 1}, {_MAX_R}], got {r}")
    if n % r:
        raise ValueError(f"{n} rows are not a multiple of block_r={r}")
    if compact and r > 256:
        raise ValueError(f"compact q-major minima need r <= 256, got {r}")
    if penalty is not None:
        if penalty.dtype != torch.bfloat16 or \
                tuple(penalty.shape) != (n // r, r):
            raise ValueError(f"penalty must be [{n // r}, {r}] bfloat16, got "
                             f"{tuple(penalty.shape)} {penalty.dtype}")
    smem = kernel_smem_bytes(d1, db_aug.dtype == torch.int8, top2)
    if smem > MAX_SHARED_MEMORY:
        raise ValueError(f"row width {d1} needs {smem} bytes of shared "
                         f"memory, more than the {MAX_SHARED_MEMORY} a block "
                         f"has")
    if n >= 1 << 31:
        raise ValueError(f"the CUDA kernel takes fewer than 2**31 rows, got "
                         f"{n}")
    # cp.async copies 16-byte chunks: a row slab must start 16-byte aligned
    db_aug = db_aug.contiguous()
    if db_aug.data_ptr() % 16:
        db_aug = db_aug.clone()
    q_aug = q_aug.contiguous()
    penalty = None if penalty is None else penalty.contiguous()
    form = ("top2" if top2 else "compact" if compact
            else "qmajor" if qmajor else "rowmajor")
    plan = (None if mma_sync else
            sweep_plan(form, n, b, d1, r, db_aug.dtype == torch.int8,
                       torch.cuda.get_device_properties(
                           device).multi_processor_count))
    nb = n // r
    if plan is not None and form == "top2" and n % COMPACT_TILE_ROWS:
        # the top-2 form reads rows through a view of whole 128-row tiles:
        # a copy padded with zero rows (the searcher's rows are whole
        # tiles), whose blocks past N / r are cut from the outputs
        pad = COMPACT_TILE_ROWS - n % COMPACT_TILE_ROWS
        db_aug = torch.cat([db_aug, db_aug.new_zeros(pad, d1)])
        if penalty is not None:
            penalty = torch.cat([penalty.reshape(-1),
                                 penalty.new_zeros(pad)]).view(-1, r)
        n += pad
    shape = (b, n // r) if qmajor else (n // r, b)
    v_dtype, l_dtype = ((torch.bfloat16, torch.uint8) if compact
                        else (torch.float32, torch.int32))
    v1 = torch.empty(shape, dtype=v_dtype, device=device)
    l1 = torch.empty(shape, dtype=l_dtype, device=device)
    v2 = torch.empty(shape, dtype=v_dtype, device=device) if top2 else None
    l2 = torch.empty(shape, dtype=l_dtype, device=device) if top2 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if plan is not None:
            kernel = "block_min_compact"
            err = _compact_kernel_fn()(
                db_aug.data_ptr(), q_aug.data_ptr(), ptr(penalty),
                v1.data_ptr(), l1.data_ptr(), n, b, d1, r, plan.stages,
                plan.run_tiles, plan.cluster, SWEEP_FORMS.index(form),
                ptr(v2), ptr(l2), stream)
        else:
            kernel = "block_min_sweep"
            err = _kernel_fn()(
                db_aug.data_ptr(), q_aug.data_ptr(), ptr(penalty),
                v1.data_ptr(), l1.data_ptr(), ptr(v2), ptr(l2), n, b, d1, r,
                int(db_aug.dtype == torch.int8), int(top2), int(qmajor),
                int(compact), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    LAUNCHES_BY_KERNEL[name][kernel] += 1
    return (v1[:nb], l1[:nb], v2[:nb], l2[:nb]) if top2 else (v1, l1)


def block_min_sweep(q_aug: torch.Tensor, db_aug: torch.Tensor, *,
                    r: int = 32, penalty: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-major block minima: (vals [N/r, B] float32, locs [N/r, B] int32
    offsets within each contiguous r-row block). ``penalty``: optional
    [N/r, r] bf16 allowlist penalty added before the reduction
    (:func:`build_allow_penalty`)."""
    if not on_card(q_aug, "block_min_sweep"):
        return block_min_sweep_reference(q_aug, db_aug, r=r, penalty=penalty)
    return _launch("block_min", q_aug, db_aug, r, penalty, qmajor=False,
                   compact=False, top2=False)


def block_min_sweep_qmajor(q_aug: torch.Tensor, db_aug: torch.Tensor, *,
                           r: int = 32, compact: bool = False,
                           penalty: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-major block minima: (vals [B, N/r], locs [B, N/r]), float32 +
    int32, or bf16 + uint8 with ``compact=True`` (needs r <= 256)."""
    if not on_card(q_aug, "block_min_sweep_qmajor"):
        return block_min_sweep_qmajor_reference(q_aug, db_aug, r=r,
                                                compact=compact,
                                                penalty=penalty)
    name = "block_min_qmajor_compact" if compact else "block_min_qmajor"
    return _launch(name, q_aug, db_aug, r, penalty, qmajor=True,
                   compact=compact, top2=False)


def block_min2_sweep(q_aug: torch.Tensor, db_aug: torch.Tensor, *,
                     r: int = 32, penalty: Optional[torch.Tensor] = None):
    """The two smallest per block by tournament: (v1, l1, v2, l2), each
    [N/r, B] (float32 values, int32 offsets)."""
    if not on_card(q_aug, "block_min2_sweep"):
        return block_min2_sweep_reference(q_aug, db_aug, r=r,
                                          penalty=penalty)
    return _launch("block_min2", q_aug, db_aug, r, penalty, qmajor=False,
                   compact=False, top2=True)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def block_minima(q_aug: torch.Tensor, db_aug: torch.Tensor, *, r: int,
                 penalty: Optional[torch.Tensor] = None, top2: bool = False):
    """The sweep, by the JAX package's dispatch rule: ``(form, outputs)``
    with form "top2" (tournament), "qmajor" (q-major, compact when
    r <= 256) or "rowmajor"."""
    if top2:
        return "top2", block_min2_sweep(q_aug, db_aug, r=r, penalty=penalty)
    b_pad = align_up(q_aug.shape[0], _BATCH_ALIGN)
    if q_aug.device.type != "cpu" and qmajor_supported(db_aug.shape[0],
                                                       b_pad, r):
        return "qmajor", block_min_sweep_qmajor(
            q_aug, db_aug, r=r, compact=r <= 256, penalty=penalty)
    return "rowmajor", block_min_sweep(q_aug, db_aug, r=r, penalty=penalty)


def candidates_from_minima(form: str, outs, *, pre_k: int, r: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-pre_k blocks of each query -> (pv [B, pre_k] float32 raw sweep
    scores, cand [B, pre_k] int64 stored row positions ``blk*r + loc``);
    [B, 2*pre_k] for the tournament. The selection is exact (the JAX
    package's CPU backend is exact too)."""
    if form == "top2":
        v1, l1, v2, l2 = outs
        pv1, blk = approx_top_k_smallest(v1.T, pre_k)
        loc1 = torch.gather(l1.T, 1, blk)
        pv2 = torch.gather(v2.T, 1, blk)
        loc2 = torch.gather(l2.T, 1, blk)
        return (torch.cat([pv1, pv2], dim=1),
                torch.cat([blk * r + loc1, blk * r + loc2], dim=1))
    vals, locs = outs
    if form == "rowmajor":
        vals, locs = vals.T, locs.T
    pv, blk = approx_top_k_smallest(vals, pre_k)
    local = torch.gather(locs, 1, blk).long()
    return pv.float(), blk * r + local


def sweep_block_candidates(q_aug: torch.Tensor, db_aug: torch.Tensor, *,
                           pre_k: int, r: int,
                           penalty: Optional[torch.Tensor] = None,
                           top2: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-min sweep -> (pv, cand); see :func:`block_minima` and
    :func:`candidates_from_minima`."""
    form, outs = block_minima(q_aug, db_aug, r=r, penalty=penalty, top2=top2)
    return candidates_from_minima(form, outs, pre_k=pre_k, r=r)


def sweep_approx_in_measure_units(pv: torch.Tensor, queries: torch.Tensor,
                                  measure: DistanceMeasure) -> torch.Tensor:
    """Sweep scores -> the measure's own units (for pre_eps compares):
    L2 adds ||q||^2 (pv = ||x||^2 - 2 q.x), cosine adds 1 (pv = -cos)."""
    if measure == DistanceMeasure.SQUARED_L2:
        q_sq = torch.sum(queries.float() ** 2, dim=1)
        return pv + q_sq[:, None]
    if measure == DistanceMeasure.COSINE:
        return 1.0 + pv
    return pv


def augment_for_sweep(queries: torch.Tensor, db_aug: torch.Tensor,
                      measure: DistanceMeasure,
                      aug_scales: Optional[torch.Tensor] = None,
                      aug_sn: float = 0.0) -> Tuple[torch.Tensor, float]:
    """(q_aug [B, D1] bf16, validity cut on the raw sweep scores) for the
    bf16 layout or, for int8 rows, the int8 layout."""
    d1 = db_aug.shape[1]
    if db_aug.dtype == torch.int8:
        return (_augment_queries_int8(queries, measure, aug_scales, aug_sn,
                                      d1), int8_mask_cut(aug_sn))
    return _augment_queries(queries, measure, d1), BLOCK_MASK_VALUE / 2


def rerank_candidates(db: torch.Tensor, queries: torch.Tensor,
                      pv: torch.Tensor, cand: torch.Tensor,
                      measure: DistanceMeasure, pre_eps: float,
                      mask_cut: float) -> torch.Tensor:
    """[B, C] exact float32 distances of the candidates, MASKED_DISTANCE
    where the sweep score marks a padded or denied row or fails pre_eps."""
    approx = sweep_approx_in_measure_units(pv, queries, measure)
    pre_valid = (pv < mask_cut) & (approx <= pre_eps)
    safe = cand.clamp(0, rerank_store_rows(db) - 1)
    rows = gather_rerank_rows(db, safe)                       # [B, C, D]
    norms = torch.sum(rows * rows, dim=-1)
    exact = gathered_distances(measure, queries, rows, norms)
    return torch.where(pre_valid, exact, float(MASKED_DISTANCE))


def finalize_results(exact: torch.Tensor, cand: torch.Tensor, k: int,
                     post_eps: float,
                     inv_perm: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the re-ranked candidates -> (distances [B, k], inf where
    missing; ids [B, k] int64, -1 where missing). Stored positions turn into
    point ids through ``inv_perm`` for the k winners only."""
    out_vals, pos = top_k_smallest(exact, k)
    idx = torch.gather(cand, 1, pos)
    if inv_perm is not None:
        idx = inv_perm[idx.clamp(0, inv_perm.shape[0] - 1)]
    missing = (out_vals >= MASKED_DISTANCE / 2) | (out_vals > post_eps)
    return (torch.where(missing, float("inf"), out_vals),
            torch.where(missing, -1, idx))


def sweep_search(db_aug: torch.Tensor, db: torch.Tensor,
                 queries: torch.Tensor, pre_eps: float = float("inf"),
                 post_eps: float = float("inf"),
                 inv_perm: Optional[torch.Tensor] = None,
                 aug_scales: Optional[torch.Tensor] = None,
                 allow_pen: Optional[torch.Tensor] = None, *, pre_k: int,
                 k: int, measure: DistanceMeasure, r: int = 32,
                 top2: bool = False, aug_sn: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full pipeline for one batch, on the tensors' device: augment the
    queries -> block-min sweep -> top-pre_k over the block minima ->
    ``blk*r + loc`` -> gather the float32 re-rank rows -> exact distances ->
    top-k -> ``inv_perm`` on the k winners -> epsilons and the missing mask.
    Returns (distances [B, k], ids [B, k]).

    ``db_aug`` is the bf16 layout (:func:`build_augmented_db`) or the int8
    layout (:func:`build_int8_augmented_db`; pass ``aug_scales`` and
    ``aug_sn``). ``db`` is the float32 re-rank store in the same stored
    order. ``allow_pen`` (:func:`build_allow_penalty`) fuses a restrict
    allowlist into the pre-reduction scores. The JAX package's
    ``db_sq_norms`` and ``n_valid`` arguments are dropped: its kernel
    recomputes the norms from the gathered rows and never reads
    ``n_valid``."""
    q_aug, mask_cut = augment_for_sweep(queries, db_aug, measure, aug_scales,
                                        aug_sn)
    pv, cand = sweep_block_candidates(q_aug, db_aug, pre_k=pre_k, r=r,
                                      penalty=allow_pen, top2=top2)
    exact = rerank_candidates(db, queries, pv, cand, measure, pre_eps,
                              mask_cut)
    return finalize_results(exact, cand, k, post_eps, inv_perm)
