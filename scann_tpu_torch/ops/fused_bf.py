"""Exact small-database search in one kernel (counterpart of
``scann_tpu/ops/fused_bf_pallas.py``).

:func:`fused_bf_search` computes exact squared-L2 distances and the k <= 16
smallest per query in one CUDA launch (``csrc/fused_bf.cu``), in place of the
composed product, mask and top-k, whose many small launches dominate at the
sizes the brute-force searcher sends here (the JAX package's headline
10,000 x 64 at B = 100). :func:`fused_bf_search_reference` is that composed
path, the twin: CPU tensors take it, CUDA tensors launch the kernel or
raise. Each launch adds one to :data:`LAUNCHES`.

Both return ascending (value, column) pairs, equal values lowest column
first, and (inf, -1) for slots with no row below ``n_valid``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from scann_tpu_torch.ops.distances import (
    DistanceMeasure,
    many_to_many,
    mask_padded_rows,
)
from scann_tpu_torch.ops.topk import top_k_smallest
from scann_tpu_torch.types import MASKED_DISTANCE, cdiv, on_card

# Kernel launches since the last reset; only a launch of the CUDA kernel
# counts, never a call of the twin.
LAUNCHES = 0

MAX_K = 16
# the kernel's tiles (csrc/fused_bf.cu): queries per CTA, rows per sub-chunk
_Q_TILE, _ROWS = 32, 256
# CTAs to aim for per SM when the rows are split across CTAs
_CTAS_PER_SM = 2

_fn = None


def resident_limit_bytes() -> int:
    """Budget of the brute-force searcher's gate for this path: the JAX
    package's scoped-VMEM budget (16 MB less 2 MB of slack), kept so the
    same workloads take the fused kernel as on the TPU. The card has no such
    limit; whether the gate should move is an open question (ROADMAP.md)."""
    return 14 * 1024 * 1024


def _check_args(queries, db, db_sq_norms, n_valid: int, k: int):
    if queries.dim() != 2 or db.dim() != 2 or db_sq_norms.dim() != 1:
        raise ValueError("queries must be [B, D], db [N, D] and db_sq_norms "
                         "[N]")
    for name, t in (("queries", queries), ("db", db),
                    ("db_sq_norms", db_sq_norms)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if queries.shape[1] != db.shape[1]:
        raise ValueError(f"queries have D={queries.shape[1]}, db "
                         f"{db.shape[1]}")
    if db_sq_norms.shape[0] != db.shape[0]:
        raise ValueError(f"{db_sq_norms.shape[0]} norms for {db.shape[0]} "
                         f"rows")
    if not 0 <= n_valid <= db.shape[0]:
        raise ValueError(f"n_valid={n_valid} outside [0, {db.shape[0]}]")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


def fused_bf_search_reference(queries: torch.Tensor, db: torch.Tensor,
                              db_sq_norms: torch.Tensor, n_valid: int,
                              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of the kernel: the composed float32 squared-L2 matrix, columns
    >= ``n_valid`` masked, the tie-free top-k. (values [B, k] float32,
    columns [B, k] int32), (inf, -1) where missing. Works on any device and
    for any k."""
    dists = many_to_many(DistanceMeasure.SQUARED_L2, queries, db,
                         db_sq_norms)
    dists = mask_padded_rows(dists, n_valid, MASKED_DISTANCE)
    if k > dists.shape[1]:
        dists = torch.nn.functional.pad(dists, (0, k - dists.shape[1]),
                                        value=float(MASKED_DISTANCE))
    vals, idx = top_k_smallest(dists, k)
    missing = vals >= MASKED_DISTANCE / 2
    return (torch.where(missing, float("inf"), vals),
            torch.where(missing, -1, idx).int())


def _kernel_fn():
    global _fn
    if _fn is None:
        from scann_tpu_torch import native

        fn = native.load("fused_bf").fused_bf_search
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp] + [i32] * 7 + [vp] * 5
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def split_plan(b: int, n: int, sms: int) -> Tuple[int, int]:
    """(sub-chunks per CTA, CTAs along the rows) of a launch: enough splits
    of the rows for ``_CTAS_PER_SM`` CTAs per SM over all query tiles, no
    more than there are 256-row sub-chunks."""
    chunks = cdiv(n, _ROWS)
    want = max(1, min(chunks, cdiv(_CTAS_PER_SM * sms, cdiv(b, _Q_TILE))))
    per_split = cdiv(chunks, want)
    return per_split, cdiv(chunks, per_split)


def fused_bf_search(queries: torch.Tensor, db: torch.Tensor,
                    db_sq_norms: torch.Tensor, n_valid: int, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k] float32 ascending, columns [B, k] int32) of exact
    squared-L2 search over ``db`` [N, D] with squared norms ``db_sq_norms``
    [N]; rows >= ``n_valid`` never surface; 1 <= k <= 16.

    CPU tensors go to :func:`fused_bf_search_reference`; CUDA tensors to
    the CUDA kernel, built from ``csrc/fused_bf.cu`` at first use, or
    raise."""
    global LAUNCHES
    if not on_card(queries, "fused_bf_search"):
        return fused_bf_search_reference(queries, db, db_sq_norms, n_valid,
                                         k)
    _check_args(queries, db, db_sq_norms, n_valid, k)
    for name, t in (("db", db), ("db_sq_norms", db_sq_norms)):
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{queries.device}")
    b, d = queries.shape
    n = db.shape[0]
    device = queries.device
    if b == 0 or n == 0:
        return (torch.full((b, k), float("inf"), device=device),
                torch.full((b, k), -1, dtype=torch.int32, device=device))
    if d == 0:
        raise ValueError("queries and db have no columns")
    # the kernel writes every slot
    vals = torch.empty(b, k, device=device)
    idx = torch.empty(b, k, dtype=torch.int32, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_split, n_splits = split_plan(b, n, sms)
    part = counters = None
    if n_splits > 1:
        # each split's k best per query as 64-bit (value bits, column) keys
        part = torch.empty(b * n_splits * k, dtype=torch.int64, device=device)
        counters = torch.zeros(cdiv(b, _Q_TILE), dtype=torch.int32,
                               device=device)
    q = queries.contiguous()
    rows = db.contiguous()
    norms = db_sq_norms.contiguous()
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q.data_ptr(), rows.data_ptr(), norms.data_ptr(),
                 int(n_valid), b, d, n, k, per_split, n_splits,
                 None if part is None else part.data_ptr(),
                 None if counters is None else counters.data_ptr(),
                 vals.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_bf_search kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return vals, idx


def check_against_twin(queries: torch.Tensor, db: torch.Tensor,
                       db_sq_norms: torch.Tensor, n_valid: int, k: int,
                       got_vals: torch.Tensor, got_idx: torch.Tensor,
                       rtol: float = 1e-5) -> Dict[str, float]:
    """Holds a kernel result against the twin on the same inputs; raises
    ``AssertionError`` where they disagree.

    The two add in other orders, so the tolerance is relative to the terms
    the formula cancels: |value - twin value| <= rtol * (|q|^2 + the
    largest |x|^2 of the twin's rows) per query. Missing slots (inf, -1)
    must match exactly; ids must equal the twin's at every slot whose twin
    value lies more than that tolerance from its neighbours (the (k+1)-th
    twin value included). Returns the largest absolute and relative value
    differences and the count of slots whose ids were compared."""
    kk = min(k + 1, db.shape[0])
    want_v, want_i = fused_bf_search_reference(queries, db, db_sq_norms,
                                               n_valid, max(kk, k))
    got_v, got_i = got_vals.float(), got_idx.long()
    missing = want_i[:, :k] < 0
    if not torch.equal(missing, got_i < 0) or not torch.equal(
            missing, torch.isinf(got_v)):
        raise AssertionError("kernel and twin disagree on missing slots")
    q_sq = (queries.float() ** 2).sum(1)
    rows_sq = db_sq_norms[want_i[:, :k].clamp_min(0).long()]
    scale = q_sq + torch.where(missing, 0.0, rows_sq).amax(1)
    tol = rtol * scale[:, None]
    wv = want_v[:, :k]
    diff = torch.where(missing, 0.0, (got_v - wv).abs())
    if bool((diff > tol).any()):
        raise AssertionError(f"values differ by up to {float(diff.max())}, "
                             f"past {rtol} of the terms")
    ext = torch.cat([torch.full_like(want_v[:, :1], -float("inf")), want_v],
                    dim=1)
    if ext.shape[1] < k + 2:
        ext = torch.cat([ext, torch.full_like(ext[:, :1], float("inf"))], 1)
    gap = torch.minimum(ext[:, 1:k + 1] - ext[:, :k],
                        ext[:, 2:k + 2] - ext[:, 1:k + 1])
    strict = (gap > tol) & ~missing
    if not torch.equal(got_i[strict], want_i[:, :k].long()[strict]):
        raise AssertionError("kernel and twin ids differ away from ties")
    rel = diff / wv.abs().clamp_min(1e-30)
    return {"max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "max_rel_err": float(torch.where(missing, 0.0, rel).max())
            if rel.numel() else 0.0,
            "ids_compared": int(strict.sum())}
