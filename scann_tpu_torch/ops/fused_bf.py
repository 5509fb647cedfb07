"""Exact small-database search in one kernel (counterpart of
``scann_tpu/ops/fused_bf_pallas.py``).

:func:`fused_bf_search` computes exact squared-L2 distances and the k <= 16
smallest per query in one CUDA launch (``csrc/fused_bf.cu``), in place of the
composed product, mask and top-k, whose many small launches dominate at the
sizes the brute-force searcher sends here (the JAX package's headline
10,000 x 64 at B = 100). :func:`fused_bf_search_reference` is that composed
path, the twin: CPU tensors take it, CUDA tensors launch the kernel or
raise.

CUDA tensors go to the cluster kernel: a thread-block cluster a tile of
queries, its CTAs splitting the rows and merging their lists in the
cluster's shared memory, laid out by :func:`cluster_plan`. The first
port's kernel (row splits merged through global scratch by the last CTA)
stays as a yardstick, reached only through ``_launch(scratch_merge=True)``.
Each launch adds one to :data:`LAUNCHES` and to its kernel's entry in
:data:`LAUNCHES_BY_KERNEL`.

Both return ascending (value, column) pairs, equal values lowest column
first, and (inf, -1) for slots with no row below ``n_valid``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from scann_tpu_torch.ops.distances import (
    DistanceMeasure,
    many_to_many,
    mask_padded_rows,
)
from scann_tpu_torch.ops.topk import top_k_smallest
from scann_tpu_torch.types import MASKED_DISTANCE, cdiv, on_card

# Kernel launches since the last reset; only a launch of a CUDA kernel
# counts, never a call of the twin.
LAUNCHES = 0
# the same by kernel: "cluster" serves fused_bf_search, "scratch_merge" is
# the first port's kernel (a yardstick)
LAUNCHES_BY_KERNEL: Dict[str, int] = {"cluster": 0, "scratch_merge": 0}

MAX_K = 16
# the first port's tiles: queries per CTA, rows per sub-chunk
_Q_TILE, _ROWS = 32, 256
# CTAs to aim for per SM when the rows are split across CTAs
_CTAS_PER_SM = 2

# the cluster kernel (csrc/fused_bf.cu): query tiles it is built for, the
# widest cluster (16 is past the portable 8), distances a sub-chunk (256
# threads x 4 rows x 8 queries), and the widest ring stage (d) of each tile
# that fits the 227 KB of shared memory (Tile<QT>::kMaxDk)
Q_TILES = (16, 32)
MAX_CLUSTER = 16
TILE_OUT = 8192
MAX_SLAB = {16: 40, 32: 80}
# the plan's cost model (seconds), from the kernel's phase times on an H100
# 80GB HBM3 at 700 W (clock64 stamps of instrumented builds, PERF.md):
# float32 FMAs an SM retires a second in the product loop by query tile
# (0.22 and 0.34 of the 128 lanes at 1.98 GHz), bytes an SM
# takes from L2 a second (64 a clock) and the card's L2 a second; one
# query's selection on a sub-chunk, the first sub-chunk's extra (lists
# still empty), a CTA's fixed work (the launch, the first slab's latency,
# |q|^2, the stores); a cluster merge's barriers and peer reads, and one
# step of its ranking loop
FMA_PER_SM_S = {16: 0.55e11, 32: 0.85e11}
SM_BYTES_S = 64 * 1.98e9
L2_BYTES_S = 5.5e12
SELECT_S, FIRST_SELECT_S, CTA_S = 0.6e-6, 2.0e-6, 3.0e-6
MERGE_S, RANK_S = 4.0e-6, 2e-9

_cluster_fns = None
_capacity: Dict[Tuple[int, int, int, int], int] = {}
_sms: Dict[int, int] = {}


class ClusterPlan(NamedTuple):
    """Launch of the cluster kernel: clusters of ``cluster`` CTAs, one a
    tile of ``q_tile`` queries; CTA r of a cluster takes rows
    [r * rows_per_cta, min(n_valid, (r + 1) * rows_per_cta))."""
    q_tile: int
    cluster: int
    rows_per_cta: int


def sub_chunk_rows(q_tile: int) -> int:
    """Rows a CTA of the cluster kernel takes per sub-chunk."""
    return TILE_OUT // q_tile


def slab_width(q_tile: int, d: int) -> int:
    """d a ring stage holds: all of D (rounded up to 8, so that staged rows
    lie dk + 4 floats apart and eight neighbouring rows' 16-byte loads hit
    eight bank groups) where it fits, else the widest stage that does."""
    return min(cdiv(d, 8) * 8, MAX_SLAB[q_tile])


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


def _kernel_fns():
    """(the cluster kernel's entry, its capacity query, the first port's
    entry), from ``csrc/fused_bf.cu``, built at first use."""
    global _cluster_fns
    if _cluster_fns is None:
        from scann_tpu_torch import native

        lib = native.load("fused_bf")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        search = lib.fused_bf_cluster_search
        search.argtypes = [vp, vp, vp] + [i32] * 8 + [vp] * 3
        search.restype = i32
        cap = lib.fused_bf_cluster_capacity
        cap.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
        cap.restype = i32
        old = lib.fused_bf_search
        old.argtypes = [vp, vp, vp] + [i32] * 7 + [vp] * 5
        old.restype = i32
        _cluster_fns = (search, cap, old)
    return _cluster_fns


def split_plan(b: int, n: int, sms: int) -> Tuple[int, int]:
    """(sub-chunks per CTA, CTAs along the rows) of a launch of the first
    port's kernel: enough splits of the rows for ``_CTAS_PER_SM`` CTAs per
    SM over all query tiles, no more than there are 256-row sub-chunks."""
    chunks = cdiv(n, _ROWS)
    want = max(1, min(chunks, cdiv(_CTAS_PER_SM * sms, cdiv(b, _Q_TILE))))
    per_split = cdiv(chunks, want)
    return per_split, cdiv(chunks, per_split)


def plan_cost(plan: ClusterPlan, b: int, n_valid: int, d: int, k: int,
              sms: int, capacity: Callable[[int, int, int], int]) -> float:
    """Seconds the cost model gives a plan: each CTA's products (the rows
    of its range, a short last sub-chunk rounded up to a row group, D
    padded to 4; or its rows and queries from L2, whichever is longer), its
    selections and its fixed work, over the CTAs the card runs at once; at
    least the bytes of every query tile's pass over the rows at the card's
    L2 rate; plus the cluster merge."""
    r = sub_chunk_rows(plan.q_tile)
    lanes = r // 4                      # rows of a row group
    tiles = cdiv(b, plan.q_tile)
    rows = min(plan.rows_per_cta, max(1, n_valid))
    subs = cdiv(rows, r)
    computed = rows // r * r + cdiv(rows % r, lanes) * lanes
    ctas = tiles * plan.cluster
    slots = min(sms, plan.cluster * capacity(
        plan.q_tile, plan.cluster, slab_width(plan.q_tile, d)))
    fma = (computed * plan.q_tile * cdiv(d, 4) * 4
           / FMA_PER_SM_S[plan.q_tile])
    moved = (rows + subs * plan.q_tile) * d * 4
    per_cta = (max(fma, moved / SM_BYTES_S) + FIRST_SELECT_S
               + subs * plan.q_tile // 8 * SELECT_S + CTA_S)
    t = cdiv(ctas, slots) * per_cta
    l2 = ctas * moved / L2_BYTES_S
    merge = 0.0
    if plan.cluster > 1:
        n = plan.cluster * k
        merge = MERGE_S + cdiv(cdiv(plan.q_tile, plan.cluster) * n,
                               256) * n * RANK_S
    return max(t, l2) + merge


def cluster_plan(b: int, n_valid: int, d: int, k: int, sms: int,
                 capacity: Callable[[int, int, int], int]) -> ClusterPlan:
    """The plan of least :func:`plan_cost` over the query tiles 16 and 32
    and the cluster widths 1 .. 16 that fit on the card
    (``capacity(q_tile, cluster, dk)``: clusters resident at once with
    ``dk``-wide stages, 0 where one does not fit), ties to the narrower
    cluster, then the wider query tile. The rows [0, n_valid) split into
    ``cluster`` ranges of ``rows_per_cta`` (the last one shorter, none
    empty); every row is covered once. A pure function of its arguments."""
    if b < 1 or n_valid < 0 or d < 1 or sms < 1:
        raise ValueError(f"no plan for B={b}, n_valid={n_valid}, D={d}, "
                         f"{sms} SMs")
    best, best_key = None, None
    for q_tile in Q_TILES:
        if cdiv(b, q_tile) > 65535:     # the grid's y extent
            continue
        for cluster in range(1, MAX_CLUSTER + 1):
            plan = ClusterPlan(q_tile, cluster,
                               max(1, cdiv(n_valid, cluster)))
            if plan.rows_per_cta * (cluster - 1) >= max(1, n_valid):
                continue                # a CTA would get no rows
            if capacity(q_tile, cluster, slab_width(q_tile, d)) < 1:
                continue
            key = (plan_cost(plan, b, n_valid, d, k, sms, capacity),
                   cluster, -q_tile)
            if best_key is None or key < best_key:
                best, best_key = plan, key
    if best is None:
        raise ValueError(f"no cluster of the fused kernel fits for B={b}")
    return best


def _capacity_fn(device: torch.device
                 ) -> Callable[[int, int, int], int]:
    """``capacity(q_tile, cluster, dk)`` of the card, each queried once per
    device (``cudaOccupancyMaxActiveClusters``)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    _, cap_fn, _ = _kernel_fns()

    def capacity(q_tile: int, cluster: int, dk: int) -> int:
        key = (index, q_tile, cluster, dk)
        if key not in _capacity:
            out = ctypes.c_int(0)
            with torch.cuda.device(index):
                err = cap_fn(q_tile, cluster, dk, ctypes.byref(out))
            if err != 0:
                raise RuntimeError(f"fused_bf capacity query failed: CUDA "
                                   f"error {err}")
            _capacity[key] = out.value
        return _capacity[key]
    return capacity


@functools.lru_cache(maxsize=512)
def _device_plan(index: int, b: int, n_valid: int, d: int,
                 k: int) -> ClusterPlan:
    """:func:`cluster_plan` for the card ``index``, once per shape."""
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return cluster_plan(b, n_valid, d, k, _sms[index],
                        _capacity_fn(torch.device("cuda", index)))


def _launch(queries: torch.Tensor, db: torch.Tensor,
            db_sq_norms: torch.Tensor, n_valid: int, k: int, *,
            scratch_merge: bool = False, plan: ClusterPlan = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Checks a card call, allocates the two outputs and launches the
    cluster kernel (with ``plan``, or the device's :func:`cluster_plan`),
    or with ``scratch_merge`` the first port's kernel (row splits merged by
    the last CTA through global scratch and an atomic counter; kept as a
    same-run yardstick, never reached by a search path)."""
    global LAUNCHES
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
    if plan is not None and (
            plan.q_tile not in Q_TILES
            or not 1 <= plan.cluster <= MAX_CLUSTER
            or plan.rows_per_cta < 1
            or plan.rows_per_cta * plan.cluster < n_valid):
        raise ValueError(f"{plan} does not cover {n_valid} rows with a "
                         f"built query tile and cluster width")
    # the kernels write every slot
    vals = torch.empty(b, k, device=device)
    idx = torch.empty(b, k, dtype=torch.int32, device=device)
    q = queries.contiguous()
    rows = db.contiguous()
    norms = db_sq_norms.contiguous()
    search, _, old = _kernel_fns()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if scratch_merge:
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
            per_split, n_splits = split_plan(b, n, sms)
            part = counters = None
            if n_splits > 1:
                # each split's k best per query as 64-bit (value bits,
                # column) keys; a counter per query tile
                part = torch.empty(b * n_splits * k, dtype=torch.int64,
                                   device=device)
                counters = torch.zeros(cdiv(b, _Q_TILE), dtype=torch.int32,
                                       device=device)
            err = old(q.data_ptr(), rows.data_ptr(), norms.data_ptr(),
                      int(n_valid), b, d, n, k, per_split, n_splits,
                      None if part is None else part.data_ptr(),
                      None if counters is None else counters.data_ptr(),
                      vals.data_ptr(), idx.data_ptr(), stream)
        else:
            if plan is None:
                plan = _device_plan(device.index if device.index is not None
                                    else torch.cuda.current_device(), b,
                                    int(n_valid), d, k)
            err = search(q.data_ptr(), rows.data_ptr(), norms.data_ptr(),
                         int(n_valid), b, d, k, plan.q_tile, plan.cluster,
                         plan.rows_per_cta, slab_width(plan.q_tile, d),
                         vals.data_ptr(), idx.data_ptr(), stream)
    kernel = "scratch_merge" if scratch_merge else "cluster"
    if err != 0:
        raise RuntimeError(f"fused_bf_search {kernel} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[kernel] += 1
    return vals, idx


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for key in LAUNCHES_BY_KERNEL:
        LAUNCHES_BY_KERNEL[key] = 0


def fused_bf_search(queries: torch.Tensor, db: torch.Tensor,
                    db_sq_norms: torch.Tensor, n_valid: int, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k] float32 ascending, columns [B, k] int32) of exact
    squared-L2 search over ``db`` [N, D] with squared norms ``db_sq_norms``
    [N]; rows >= ``n_valid`` never surface; 1 <= k <= 16.

    CPU tensors go to :func:`fused_bf_search_reference`; CUDA tensors to
    the cluster kernel, built from ``csrc/fused_bf.cu`` at first use, or
    raise."""
    if not on_card(queries, "fused_bf_search"):
        return fused_bf_search_reference(queries, db, db_sq_norms, n_valid,
                                         k)
    return _launch(queries, db, db_sq_norms, n_valid, k)


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
